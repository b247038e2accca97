"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts top-8, per-expert FFN 1024,
full multi-head attention (kv = heads), qk-norm."""

import dataclasses

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=50304,
    qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert_ff=1024),
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64),
)
