"""IBM Granite 3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base]:
MoE with 32 experts top-8, per-expert FFN 512, GQA kv=8."""

import dataclasses

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,  # every FFN is MoE
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert_ff=512),
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64),
)
