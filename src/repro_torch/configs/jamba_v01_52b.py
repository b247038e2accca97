"""Jamba v0.1 52B [arXiv:2403.19887]: hybrid Mamba/attention 1:7 interleave,
MoE 16 experts top-2 on every other layer.  Attention layers use GQA kv=8
and no RoPE (position information comes from the Mamba layers).  A copy of
``src/repro/configs/jamba_v01_52b.py:9-37``, field for field."""

import dataclasses

from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert_ff=14336, layer_period=2, layer_offset=1),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=64),
    attn_period=8,
    attn_offset=4,
    use_rope=False,
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=8,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert_ff=256, layer_period=2, layer_offset=1),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=32),
    attn_period=8,
    attn_offset=4,
)
