"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD (state-space duality),
state 128, 48 layers."""

import dataclasses

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attn_period=0,  # attention-free
    # the chunk of the plain SSD version; the CUDA kernel picks its own
    ssm=SSMConfig(state_dim=128, conv_width=4, expand=2, head_dim=64, chunk_size=512),
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    vocab=512,
    ssm=SSMConfig(state_dim=32, conv_width=4, expand=2, head_dim=32),
)
