"""Qwen3-32B [hf:Qwen/Qwen3-8B family]: dense GQA kv=8 with qk-norm,
head_dim 128 (d_head != d_model / n_heads)."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512
)
