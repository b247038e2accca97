"""H2O-Danube 1.8B [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention (window 4096), GQA kv=8."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    attn_type="swa",
    sliding_window=4096,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    sliding_window=64,
)
