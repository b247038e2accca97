"""InternLM2-1.8B [arXiv:2403.17297]: dense GQA kv=8."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512
)
