"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
text backbone + CLIP vision frontend (stub: precomputed patch embeddings
prepended to the sequence).  A copy of
``src/repro/configs/phi_3_vision_4_2b.py``, field for field."""

import dataclasses

from .base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    frontend=FrontendConfig(kind="vision", d_frontend=1024, n_tokens=576),
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    frontend=FrontendConfig(kind="vision", d_frontend=64, n_tokens=16),
)
