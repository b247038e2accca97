"""SeamlessM4T large v2 [arXiv:2308.11596]: encoder-decoder over audio
frames; the speech frontend is a stub providing precomputed frame
embeddings (assignment: backbone only).  A copy of
``src/repro/configs/seamless_m4t_large_v2.py``, field for field."""

import dataclasses

from .base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    enc_dec=True,
    n_encoder_layers=24,
    frontend=FrontendConfig(kind="audio", d_frontend=160, n_tokens=0),
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    n_encoder_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    frontend=FrontendConfig(kind="audio", d_frontend=32, n_tokens=0),
)
