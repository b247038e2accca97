"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense with multi-head latent
attention (MLA): q_lora 768, kv_lora 256, qk nope/rope 64/32, v 64.  A copy of
``src/repro/configs/minicpm3_4b.py``, field for field."""

import dataclasses

from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attn_type="mla",
    mla=MLAConfig(
        q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32,
        v_head_dim=64,
    ),
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
)
