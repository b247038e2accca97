"""Transformer stack for decoder-only dense and MoE models.

Counterpart of the JAX package's ``models/transformer.py``.  Block = norm ->
GQA attention -> residual -> norm -> FFN -> residual, where the FFN is the
MoE layer on the layers ``cfg.layer_is_moe(i)`` names and the dense SwiGLU
elsewhere (none where ``d_ff`` is 0).  The MoE load-balancing loss is
dropped: the stack serves, and the reference's prefill and decode drop it
too.  The JAX stack
scans over scan-stacked parameters; here the layers are a Python list (one
param dict per layer) run in a loop.  There is no mesh, so the sharding
constraints of the JAX stack have no counterpart.

KV cache layout, which the serving pool indexes: one dict
``{"k", "v": [n_layers, B, L, KV, D], "pos": [n_layers, B, L] int32}`` --
the layout of the JAX package's stacked caches for a period-1 pattern.
Layer ``i`` works on the views ``k[i]``, ``v[i]``, ``pos[i]``, so decode
writes into the stacked tensors in place.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from .layers import mlp_apply, mlp_init, rms_norm, zeros_init

__all__ = ["block_init", "block_apply", "stack_init", "stack_apply", "init_stack_cache"]

CACHE_KEYS = ("k", "v", "pos")


def block_init(gen: torch.Generator, cfg: ModelConfig, i: int, dtype=torch.float32) -> dict:
    """Parameters of layer ``i``."""
    d = cfg.d_model
    params = {
        "ln1": zeros_init(gen, (d,), dtype),
        "mixer": attn_mod.attention_init(gen, cfg, dtype),
    }
    if cfg.layer_is_moe(i):
        params["ln2"] = zeros_init(gen, (d,), dtype)
        params["ffn"] = moe_mod.moe_init(gen, cfg, dtype)
    elif cfg.d_ff:
        params["ln2"] = zeros_init(gen, (d,), dtype)
        params["ffn"] = mlp_init(gen, d, cfg.d_ff, dtype)
    return params


def block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, i: int, *, positions,
                cache: dict | None = None, update_cache: bool = False, ragged: bool = False):
    """Layer ``i``; returns (x, cache)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    out, new_cache = attn_mod.attention_apply(
        params["mixer"], h, cfg, positions=positions, cache=cache,
        update_cache=update_cache, ragged=ragged,
    )
    x = x + out
    if "ffn" in params:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        if cfg.layer_is_moe(i):
            x = x + moe_mod.moe_apply(params["ffn"], h, cfg)[0]
        else:
            x = x + mlp_apply(params["ffn"], h)
    return x, new_cache


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> list[dict]:
    return [block_init(gen, cfg, i, dtype) for i in range(cfg.n_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    one = attn_mod.init_attention_cache(cfg, batch, seq_len, dtype, device)
    return {
        name: t.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * t.dim())
        for name, t in one.items()
    }


def stack_apply(layers: list[dict], x: torch.Tensor, cfg: ModelConfig, *, positions,
                caches: dict | None = None, update_cache: bool = False, ragged: bool = False):
    """Returns (x, caches).  With ``caches`` (decode) each layer writes into
    its slice in place and the same dict comes back; with ``update_cache``
    (prefill) the new entries of every layer are stacked into a new dict."""
    emitted = []
    for i, layer in enumerate(layers):
        layer_cache = None if caches is None else {n: caches[n][i] for n in CACHE_KEYS}
        x, nc = block_apply(layer, x, cfg, i, positions=positions, cache=layer_cache,
                            update_cache=update_cache, ragged=ragged)
        if caches is None and update_cache:
            emitted.append(nc)
    if caches is not None:
        return x, caches
    if update_cache:
        return x, {n: torch.stack([c[n] for c in emitted]) for n in CACHE_KEYS}
    return x, None
