"""Transformer stack for decoder-only dense, MoE and attention-free SSM
models, and hybrids that interleave attention and SSM layers (jamba).

Counterpart of the JAX package's ``models/transformer.py``.  Block = norm ->
mixer -> residual -> norm -> FFN -> residual.  The mixer is GQA attention on
the layers ``cfg.layer_is_attention(i)`` names and the Mamba-2 SSM elsewhere
(``mixer_kind``); the FFN is the MoE layer on the layers
``cfg.layer_is_moe(i)`` names, the dense SwiGLU elsewhere, and none where
``d_ff`` is 0 (mamba2 is norm -> SSM mixer -> residual only).  Each MoE
layer's load-balancing loss comes back beside x, summed over the layers in
fp32 by ``stack_apply``, as the reference's stack returns it: training adds
it to the loss, prefill and decode ignore it.  The JAX stack scans over
scan-stacked parameters; here the layers are a Python list (one param dict
per layer) run in a loop.  There is no mesh, so the sharding constraints of the JAX
stack have no counterpart.  In training (grad mode on, no cache, no
``update_cache``) each block runs under ``torch.utils.checkpoint`` when
``cfg.remat`` is set, the counterpart of the JAX stack's ``jax.checkpoint``
over the scanned block: its activations are recomputed in the backward
pass, so attention's forward, the MoE layer's three grouped matmuls and
the SSD scan's forward run twice a layer per step.  The recompute routes exactly as the forward did:
routing depends only on the block's inputs.

Cache layout, which the serving pool indexes: one flat dict whose every
leaf has batch on dim 1, each kind stacked over the layers of that kind
only -- ``{"k", "v": [n_attn, B, L, KV, D], "pos": [n_attn, B, L] int32}``
for the attention layers, ``{"conv_x", "conv_b", "conv_c": [n_ssm, B, W-1,
C] (compute dtype), "h": [n_ssm, B, H, P, N] fp32}`` for the SSM layers (a
kind without layers has no keys).  A layer works on the views of its index
within its kind, so decode writes into the stacked tensors in place.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import mlp_apply, mlp_init, rms_norm, zeros_init

__all__ = ["mixer_kind", "block_init", "block_apply", "stack_init", "stack_apply",
           "init_stack_cache"]

CACHE_KEYS = {"attn": ("k", "v", "pos"), "ssm": ("conv_x", "conv_b", "conv_c", "h")}


def mixer_kind(cfg: ModelConfig, i: int) -> str:
    return "attn" if cfg.layer_is_attention(i) else "ssm"


def _kind_index(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(mixer kind, index among the layers of that kind) of every layer."""
    seen = {"attn": 0, "ssm": 0}
    out = []
    for i in range(cfg.n_layers):
        kind = mixer_kind(cfg, i)
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def block_init(gen: torch.Generator, cfg: ModelConfig, i: int, dtype=torch.float32) -> dict:
    """Parameters of layer ``i``."""
    d = cfg.d_model
    init = attn_mod.attention_init if mixer_kind(cfg, i) == "attn" else ssm_mod.ssm_init
    params = {"ln1": zeros_init(gen, (d,), dtype), "mixer": init(gen, cfg, dtype)}
    if cfg.layer_is_moe(i):
        params["ln2"] = zeros_init(gen, (d,), dtype)
        params["ffn"] = moe_mod.moe_init(gen, cfg, dtype)
    elif cfg.d_ff:
        params["ln2"] = zeros_init(gen, (d,), dtype)
        params["ffn"] = mlp_init(gen, d, cfg.d_ff, dtype)
    return params


def block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, i: int, *, positions,
                cache: dict | None = None, update_cache: bool = False, ragged: bool = False):
    """Layer ``i``; returns (x, cache, aux): aux is the MoE layer's
    load-balancing loss (fp32), None on a layer without MoE."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if mixer_kind(cfg, i) == "attn":
        out, new_cache = attn_mod.attention_apply(
            params["mixer"], h, cfg, positions=positions, cache=cache,
            update_cache=update_cache, ragged=ragged,
        )
    else:  # positions unused: the state carries no positional record
        out, new_cache = ssm_mod.ssm_apply(params["mixer"], h, cfg, cache=cache,
                                           update_cache=update_cache)
    x = x + out
    aux = None
    if "ffn" in params:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        if cfg.layer_is_moe(i):
            out, aux = moe_mod.moe_apply(params["ffn"], h, cfg)
            x = x + out
        else:
            x = x + mlp_apply(params["ffn"], h)
    return x, new_cache, aux


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> list[dict]:
    return [block_init(gen, cfg, i, dtype) for i in range(cfg.n_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    kinds = [mixer_kind(cfg, i) for i in range(cfg.n_layers)]
    out = {}
    if "attn" in kinds:
        one = attn_mod.init_attention_cache(cfg, batch, seq_len, dtype, device)
        out.update({n: t.unsqueeze(0).repeat((kinds.count("attn"),) + (1,) * t.dim())
                    for n, t in one.items()})
    if "ssm" in kinds:
        one = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        out.update({n: t.unsqueeze(0).repeat((kinds.count("ssm"),) + (1,) * t.dim())
                    for n, t in one.items()})
    return out


def stack_apply(layers: list[dict], x: torch.Tensor, cfg: ModelConfig, *, positions,
                caches: dict | None = None, update_cache: bool = False, ragged: bool = False):
    """Returns (x, caches, aux).  With ``caches`` (decode) each layer writes
    into its slice in place and the same dict comes back; with
    ``update_cache`` (prefill) the new entries of every layer are stacked
    into a new dict.  aux is the MoE layers' load-balancing losses summed in
    fp32, 0 for a stack without MoE layers."""
    emitted = {"attn": [], "ssm": []}
    auxes = []
    remat = cfg.remat and torch.is_grad_enabled() and caches is None and not update_cache
    for i, (layer, (kind, k)) in enumerate(zip(layers, _kind_index(cfg))):
        if remat:
            x, _, aux = checkpoint(block_apply, layer, x, cfg, i, positions=positions,
                                   use_reentrant=False)
        else:
            layer_cache = None if caches is None else {n: caches[n][k] for n in CACHE_KEYS[kind]}
            x, nc, aux = block_apply(layer, x, cfg, i, positions=positions, cache=layer_cache,
                                     update_cache=update_cache, ragged=ragged)
            if caches is None and update_cache:
                emitted[kind].append(nc)
        if aux is not None:
            auxes.append(aux)
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=x.device))
    if caches is not None:
        return x, caches, aux
    if update_cache:
        return x, {n: torch.stack([c[n] for c in cs])
                   for kind, cs in emitted.items() if cs for n in CACHE_KEYS[kind]}, aux
    return x, None, aux
