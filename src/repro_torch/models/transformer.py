"""Transformer stack for decoder-only dense, MoE, MLA and attention-free
SSM models, hybrids that interleave attention and SSM layers (jamba), and
the encoder and decoder stacks of an encoder-decoder (seamless-m4t).

Counterpart of the JAX package's ``models/transformer.py``.  Block = norm ->
mixer -> residual [-> norm -> cross-attention -> residual] -> norm -> FFN ->
residual.  The mixer is GQA attention on the layers
``cfg.layer_is_attention(i)`` names (MLA where ``cfg.attn_type`` is "mla")
and the Mamba-2 SSM elsewhere (``mixer_kind``); the FFN is the MoE layer on
the layers ``cfg.layer_is_moe(i)`` names, the dense SwiGLU elsewhere, and
none where ``d_ff`` is 0 (mamba2 is norm -> SSM mixer -> residual only).
Each MoE layer's load-balancing loss comes back beside x, summed over the
layers in fp32 by ``stack_apply``, as the reference's stack returns it:
training adds it to the loss, prefill and decode ignore it.  The JAX stack
scans over scan-stacked parameters; here the layers are a Python list (one
param dict per layer) run in a loop, and ``stack_axes`` names each layer's
leaves' logical axes in the same list (the reference's leading ``layers``
entry of a scanned leaf has no dim here).  With a ``mesh`` each layer runs
on this rank's blocks of its weights (``runtime/sharding.py``), the
residual stream whole on every rank; the reference's ``constrain_residual``
is a layout hint to its compiler with no numeric effect.  In training (grad mode
on, no cache, no ``update_cache``) each block runs under
``torch.utils.checkpoint`` when ``cfg.remat`` is set, the counterpart of the
JAX stack's ``jax.checkpoint`` over the scanned block: its activations are
recomputed in the backward pass, so attention's forward, the MoE layer's
three grouped matmuls and the SSD scan's forward run twice a layer per step.
The recompute routes exactly as the forward did: routing depends only on
the block's inputs.  On a mesh it runs the layer's collectives again,
every rank in the same order.

An encoder block (``encoder_apply``) is bidirectional GQA attention with no
RoPE and no qk-norm, then a dense FFN, never MoE.  A decoder block of an
encoder-decoder adds ``ln_cross`` and ``cross``: attention of its queries
against K/V that ``cross_kv`` computes once from the encoder's output.  The
encoder's attention and cross-attention run in plain PyTorch
(``blockwise_attention``, ``masked_attention``) because the JAX package
runs them outside any Pallas kernel under either ``impl``; the decoder's
causal self-attention goes through the flash kernel as any decoder's does.

Cache layout, which the serving pool indexes: one flat dict whose every
leaf has batch on dim 1, each kind stacked over the layers of that kind
only -- ``{"k", "v": [n_attn, B, L, KV, D], "pos": [n_attn, B, L] int32}``
for GQA layers, ``{"ckv": [n_mla, B, L, rank], "k_rope": [n_mla, B, L,
rope], "pos"}`` for MLA layers, ``{"conv_x", "conv_b", "conv_c": [n_ssm,
B, W-1, C] (compute dtype), "h": [n_ssm, B, H, P, N] fp32}`` for the SSM
layers (a kind without layers has no keys), and for an encoder-decoder
``{"cross_k", "cross_v": [n_layers, B, M, KV, D]}``, the encoder memory's
K/V of each decoder layer, which decode reads and never writes.  A layer
works on the views of its index within its kind, so decode writes into the
stacked tensors in place.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import MLP_AXES, mlp_apply, mlp_init, mlp_mesh, rms_norm, zeros_init

__all__ = ["mixer_kind", "block_init", "block_apply", "stack_init", "stack_apply",
           "stack_axes", "init_stack_cache", "encoder_block_init", "encoder_apply", "cross_kv"]

CACHE_KEYS = {"attn": ("k", "v", "pos"), "mla": ("ckv", "k_rope", "pos"),
              "ssm": ("conv_x", "conv_b", "conv_c", "h")}
CROSS_KEYS = ("cross_k", "cross_v")  # an encoder-decoder's, one per decoder layer


def mixer_kind(cfg: ModelConfig, i: int) -> str:
    if cfg.layer_is_attention(i):
        return "mla" if cfg.attn_type == "mla" else "attn"
    return "ssm"


def _kind_index(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(mixer kind, index among the layers of that kind) of every layer."""
    seen = {"attn": 0, "mla": 0, "ssm": 0}
    out = []
    for i in range(cfg.n_layers):
        kind = mixer_kind(cfg, i)
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


_MIXER_INIT = {"attn": attn_mod.attention_init, "mla": attn_mod.mla_init,
               "ssm": ssm_mod.ssm_init}


def block_init(gen: torch.Generator, cfg: ModelConfig, i: int, dtype=torch.float32) -> dict:
    """Parameters of decoder layer ``i``, drawn in the reference's order
    (``ln_cross`` and ``cross`` for an encoder-decoder)."""
    d = cfg.d_model
    params = {"ln1": zeros_init(gen, (d,), dtype),
              "mixer": _MIXER_INIT[mixer_kind(cfg, i)](gen, cfg, dtype)}
    if cfg.enc_dec:
        params["ln_cross"] = zeros_init(gen, (d,), dtype)
        params["cross"] = attn_mod.attention_init(gen, cfg, dtype)
    if cfg.layer_is_moe(i):
        params["ln2"] = zeros_init(gen, (d,), dtype)
        params["ffn"] = moe_mod.moe_init(gen, cfg, dtype)
    elif cfg.d_ff:
        params["ln2"] = zeros_init(gen, (d,), dtype)
        params["ffn"] = mlp_init(gen, d, cfg.d_ff, dtype)
    return params


def block_axes(cfg: ModelConfig, i: int, *, encoder: bool = False) -> dict:
    """Logical axes of the leaves of decoder layer ``i`` (of an encoder
    layer with ``encoder``), in ``block_init``'s tree."""
    kind = "attn" if encoder else mixer_kind(cfg, i)
    mixer = {"attn": lambda: attn_mod.attention_axes(cfg), "mla": lambda: attn_mod.MLA_AXES,
             "ssm": lambda: ssm_mod.SSM_AXES}[kind]()
    axes = {"ln1": ("embed",), "mixer": dict(mixer)}
    if cfg.enc_dec and not encoder:
        axes["ln_cross"] = ("embed",)
        axes["cross"] = attn_mod.attention_axes(cfg)
    if cfg.layer_is_moe(i) and not encoder:
        axes["ln2"], axes["ffn"] = ("embed",), dict(moe_mod.MOE_AXES)
    elif cfg.d_ff:
        axes["ln2"], axes["ffn"] = ("embed",), dict(MLP_AXES)
    return axes


def stack_axes(cfg: ModelConfig, *, n_layers: int | None = None, encoder: bool = False) -> list:
    """Logical axis names of every layer's leaves, one dict per layer."""
    return [block_axes(cfg, i, encoder=encoder) for i in range(n_layers or cfg.n_layers)]


def _cross_attention(params: dict, x: torch.Tensor, cross: tuple, cfg: ModelConfig):
    """Decoder cross-attention of ``x``'s queries against the encoder
    memory's precomputed ``cross`` = (k, v) [B, M, KV, D]: no mask, no
    RoPE."""
    dt = x.dtype
    b, s, _ = x.shape
    h = cfg.head_dim
    q = (x @ params["w_q"].to(dt)).reshape(b, s, cfg.n_heads, h)
    k, v = (t.to(dt) for t in cross)
    mask = torch.ones((1, 1, 1, s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = attn_mod.masked_attention(q, k, v, mask, h**-0.5)
    return out.reshape(b, s, cfg.n_heads * h) @ params["w_o"].to(dt)


def cross_kv(params: dict, memory: torch.Tensor, cfg: ModelConfig) -> tuple:
    """A decoder layer's cross-attention (k, v) [B, M, KV, D] from the
    encoder's output, computed once at prefill."""
    dt = memory.dtype
    b, m, _ = memory.shape
    h = cfg.head_dim
    k = (memory @ params["w_k"].to(dt)).reshape(b, m, cfg.n_kv_heads, h)
    v = (memory @ params["w_v"].to(dt)).reshape(b, m, cfg.n_kv_heads, h)
    return k, v


def block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, i: int, *, positions,
                cache: dict | None = None, update_cache: bool = False, ragged: bool = False,
                cross: tuple | None = None, mesh=None, key=None, rows=None):
    """Layer ``i``; returns (x, cache, aux): aux is the MoE layer's
    load-balancing loss (fp32), None on a layer without MoE.  ``cross`` is
    the layer's encoder-memory (k, v) in an encoder-decoder.  With ``mesh``
    the params are this rank's blocks; ``key`` reaches the MoE layer (the
    Valiant shuffle), the same key on every layer, as in the reference, and
    so does ``rows`` (``moe_apply``'s)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    kind = mixer_kind(cfg, i)
    if kind == "ssm":  # positions unused: the state carries no positional record
        out, new_cache = ssm_mod.ssm_apply(params["mixer"], h, cfg, cache=cache,
                                           update_cache=update_cache, mesh=mesh)
    elif kind == "attn":
        out, new_cache = attn_mod.attention_apply(params["mixer"], h, cfg, positions=positions,
                                                  cache=cache, update_cache=update_cache,
                                                  ragged=ragged, mesh=mesh)
    else:
        out, new_cache = attn_mod.mla_apply(params["mixer"], h, cfg, positions=positions,
                                            cache=cache, update_cache=update_cache,
                                            ragged=ragged)
    x = x + out
    if "cross" in params:
        hc = rms_norm(x, params["ln_cross"], cfg.norm_eps)
        x = x + _cross_attention(params["cross"], hc, cross, cfg)
    aux = None
    if "ffn" in params:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        if cfg.layer_is_moe(i):
            out, aux = moe_mod.moe_apply(params["ffn"], h, cfg, key=key, mesh=mesh, rows=rows)
            x = x + out
        else:
            x = x + mlp_apply(params["ffn"], h, mesh=mlp_mesh(cfg.d_model, cfg.d_ff, mesh))
    return x, new_cache, aux


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> list[dict]:
    return [block_init(gen, cfg, i, dtype) for i in range(cfg.n_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device=None, mem_len: int = 0, mesh=None) -> dict:
    """Empty decode caches (on a mesh, of this rank's heads and channels);
    an encoder-decoder's cross K/V hold ``mem_len`` zero rows (prefill fills
    them from the encoder's output)."""
    kinds = [mixer_kind(cfg, i) for i in range(cfg.n_layers)]
    one_layer = {
        "attn": lambda: attn_mod.init_attention_cache(cfg, batch, seq_len, dtype, device, mesh),
        "mla": lambda: attn_mod.init_mla_cache(cfg, batch, seq_len, dtype, device),
        "ssm": lambda: ssm_mod.init_ssm_cache(cfg, batch, dtype, device, mesh),
    }
    out = {}
    for kind, make in one_layer.items():
        if kind in kinds:
            out.update({n: t.unsqueeze(0).repeat((kinds.count(kind),) + (1,) * t.dim())
                        for n, t in make().items()})
    if cfg.enc_dec:
        shape = (cfg.n_layers, batch, mem_len, cfg.n_kv_heads, cfg.head_dim)
        out.update({n: torch.zeros(shape, dtype=dtype, device=device) for n in CROSS_KEYS})
    return out


def stack_apply(layers: list[dict], x: torch.Tensor, cfg: ModelConfig, *, positions,
                caches: dict | None = None, update_cache: bool = False, ragged: bool = False,
                cross: dict | None = None, mesh=None, key=None, rows=None):
    """Returns (x, caches, aux).  With ``caches`` (decode) each layer writes
    into its slice in place and the same dict comes back; with
    ``update_cache`` (prefill) the new entries of every layer are stacked
    into a new dict (with ``cross``'s leaves beside them).  An
    encoder-decoder's decoder takes its encoder-memory K/V from ``cross``
    (``{"cross_k", "cross_v"}``, in training and prefill) or from the
    caches (decode).  aux is the MoE layers' load-balancing losses summed
    in fp32, 0 for a stack without MoE layers."""
    emitted = {kind: [] for kind in CACHE_KEYS}
    auxes = []
    remat = cfg.remat and torch.is_grad_enabled() and caches is None and not update_cache
    memory = cross if cross is not None else caches
    for i, (layer, (kind, k)) in enumerate(zip(layers, _kind_index(cfg))):
        layer_cross = (memory["cross_k"][i], memory["cross_v"][i]) if cfg.enc_dec else None
        if remat:
            x, _, aux = checkpoint(block_apply, layer, x, cfg, i, positions=positions,
                                   cross=layer_cross, mesh=mesh, key=key, rows=rows,
                                   use_reentrant=False)
        else:
            layer_cache = None if caches is None else {n: caches[n][k] for n in CACHE_KEYS[kind]}
            x, nc, aux = block_apply(layer, x, cfg, i, positions=positions, cache=layer_cache,
                                     update_cache=update_cache, ragged=ragged, cross=layer_cross,
                                     mesh=mesh, key=key, rows=rows)
            if caches is None and update_cache:
                emitted[kind].append(nc)
        if aux is not None:
            auxes.append(aux)
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=x.device))
    if caches is not None:
        return x, caches, aux
    if update_cache:
        out = {n: torch.stack([c[n] for c in cs])
               for kind, cs in emitted.items() if cs for n in CACHE_KEYS[kind]}
        if cfg.enc_dec:
            out.update({n: cross[n] for n in CROSS_KEYS})
        return x, out, aux
    return x, None, aux


# --------------------------------------------------------------------------
# encoder (of an encoder-decoder)
# --------------------------------------------------------------------------


def encoder_block_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    """An encoder layer: GQA attention and a dense FFN, in the reference's
    order."""
    d = cfg.d_model
    return {"ln1": zeros_init(gen, (d,), dtype), "mixer": attn_mod.attention_init(gen, cfg, dtype),
            "ln2": zeros_init(gen, (d,), dtype), "ffn": mlp_init(gen, d, cfg.d_ff, dtype)}


def _encoder_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional attention over the whole sequence (no RoPE, no
    qk-norm; plain PyTorch, as the reference computes it outside its
    kernel), then the dense FFN."""
    dt = x.dtype
    b, s, _ = x.shape
    hd, mixer = cfg.head_dim, params["mixer"]
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    q = (h @ mixer["w_q"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    k = (h @ mixer["w_k"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ mixer["w_v"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    out = attn_mod.blockwise_attention(q, k, v, causal=False, window=0, q_offset=0,
                                       scale=hd**-0.5)
    x = x + out.reshape(b, s, -1) @ mixer["w_o"].to(dt)
    return x + mlp_apply(params["ffn"], rms_norm(x, params["ln2"], cfg.norm_eps))


def encoder_apply(layers: list[dict], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder stack over x [B, S, D], each block under
    ``torch.utils.checkpoint`` in training when ``cfg.remat`` is set."""
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x = checkpoint(_encoder_block, layer, x, cfg, use_reentrant=False)
        else:
            x = _encoder_block(layer, x, cfg)
    return x
