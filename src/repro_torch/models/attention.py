"""Attention: GQA with qk-norm, RoPE and sliding window.

Counterpart of the JAX package's ``models/attention.py`` (GQA only; MLA
waits for a later slice).  Two execution paths:

  * prefill / train: the whole sequence at once through
    ``kernels.flash_attention`` -- the hand-written kernel on the card, its
    plain version on the CPU;
  * decode: one token per row against a ring KV cache, in plain PyTorch with
    the reference's numerics (fp32 softmax, probabilities cast to the compute
    dtype before the PV product).  Sliding-window layers keep ``window``
    entries.

A cache is a dict ``{"k", "v": [B, L, KV, D], "pos": [B, L] int32}``; decode
writes the new entry into it in place and returns the same dict.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import ops as fa_ops
from .layers import apply_rope, dense_init, rms_norm, zeros_init

__all__ = [
    "attention_init",
    "attention_apply",
    "init_attention_cache",
    "masked_attention",
    "blockwise_attention",
]

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q [B,Sq,H,D], k [B,Sk,Kv,D] -> fp32 scores [B,Kv,G,Sq,Sk]."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, sq, kv, h // kv, d)
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def _gqa_out(probs, v):
    """probs [B,Kv,G,Sq,Sk] (compute dtype), v [B,Sk,Kv,D] -> fp32 [B,Sq,H,D]."""
    b, kv, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return out.reshape(b, sq, kv * g, v.shape[-1])


def masked_attention(q, k, v, mask, scale):
    """Softmax attention with a boolean mask (True = attend) broadcastable to
    [B, 1, 1, Sq, Sk]: fp32 scores and softmax, probabilities rounded to the
    compute dtype, fp32 accumulation of the PV product."""
    scores = _gqa_scores(q, k) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _gqa_out(probs, v).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool, window: int, q_offset: int, scale,
                        q_chunk: int = 4096):
    """``masked_attention`` over query chunks against the full key range (the
    JAX package's XLA prefill path), bounding the live scores to
    [B, Kv, G, q_chunk, Sk].  ``q_offset`` is the absolute position of q[0]."""
    sq, sk = q.shape[1], k.shape[1]
    k_pos = torch.arange(sk, device=q.device)
    outs = []
    for start in range(0, sq, q_chunk):
        qc = q[:, start : start + q_chunk]
        q_pos = q_offset + start + torch.arange(qc.shape[1], device=q.device)
        mask = torch.ones((qc.shape[1], sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        outs.append(masked_attention(qc, k, v, mask, scale))
    return torch.cat(outs, dim=1)


def attention_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    d, h = cfg.d_model, cfg.head_dim
    params = {
        "w_q": dense_init(gen, (d, cfg.n_heads * h), dtype),
        "w_k": dense_init(gen, (d, cfg.n_kv_heads * h), dtype),
        "w_v": dense_init(gen, (d, cfg.n_kv_heads * h), dtype),
        "w_o": dense_init(gen, (cfg.n_heads * h, d), dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = zeros_init(gen, (h,), dtype)
        params["k_norm"] = zeros_init(gen, (h,), dtype)
    return params


def cache_length(cfg: ModelConfig, seq_len: int) -> int:
    """Ring length of a layer's cache: SWA layers keep ``window`` entries."""
    if cfg.attn_type == "swa" and cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_attention_cache(cfg: ModelConfig, batch: int, seq_len: int,
                         dtype=torch.bfloat16, device=None) -> dict:
    length = cache_length(cfg, seq_len)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def attention_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # [B, S] absolute positions
    cache: dict | None = None,
    update_cache: bool = False,
    ragged: bool = False,
):
    """Returns (out [B,S,D], cache).  Without a cache: prefill over the whole
    sequence, returning the new entries when ``update_cache``.  With one:
    a decode step (S == 1) that writes its entry into ``cache`` in place --
    one shared ring slot (``ragged=False``, lockstep batch) or each row's own
    slot (``ragged=True``, continuous batching)."""
    dt = x.dtype
    b, s, _ = x.shape
    h = cfg.head_dim
    q = (x @ params["w_q"].to(dt)).reshape(b, s, cfg.n_heads, h)
    k = (x @ params["w_k"].to(dt)).reshape(b, s, cfg.n_kv_heads, h)
    v = (x @ params["w_v"].to(dt)).reshape(b, s, cfg.n_kv_heads, h)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if cfg.attn_type == "swa" else 0

    if cache is None:
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        new_cache = None
        if update_cache:
            new_cache = {"k": k, "v": v, "pos": positions.to(torch.int32)}
    else:
        if s != 1:
            raise ValueError("decode expects a single new token per row")
        pos = positions[:, 0]
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        length = ck.shape[1]
        if ragged:
            rows = torch.arange(b, device=x.device)
            slot = pos % length
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
            cpos[rows, slot] = pos.to(torch.int32)
        else:
            slot = (pos[:1] % length).long()
            ck.index_copy_(1, slot, k.to(ck.dtype))
            cv.index_copy_(1, slot, v.to(cv.dtype))
            cpos.index_copy_(1, slot, pos[:, None].to(torch.int32))
        delta = pos[:, None] - cpos
        valid = (cpos >= 0) & (delta >= 0)
        if window > 0:
            valid &= delta < window
        mask = valid[:, None, None, None, :]  # [B,1,1,1,L]
        out = masked_attention(q, ck.to(dt), cv.to(dt), mask, h**-0.5)
        new_cache = cache

    out = out.reshape(b, s, cfg.n_heads * h)
    return out @ params["w_o"].to(dt), new_cache
