"""Attention: GQA with qk-norm, RoPE and sliding window, and MLA.

Counterpart of the JAX package's ``models/attention.py``.  Three execution
paths:

  * GQA prefill / train: the whole sequence at once through
    ``kernels.flash_attention`` -- the hand-written kernel on the card, its
    plain version on the CPU;
  * GQA decode: one token per row against a ring KV cache, in plain PyTorch
    with the reference's numerics (fp32 softmax, probabilities cast to the
    compute dtype before the PV product).  Sliding-window layers keep
    ``window`` entries;
  * MLA (multi-head latent attention, minicpm3): the expanded form through
    ``blockwise_attention`` in prefill and training (q/k head dim
    ``qk_nope + qk_rope``, v head dim ``v_head_dim``), the absorbed form over
    the compressed cache in decode.  Both are plain PyTorch because the JAX
    package computes them outside any Pallas kernel, whatever its ``impl``
    (its ``mla_apply`` calls ``blockwise_attention`` and einsums): there is
    no TPU kernel on this path to port.

A GQA cache is a dict ``{"k", "v": [B, L, KV, D], "pos": [B, L] int32}``, an
MLA cache ``{"ckv": [B, L, kv_lora_rank], "k_rope": [B, L, qk_rope],
"pos"}``; decode writes the new entry into it in place and returns the same
dict.
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
    "mla_init",
    "mla_apply",
    "init_mla_cache",
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
    [B, Kv, G, q_chunk, Sk].  ``q_offset`` is the absolute position of q[0].
    The value head dim may differ from the query's (MLA)."""
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


def _write_ring(cache: dict, new: dict, pos: torch.Tensor, ragged: bool) -> None:
    """Write each leaf of ``new`` ([B, 1, ...]) and the positions ``pos``
    [B] into ``cache``'s ring in place: each row at its own slot ``pos %
    L`` (``ragged``), or the whole batch at row 0's slot (lockstep)."""
    length = cache["pos"].shape[1]
    if ragged:
        rows = torch.arange(pos.shape[0], device=pos.device)
        slot = pos % length
        for name, t in new.items():
            cache[name][rows, slot] = t[:, 0].to(cache[name].dtype)
        cache["pos"][rows, slot] = pos.to(torch.int32)
    else:
        slot = (pos[:1] % length).long()
        for name, t in new.items():
            cache[name].index_copy_(1, slot, t.to(cache[name].dtype))
        cache["pos"].index_copy_(1, slot, pos[:, None].to(torch.int32))


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
        _write_ring(cache, {"k": k, "v": v}, pos, ragged)
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        delta = pos[:, None] - cpos
        valid = (cpos >= 0) & (delta >= 0)
        if window > 0:
            valid &= delta < window
        mask = valid[:, None, None, None, :]  # [B,1,1,1,L]
        out = masked_attention(q, ck.to(dt), cv.to(dt), mask, h**-0.5)
        new_cache = cache

    out = out.reshape(b, s, cfg.n_heads * h)
    return out @ params["w_o"].to(dt), new_cache


# --------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# --------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    m, d, nh = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, (d, m.q_lora_rank), dtype),
        "q_norm": zeros_init(gen, (m.q_lora_rank,), dtype),
        "w_uq": dense_init(gen, (m.q_lora_rank, nh * qk), dtype),
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dtype),
        "kv_norm": zeros_init(gen, (m.kv_lora_rank,), dtype),
        "w_uk": dense_init(gen, (m.kv_lora_rank, nh * m.qk_nope_head_dim), dtype),
        "w_uv": dense_init(gen, (m.kv_lora_rank, nh * m.v_head_dim), dtype),
        "w_o": dense_init(gen, (nh * m.v_head_dim, d), dtype),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    """The compressed cache: the latent KV and the decoupled RoPE keys, no
    window."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, seq_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, seq_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, seq_len), -1, dtype=torch.int32, device=device),
    }


def _mla_qkv(params, x, cfg, positions):
    """(q_nope, q_rope [B, S, H, .], ckv [B, S, rank], k_rope [B, S, rope]):
    the RoPE keys are rotated with a singleton head axis, shared by every
    head."""
    m, dt = cfg.mla, x.dtype
    b, s, _ = x.shape
    cq = rms_norm(x @ params["w_dq"].to(dt), params["q_norm"], cfg.norm_eps)
    q = (cq @ params["w_uq"].to(dt)).reshape(b, s, cfg.n_heads,
                                             m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim :]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = x @ params["w_dkv"].to(dt)
    ckv = rms_norm(dkv[..., : m.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def mla_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: dict | None = None,
    update_cache: bool = False,
    ragged: bool = False,
):
    """Returns (out [B,S,D], cache), as ``attention_apply``.  Prefill and
    training expand the latent KV into per-head keys and values and attend
    through ``blockwise_attention``; decode absorbs ``w_uk`` into the query
    and ``w_uv`` into the output and attends over the compressed cache,
    keeping the probabilities in fp32 and contracting them with an fp32 copy
    of ``ckv``, as the reference does."""
    m, dt = cfg.mla, x.dtype
    b, s, _ = x.shape
    nh = cfg.n_heads
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_nope, q_rope, ckv, k_rope = _mla_qkv(params, x, cfg, positions)

    if cache is None:
        k_nope = (ckv @ params["w_uk"].to(dt)).reshape(b, s, nh, m.qk_nope_head_dim)
        v = (ckv @ params["w_uv"].to(dt)).reshape(b, s, nh, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(q_rope.shape)], dim=-1)
        out = blockwise_attention(q, k, v, causal=True, window=0, q_offset=0, scale=scale)
        new_cache = None
        if update_cache:
            new_cache = {"ckv": ckv, "k_rope": k_rope, "pos": positions.to(torch.int32)}
    else:
        if s != 1:
            raise ValueError("decode expects a single new token per row")
        pos = positions[:, 0]
        _write_ring(cache, {"ckv": ckv, "k_rope": k_rope}, pos, ragged)
        cckv, ckrope, cpos = cache["ckv"], cache["k_rope"], cache["pos"]
        w_uk = params["w_uk"].to(dt).reshape(m.kv_lora_rank, nh, m.qk_nope_head_dim)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # [B,1,H,rank]
        scores = (torch.einsum("bshr,blr->bhsl", q_lat.float(), cckv.to(dt).float())
                  + torch.einsum("bshd,bld->bhsl", q_rope.float(), ckrope.to(dt).float()))
        valid = (cpos >= 0) & (pos[:, None] >= cpos)
        scores = torch.where(valid[:, None, None, :], scores * scale, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhsl,blr->bshr", probs, cckv.float())  # [B,1,H,rank]
        w_uv = params["w_uv"].to(dt).reshape(m.kv_lora_rank, nh, m.v_head_dim)
        out = torch.einsum("bshr,rhd->bshd", o_lat.to(dt), w_uv)
        new_cache = cache

    out = out.reshape(b, s, nh * m.v_head_dim).to(dt)
    return out @ params["w_o"].to(dt), new_cache
