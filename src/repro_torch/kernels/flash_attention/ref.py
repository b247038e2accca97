"""Plain PyTorch version of the flash attention kernel: the CPU path of
``ops.flash_attention`` and the oracle the CUDA kernel is held against on the
card.  Same arithmetic as the JAX package's ``reference_attention``: fp32
scores, masked entries set to -1e30, softmax, output cast to ``q.dtype``."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d**-0.5
    qf = q.float().reshape(b, s, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
