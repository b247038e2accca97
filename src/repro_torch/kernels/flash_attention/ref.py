"""Plain PyTorch version of the flash attention kernels: the CPU path of
``ops.flash_attention`` and the oracle the CUDA kernels are held against on
the card.  The forward has the arithmetic of the JAX package's
``reference_attention``: fp32 scores, masked entries set to -1e30, softmax,
output cast to ``q.dtype``; ``attention_forward`` also gives each row's
logsumexp.  ``attention_backward`` is the backward kernel's plain version:
the formulas of ``jax.vjp(reference_attention)`` from o and the logsumexp
rows, dense, in fp32."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, causal, window, scale):
    """Scaled fp32 scores [B, KV, G, S, Skv], the masked ones -1e30."""
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    return scores.masked_fill(~mask, NEG_INF)


def _attend(q, k, v, causal, window, scale, with_lse):
    b, s, h, d = q.shape
    scale = scale if scale is not None else d**-0.5
    scores = _scores(q, k, causal, window, scale)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float()).reshape(b, s, h, d).to(q.dtype)
    return out, (torch.logsumexp(scores, dim=-1).reshape(b, h, s) if with_lse else None)


def attention_forward(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, H, D] in ``q.dtype``, lse [B, H, S] fp32): lse is each
    row's logsumexp of the scaled scores over the keys it attends to."""
    return _attend(q, k, v, causal, window, scale, True)


def reference_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, Skv, KV, D] -> [B, S, H, D] in ``q.dtype``."""
    return _attend(q, k, v, causal, window, scale, False)[0]


def attention_backward(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,
    o: torch.Tensor,  # [B, S, H, D], the forward's output
    lse: torch.Tensor,  # [B, H, S] fp32
    do: torch.Tensor,  # [B, S, H, D], the cotangent of o
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes, in fp32 with the S x S matrices
    built: P = exp(scale Q K^T - lse) masked, dV = P^T dO, dS = P (dO V^T -
    rowsum(dO o)), dQ = scale dS K, dK = scale dS^T Q; dK and dV summed over
    the query heads of each kv head's group."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d**-0.5
    qf = q.float().reshape(b, s, kv, g, d)
    dof = do.float().reshape(b, s, kv, g, d)
    kf, vf = k.float(), v.float()
    # a masked score, -1e30, gives exactly 0
    p = torch.exp(_scores(q, k, causal, window, scale) - lse.reshape(b, kv, g, s, 1))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    delta = (dof * o.float().reshape(b, s, kv, g, d)).sum(-1).permute(0, 2, 3, 1)  # [b,kv,g,s]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, s, h, d) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
