"""Basic layers: norms, rotary embeddings, gated MLP, initialisers.

Counterpart of the JAX package's ``models/layers.py``.  Parameters are plain
dicts of tensors laid out as there (``x @ w`` with ``w`` of shape
``[in, out]``), so that weights cross the bridge unchanged.  Initialisers take
an explicit ``torch.Generator`` and draw from the same distributions as the
JAX ones; the numbers differ, since the generators do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "dense_init",
    "embed_init",
    "rms_norm",
    "rope_frequencies",
    "apply_rope",
    "swiglu",
    "mlp_init",
    "mlp_apply",
    "cross_entropy_loss",
]


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated normal (+-2 sigma) with fan-in std, on ``gen``'s device."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


def zeros_init(gen: torch.Generator, shape: tuple[int, ...], dtype=torch.float32):
    """Norm scales start at zero (``rms_norm`` scales by ``1 + scale``)."""
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings (half of head_dim)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Half-split
    rotation computed in fp32."""
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * inv  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU.  The weights are used in ``x``'s dtype; a ``.to`` is a
    no-op once the model's weights were cast at load time."""
    dt = x.dtype
    h = swiglu(x @ params["w_gate"].to(dt), x @ params["w_up"].to(dt))
    return h @ params["w_down"].to(dt)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over the positions ``mask`` keeps, in
    fp32: logsumexp minus the gold logit, masked, over ``max(mask.sum(), 1)``.
    The gold logit is gathered; the JAX package contracts a one-hot instead
    (for vocab-sharded logits), which gives the same value in fp32 and would
    cost another [B, S, V] tensor here."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
