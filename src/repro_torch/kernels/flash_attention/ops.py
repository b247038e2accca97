"""Public flash attention wrapper, differentiable.

The counterpart of the JAX package's ``_flash_attention`` custom VJP
(``kernels/flash_attention/ops.py``), whose backward differentiates its
dense ``reference_attention``.  Here both directions are kernels on a CUDA
tensor (``csrc/flash_attention.cu``), or raise: there is no fallback.  When
an input requires grad, the forward kernel also writes each row's logsumexp
and the autograd function saves q, k, v, o and it; the backward computes
dq, dk and dv from them without building the S x S matrix, only those that
autograd asks for: a pre-pass (each row's dO . o and lse in base 2), then
one grid of dK/dV blocks and dQ blocks that starts behind the pre-pass by
programmatic dependent launch (bf16; two grids in fp32).  On a CPU tensor
the same autograd function
computes the plain versions (``ref.py``: ``attention_forward`` and
``attention_backward``, the formulas of the JAX VJP in fp32), so that the
CPU tests hold the function the kernels are held against on the card.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import attention_backward, attention_forward, reference_attention

__all__ = ["flash_attention"]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q [B,S,H,D], k/v [B,Skv,KV,D]; got {q.shape} {k.shape} {v.shape}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {k.shape} {v.shape} do not fit q {q.shape}")
    if s == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device} {k.device} {v.device}")
    if q.dtype not in kernel.DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one dtype; got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes {kernel.HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t)


def _check_rows(name: str, t: torch.Tensor) -> None:
    """16-byte rows: TMA's condition (bf16) and vector loads' (fp32)."""
    elems = 16 // t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"{name} must be contiguous in its head dim")
    if t.data_ptr() % 16 or any(t.stride(i) % elems for i in range(3)):
        raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")


def _forward(q, k, v, causal: bool, window: int, with_lse: bool = False):
    """(out, lse [B, H, S] fp32 or None): the kernel on the card, the plain
    version on the CPU."""
    scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if with_lse:
            return attention_forward(q, k, v, causal=causal, window=window, scale=scale)
        return reference_attention(q, k, v, causal=causal, window=window, scale=scale), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    kernel.launch(q, k, v, out, lse, causal=causal, window=window, scale=scale)
    return out, lse


def _backward(q, k, v, o, lse, g, need, causal: bool, window: int):
    """(dq, dk, dv), each None where ``need`` does not ask for it: the
    backward kernels on the card (one launch of the library), the plain
    version on the CPU."""
    scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        grads = attention_backward(q, k, v, o, lse, g, causal=causal, window=window, scale=scale)
        return tuple(t if n else None for t, n in zip(grads, need))
    if 0 in g.stride():  # a gradient broadcast from a reduction: the only copy
        g = g.contiguous()
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"cotangent {g.dtype} {tuple(g.shape)} does not fit the output "
                         f"{q.dtype} {tuple(q.shape)}")
    _check_rows("the cotangent", g)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) if need[0] else None
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device) if need[1] else None
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device) if need[2] else None
    b, s, h, _ = q.shape
    scratch = torch.empty((2, b, h, kernel.scratch_rows(s)), dtype=torch.float32,
                          device=q.device)
    kernel.launch_bwd(q, k, v, o, lse, g, dq, dk, dv, scratch, causal=causal, window=window,
                      scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, g, ctx.needs_input_grad[:3], ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Causal / sliding-window GQA attention, scale ``D ** -0.5``; output
    [B, S, H, D] in ``q.dtype``.  ``window <= 0`` means no window.
    Differentiable in q, k and v; dq, dk and dv come back in their dtypes.
    Where no gradient can flow (grad mode off, as in serving, or no input
    requiring grad), the forward runs alone and writes no logsumexp rows."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)[0]
