"""Public flash attention wrapper, differentiable.

The counterpart of the JAX package's ``_flash_attention`` custom VJP
(``kernels/flash_attention/ops.py``).  The forward runs the hand-written
kernel (``csrc/flash_attention.cu``) on a CUDA tensor, or raises: there is no
fallback; on a CPU tensor it computes the plain PyTorch version
(``ref.py``).  It saves q, k and v.  The backward recomputes the plain
version from them and differentiates it, as the JAX package's backward does
through its ``reference_attention``: the dense S x S scores are built at
grad time, in fp32.  A backward kernel is later work, there as here.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import reference_attention

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
    elems = 16 // q.element_size()  # 16-byte rows: TMA (bf16) and vector loads (fp32)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its head dim")
        if t.data_ptr() % 16 or any(t.stride(i) % elems for i in range(3)):
            raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.launch(q, k, v, out, causal=causal, window=window, scale=q.shape[-1] ** -0.5)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*leaves, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
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
    Differentiable in q, k and v; dq, dk and dv come back in their dtypes."""
    return _FlashAttention.apply(q, k, v, causal, window)
