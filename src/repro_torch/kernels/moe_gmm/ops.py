"""Public grouped expert matmul wrappers, differentiable.

``gmm`` is the counterpart of the JAX package's ``_gmm`` custom VJP
(``kernels/moe_gmm/ops.py``): the backward of a grouped matmul is two
grouped matmuls through the same kernel, dx = g w^T and dw = x^T g per
expert, each cast to its operand's dtype.  On a CUDA tensor every product,
forward and backward, launches the hand-written kernel
(``csrc/moe_gmm.cu``), which reads the transposed operands in place through
their strides, or raises: there is no fallback.  On a CPU tensor each
product is the plain PyTorch version (``ref.py``), through the same
autograd function.  ``expert_ffn`` composes three ``gmm`` calls, so it
backpropagates end to end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel
from .ref import reference_grouped_matmul

__all__ = ["gmm", "expert_ffn"]

MAX_CAPACITY = 65535 * 64  # the kernel's grid holds this many rows of M


def _layout_error(t: torch.Tensor) -> str | None:
    """Why the kernel cannot read ``t`` in place, or None: one of its last
    two dims contiguous (the last is taken first) and a multiple of 16
    bytes' worth of elements, its other strides multiples of the same, its
    base 16-byte aligned (TMA's conditions in bf16, vector loads' in fp32)."""
    elems = 16 // t.element_size()
    dim = 2 if t.stride(2) == 1 else 1 if t.stride(1) == 1 else None
    if dim is None:
        return f"neither of its last two dims is contiguous (strides {t.stride()})"
    if t.shape[dim] % elems:
        return f"its contiguous dim ({t.shape[dim]}) is not a multiple of {elems}"
    if t.data_ptr() % 16 or t.stride(0) % elems or t.stride(3 - dim) % elems:
        return f"its rows are not 16-byte aligned (strides {t.stride()})"
    return None


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected x [E,C,D], w [E,D,F]; got {tuple(x.shape)} {tuple(w.shape)}")
    e, c, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    if min(e, c, d, w.shape[2]) < 1 or e > 65535 or c > MAX_CAPACITY:
        raise ValueError(f"shape x {tuple(x.shape)} w {tuple(w.shape)} outside the kernel's grid")
    if x.device != w.device:
        raise ValueError(f"x and w on different devices: {x.device} {w.device}")
    if x.dtype not in kernel.DTYPES or x.dtype != w.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 x/w of one dtype; got "
                        f"{x.dtype} {w.dtype}")
    elems = 16 // x.element_size()
    if w.shape[2] % elems:
        raise ValueError(f"F ({w.shape[2]}), the output's rows, must be a multiple of {elems}")
    for name, t in (("x", x), ("w", w)):
        err = _layout_error(t)
        if err:
            raise ValueError(f"the kernel cannot read {name}: {err}")


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, C, D] x [E, D, F] -> [E, C, F] in ``x.dtype``: the kernel on the
    card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return reference_grouped_matmul(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm runs on cpu or cuda, not {x.device}")
    _check(x, w)
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype, device=x.device)
    kernel.launch(x, w, out)
    return out


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # g comes as the ops after gmm left it, and is read in place where
        # the kernel takes its layout.  The case it does not: a gradient
        # broadcast from a reduction (``gmm(x, w).sum()`` hands over a
        # stride-0 expand), which is made contiguous.
        if g.device.type == "cuda" and _layout_error(g):
            g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _product(g, w.transpose(1, 2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _product(x.transpose(1, 2), g).to(w.dtype)
        return dx, dw


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, C, D] x [E, D, F] -> [E, C, F] in ``x.dtype``, summed in fp32.
    Differentiable in x and w; dx and dw come back in their dtypes."""
    return _GroupedMatmul.apply(x, w)


def expert_ffn(params: dict, buckets: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert over capacity buckets [E, C, D] -> [E, C, D]: three
    grouped matmuls, ``silu(gate) * up`` between them in the buckets' dtype.
    The weights are cast to that dtype (a no-op once the model loaded them)."""
    dt = buckets.dtype
    wg, wu, wd = (params[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    h = F.silu(gmm(buckets, wg)) * gmm(buckets, wu)
    return gmm(h, wd)
