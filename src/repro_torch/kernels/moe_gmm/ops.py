"""Public grouped expert matmul wrappers.

On a CPU tensor they compute the plain PyTorch version (``ref.py``).  On a
CUDA tensor ``gmm`` launches the hand-written kernel (``csrc/moe_gmm.cu``)
or raises: there is no fallback.  Forward only on the card: there a call
that would need a gradient raises ``NotImplementedError``, since the
kernel's output would carry none (the backward, two grouped matmuls
through the same kernel as in the JAX package's custom VJP, is ROADMAP B3).
The CPU path stays the differentiable plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel
from .ref import reference_grouped_matmul

__all__ = ["gmm", "expert_ffn"]

MAX_CAPACITY = 65535 * 64  # the kernel's grid holds this many rows of C


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
    elems = 16 // x.element_size()  # 16-byte rows: TMA (bf16) and vector loads (fp32)
    if d % elems or w.shape[2] % elems:
        raise ValueError(f"D ({d}) and F ({w.shape[2]}) must be multiples of {elems}")
    for name, t in (("x", x), ("w", w)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if t.data_ptr() % 16 or t.stride(0) % elems or t.stride(1) % elems:
            raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, C, D] x [E, D, F] -> [E, C, F] in ``x.dtype``, summed in fp32."""
    if x.device.type == "cpu":
        return reference_grouped_matmul(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "gmm has no backward on the card yet (ROADMAP B3): call it under "
            "torch.no_grad(), or on CPU tensors for the differentiable plain version")
    _check(x, w)
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype, device=x.device)
    kernel.launch(x, w, out)
    return out


def expert_ffn(params: dict, buckets: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert over capacity buckets [E, C, D] -> [E, C, D]: three
    grouped matmuls, ``silu(gate) * up`` between them in the buckets' dtype.
    The weights are cast to that dtype (a no-op once the model loaded them)."""
    dt = buckets.dtype
    wg, wu, wd = (params[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    h = F.silu(gmm(buckets, wg)) * gmm(buckets, wu)
    return gmm(h, wd)
