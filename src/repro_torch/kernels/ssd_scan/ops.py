"""Public SSD chunked-scan wrapper.

On a CPU tensor ``ssd`` computes the plain PyTorch version (``ref.py``) in
chunks of ``chunk`` rows.  On a CUDA tensor it launches the hand-written
kernel (``csrc/ssd_scan.cu``), which takes chunks of its own size
(``kernel.CHUNK``; the result does not depend on the chunk), or raises:
there is no fallback.  The library dispatches by dtype (``kernel.route``):
bfloat16 x/b/c run on the tensor cores with the fp32 factors split into two
bf16 terms, float32 on the FMA units, both hand-written.  Forward only on
the card: there a call that would need a gradient raises
``NotImplementedError``, since the kernel's outputs would carry none (the
backward, which the JAX package's custom VJP recomputes through the
sequential ``reference_ssd``, is ROADMAP B4).  The CPU path stays the
differentiable plain version.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import ssd_chunked

__all__ = ["ssd"]


def _check(x, dt, a, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3 or c.dim() != 3:
        raise ValueError(f"expected x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N]; got "
                         f"{tuple(x.shape)} {tuple(dt.shape)} {tuple(a.shape)} "
                         f"{tuple(b.shape)} {tuple(c.shape)}")
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bs, s, h) or a.shape != (h,) or b.shape != (bs, s, n) or c.shape != b.shape:
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)} do not fit x {tuple(x.shape)}")
    if min(bs, s, h) < 1 or bs > 65535 or h > 65535:
        raise ValueError(f"shape {tuple(x.shape)} outside the kernel's grid")
    if p % 4 or (p > kernel.P_TILE and p % kernel.P_TILE):
        raise ValueError(f"head dim P = {p} must be a multiple of 4, and of "
                         f"{kernel.P_TILE} above {kernel.P_TILE}")
    if n % 4 or not 4 <= n <= kernel.MAX_STATE:
        raise ValueError(f"state size N = {n} must be a multiple of 4 in "
                         f"[4, {kernel.MAX_STATE}]")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
        raise ValueError("x, dt, a, b, c on different devices")
    if x.dtype not in kernel.DTYPES or not (x.dtype == b.dtype == c.dtype):
        raise TypeError(f"the kernel takes float32 or bfloat16 x/b/c of one dtype; got "
                        f"{x.dtype} {b.dtype} {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32; got {dt.dtype} {a.dtype}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def ssd(x, dt, a, b, c, *, chunk: int = 256):
    """x [B,S,H,P]; dt [B,S,H] (softplus'ed, positive, fp32); a [H] (negative,
    fp32); b/c [B,S,N] -> (y [B,S,H,P] in ``x.dtype``, final state [B,H,P,N]
    fp32), from a zero state.  Any S >= 1."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, b, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        raise NotImplementedError(
            "ssd has no backward on the card yet (ROADMAP B4): call it under "
            "torch.no_grad(), or on CPU tensors for the differentiable plain version")
    _check(x, dt, a, b, c)
    bs, _, h, p = x.shape
    y = torch.empty_like(x)
    state = torch.empty((bs, h, p, b.shape[-1]), dtype=torch.float32, device=x.device)
    kernel.launch(x, dt, a, b, c, y, state)
    return y, state
