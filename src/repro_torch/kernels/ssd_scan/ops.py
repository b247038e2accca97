"""Public SSD chunked-scan wrapper, differentiable.

On a CPU tensor ``ssd`` computes the plain PyTorch version (``ref.py``) in
chunks of ``chunk`` rows, and autograd differentiates it.  On a CUDA tensor
it is an autograd function whose forward launches the hand-written kernel
(``csrc/ssd_scan.cu``), which takes chunks of its own size
(``kernel.CHUNK``; the result does not depend on the chunk), and whose
backward launches the hand-written backward kernel of the same library, or
raises: there is no fallback.  The forward dispatches by dtype
(``kernel.route``): bfloat16 x/b/c run on the tensor cores with the fp32
factors split into two bf16 terms, float32 on the FMA units.  The backward
dispatches by ``kernel.bwd_route``: bfloat16 with P at most 64 and P and N
multiples of 8 (every shape a model gives it) on the tensor cores, its fp32
factors in two bf16 terms as the forward's, and float32 and the other
bfloat16 shapes in fp32 on the FMA units.  Either works from the saved
inputs, as the JAX package's custom VJP (``_ssd_bwd``) recomputes through
the sequential ``reference_ssd``: it recomputes each chunk's entry state
and stores no residuals of the forward.  Its plain version is autograd
through ``ssd_chunked``, which the tests and ``chip_smoke.py`` hold it
against.
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


def _cotangent(g, dtype):
    """``g`` as the kernel reads it: in ``dtype`` and contiguous.  Autograd
    hands a contiguous one in the model; a gradient broadcast from a
    reduction (``ssd(...)[0].sum()`` hands over a stride-0 expand) is
    copied, the only case."""
    g = g.to(dtype)
    return g if g.is_contiguous() else g.contiguous()


def _backward(x, dt, a, b, c, gy, gstate, need, way: str | None = None):
    """The backward kernel's (dx, ddt, da, db, dc) for the cotangents ``gy``
    (None: zeros) and ``gstate`` (None: zeros) of ``ssd``'s outputs, each
    None where ``need`` (five booleans) does not ask for it, on route
    ``way`` (default ``kernel.bwd_route``).  One launch; the scratch is
    allocated here and freed on return."""
    gy = torch.zeros_like(x) if gy is None else _cotangent(gy, x.dtype)
    if gstate is not None:
        gstate = _cotangent(gstate, torch.float32)
    bs, s, h, p = x.shape
    n, nc = b.shape[-1], -(-s // kernel.CHUNK)
    way = way or kernel.bwd_route(x.dtype, p, n)
    need = dict(zip(("dx", "ddt", "da", "db", "dc"), need))
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = {"states": torch.empty((bs, h, nc, p, n), **f32),
               "dstates": torch.empty((bs, h, nc, p, n), **f32)}
    parts = kernel.bwd_parts(way, h)
    for name, shape in (("db", (bs, s, parts, n)), ("dc", (bs, s, parts, n)),
                        ("da", (bs, nc, h))):
        if need[name]:
            scratch[f"{name}_part"] = torch.empty(shape, **f32)
    inputs = dict(zip(("dx", "ddt", "da", "db", "dc"), (x, dt, a, b, c)))
    grads = {k: torch.empty_like(inputs[k]) if need[k] else None for k in inputs}
    kernel.launch_bwd(x, dt, a, b, c, gy, gstate, scratch, grads, way)
    return grads["dx"], grads["ddt"], grads["da"], grads["db"], grads["dc"]


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        ctx.save_for_backward(x, dt, a, b, c)
        bs, _, h, p = x.shape
        y = torch.empty_like(x)
        state = torch.empty((bs, h, p, b.shape[-1]), dtype=torch.float32, device=x.device)
        kernel.launch(x, dt, a, b, c, y, state)
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        return _backward(*ctx.saved_tensors, gy, gstate, ctx.needs_input_grad)


def ssd(x, dt, a, b, c, *, chunk: int = 256):
    """x [B,S,H,P]; dt [B,S,H] (softplus'ed, positive, fp32); a [H] (negative,
    fp32); b/c [B,S,N] -> (y [B,S,H,P] in ``x.dtype``, final state [B,H,P,N]
    fp32), from a zero state.  Any S >= 1.  Differentiable in every input;
    the gradients come back in the inputs' dtypes."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, b, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cpu or cuda, not {x.device}")
    _check(x, dt, a, b, c)
    return _SSD.apply(x, dt, a, b, c)
