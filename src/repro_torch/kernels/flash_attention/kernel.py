"""ctypes binding of the hand-written CUDA flash attention kernels
(``csrc/flash_attention.cu``): the forward, the Hopper counterpart of the
JAX package's Pallas ``_flash_kernel``, and the backward, which replaces the
JAX package's custom VJP (``BWD_REPLACES``).  The library is built at first
use; ``launches`` counts the forward's launches and ``bwd_launches`` the
backward's since each was last set to 0."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:31"
BWD_REPLACES = "src/repro/kernels/flash_attention/ops.py:41"  # _flash_bwd, jax.vjp of the reference
HEAD_DIMS = (32, 64, 80, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROW_PAD = 128  # the backward's fp32 scratch rows are padded to a multiple of this

launches = 0
bwd_launches = 0
_built: build.Built | None = None


def bind(built: build.Built) -> build.Built:
    """Declare the C interface of a built library and keep it for launches."""
    global _built
    fn = built.lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    bwd = built.lib.flash_attention_bwd
    bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 24
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    built.lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    built.lib.flash_attention_error_string.restype = ctypes.c_char_p
    _built = built
    return built


def load() -> build.Built:
    """The built library, compiling it on the first call."""
    return _built if _built is not None else bind(build.build("flash_attention", SOURCE))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _strides(t) -> list[int]:
    return [0, 0, 0] if t is None else [t.stride(i) for i in (0, 1, 2)]


def launch(q, k, v, o, lse, *, causal: bool, window: int, scale: float) -> None:
    """Launch the forward on the current stream: q/o [B, S, H, D], k/v
    [B, Skv, KV, D], and lse [B, H, S] fp32 contiguous or None (not
    written), all on one CUDA device and already checked by
    ``ops.flash_attention``.  Raises if the launch is refused."""
    global launches
    lib = load().lib
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    strides = [st for t in (q, k, v, o) for st in _strides(t)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse),
            *strides, b, h, kv, s, skv, d, float(scale), int(causal), int(window), stream,
        )
    _raise_on(lib, rc, "flash_attention")
    launches += 1


def scratch_rows(s: int) -> int:
    """Rows of the backward's scratch for a sequence of ``s`` rows."""
    return -(-s // ROW_PAD) * ROW_PAD


def launch_bwd(q, k, v, o, lse, do, dq, dk, dv, scratch, *, causal: bool, window: int,
               scale: float) -> None:
    """Launch the backward on the current stream: q, k, v, o and lse as the
    forward took and wrote them, do [B, S, H, D] the cotangent of o; dq
    [B, S, H, D] and dk/dv [B, Skv, KV, D] its outputs in q's dtype, each
    None if not asked for (dq None: not computed; dk or dv None: not
    stored); ``scratch`` fp32 [2, B, H, scratch_rows(S)].  All on one CUDA
    device, already checked by ``ops``.  Raises if the launch is refused."""
    global bwd_launches
    lib = load().lib
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    strides = [st for t in (q, k, v, o, do, dq, dk, dv) for st in _strides(t)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), _ptr(dq), _ptr(dk), _ptr(dv),
            scratch[0].data_ptr(), scratch[1].data_ptr(), *strides, b, h, kv, s, skv, d,
            scratch.shape[-1], float(scale), int(causal), int(window), stream,
        )
    _raise_on(lib, rc, "flash_attention backward")
    bwd_launches += 1


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed ({rc}): {msg}")
