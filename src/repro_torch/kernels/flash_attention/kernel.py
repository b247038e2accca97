"""ctypes binding of the hand-written CUDA flash attention kernel
(``csrc/flash_attention.cu``), the Hopper counterpart of the JAX package's
Pallas ``_flash_kernel``.  The library is built at first use; ``launches``
counts the launches since it was last set to 0."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:31"
HEAD_DIMS = (32, 64, 80, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_built: build.Built | None = None


def bind(built: build.Built) -> build.Built:
    """Declare the C interface of a built library and keep it for launches."""
    global _built
    fn = built.lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    built.lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    built.lib.flash_attention_error_string.restype = ctypes.c_char_p
    _built = built
    return built


def load() -> build.Built:
    """The built library, compiling it on the first call."""
    return _built if _built is not None else bind(build.build("flash_attention", SOURCE))


def launch(q, k, v, o, *, causal: bool, window: int, scale: float) -> None:
    """Launch the kernel on the current stream: q/o [B, S, H, D], k/v
    [B, Skv, KV, D], all on one CUDA device and already checked by
    ``ops.flash_attention``.  Raises if the launch is refused."""
    global launches
    lib = load().lib
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *strides, b, h, kv, s, skv, d, float(scale), int(causal), int(window), stream,
        )
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed ({rc}): {msg}")
    launches += 1
