"""ctypes binding of the hand-written CUDA grouped expert matmul
(``csrc/moe_gmm.cu``), the Hopper counterpart of the JAX package's Pallas
``_gmm_kernel``: the forward product and both backward ones, each operand
read through its strides.  The library is built at first use; ``launches``
counts the launches since it was last set to 0."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
REPLACES = "src/repro/kernels/moe_gmm/kernel.py:23"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_built: build.Built | None = None


def bind(built: build.Built) -> build.Built:
    """Declare the C interface of a built library and keep it for launches."""
    global _built
    fn = built.lib.moe_gmm
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    built.lib.moe_gmm_error_string.argtypes = [ctypes.c_int]
    built.lib.moe_gmm_error_string.restype = ctypes.c_char_p
    _built = built
    return built


def load() -> build.Built:
    """The built library, compiling it on the first call."""
    return _built if _built is not None else bind(build.build("moe_gmm", SOURCE))


def launch(a, b, out) -> None:
    """Launch the kernel on the current stream: out [E, M, N] = a [E, M, K]
    @ b [E, K, N], all on one CUDA device and already checked by ``ops``
    (of each operand's last two dims one is contiguous; out is contiguous in
    N).  Raises if the launch is refused."""
    global launches
    lib = load().lib
    e, m, k = a.shape
    n = b.shape[2]
    strides = [*a.stride(), *b.stride(), out.stride(0), out.stride(1)]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.moe_gmm(DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         *strides, e, m, k, n, stream)
    if rc != 0:
        msg = lib.moe_gmm_error_string(rc).decode()
        raise RuntimeError(f"moe_gmm kernel launch failed ({rc}): {msg}")
    launches += 1
