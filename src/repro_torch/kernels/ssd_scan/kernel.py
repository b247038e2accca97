"""ctypes binding of the hand-written CUDA SSD chunked scan
(``csrc/ssd_scan.cu``), the Hopper counterpart of the JAX package's Pallas
``_ssd_kernel``.  The library holds two kernels, and ``route`` says which one
a launch takes.  It is built at first use; ``launches`` counts the launches
since it was last set to 0."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan/kernel.py:28"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64  # the kernel's chunk of rows (kQ in the source)
MAX_STATE = 128  # largest N (kMaxN)
P_TILE = 32  # columns of P per block (kMaxPT)

launches = 0
_built: build.Built | None = None


def route(dtype: torch.dtype, p: int, n: int) -> str:
    """The kernel of the library a launch at head dim ``p`` and state size
    ``n`` takes: "wgmma" (tensor cores, tiles by TMA) for bfloat16 with P and
    N multiples of 8, whose rows TMA can address; "fma" (fp32 FMA units) for
    float32 and for the other bfloat16 shapes."""
    return "wgmma" if dtype == torch.bfloat16 and p % 8 == 0 and n % 8 == 0 else "fma"


def bind(built: build.Built) -> build.Built:
    """Declare the C interface of a built library and keep it for launches."""
    global _built
    fn = built.lib.ssd_scan_fwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    built.lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    built.lib.ssd_scan_error_string.restype = ctypes.c_char_p
    _built = built
    return built


def load() -> build.Built:
    """The built library, compiling it on the first call."""
    return _built if _built is not None else bind(build.build("ssd_scan", SOURCE))


def launch(x, dt, a, b, c, y, state) -> None:
    """Launch the kernel on the current stream: x/y [B, S, H, P], dt
    [B, S, H], a [H], b/c [B, S, N], state [B, H, P, N], all contiguous on
    one CUDA device and already checked by ``ops.ssd``.  Raises if the launch
    is refused."""
    global launches
    lib = load().lib
    bs, s, h, p = x.shape
    n = b.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(DTYPES[x.dtype], int(route(x.dtype, p, n) == "wgmma"),
                              x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                              c.data_ptr(), y.data_ptr(), state.data_ptr(), bs, s, h, p, n,
                              stream)
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed ({rc}): {msg}")
    launches += 1
