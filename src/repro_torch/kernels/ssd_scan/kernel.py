"""ctypes binding of the hand-written CUDA SSD chunked scan
(``csrc/ssd_scan.cu``), the Hopper counterpart of the JAX package's Pallas
``_ssd_kernel``, and of its backward, which replaces the JAX package's
custom VJP (``BWD_REPLACES``).  The library holds two routes in each
direction, and ``route`` (forward) and ``bwd_route`` (backward) say which
one a launch takes.  It is built at first use; ``launches`` counts the
forward's launches and ``bwd_launches`` the backward's since each was last
set to 0, and ``bwd_wgmma_launches`` those of the backward's that took the
wgmma route."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan/kernel.py:28"
BWD_REPLACES = "src/repro/kernels/ssd_scan/ops.py:25"  # _ssd_bwd, jax.vjp of reference_ssd
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64  # the kernel's chunk of rows (kQ in the source)
MAX_STATE = 128  # largest N (kMaxN)
P_TILE = 32  # columns of P per block (kMaxPT)

MAX_GROUP = 8  # heads per block of the backward's wgmma route (kMaxG)

launches = 0
bwd_launches = 0
bwd_wgmma_launches = 0
_built: build.Built | None = None


def route(dtype: torch.dtype, p: int, n: int) -> str:
    """The kernel of the library a launch at head dim ``p`` and state size
    ``n`` takes: "wgmma" (tensor cores, tiles by TMA) for bfloat16 with P and
    N multiples of 8, whose rows TMA can address; "fma" (fp32 FMA units) for
    float32 and for the other bfloat16 shapes."""
    return "wgmma" if dtype == torch.bfloat16 and p % 8 == 0 and n % 8 == 0 else "fma"


def bwd_route(dtype: torch.dtype, p: int, n: int) -> str:
    """The backward's kernels at head dim ``p`` and state size ``n``:
    "wgmma" (tensor cores, tiles by TMA) for bfloat16 with P and N multiples
    of 8 and P at most 64 (one tile of x a chunk); "fma" (fp32 FMA units)
    for float32 and the other bfloat16 shapes."""
    return "wgmma" if route(dtype, p, n) == "wgmma" and p <= 64 else "fma"


def bwd_parts(way: str, h: int) -> int:
    """The backward's partials of dB and dC per row on route ``way``: one
    per head on the FMA route; on the wgmma route one per block's group of
    heads, the largest of 8, 4, 2 and 1 that divides H."""
    if way == "fma":
        return h
    return h // next(g for g in (MAX_GROUP, 4, 2, 1) if h % g == 0)


def bind(built: build.Built) -> build.Built:
    """Declare the C interface of a built library and keep it for launches."""
    global _built
    fn = built.lib.ssd_scan_fwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bwd = built.lib.ssd_scan_bwd
    bwd.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
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
    _raise_on(lib, rc, "ssd_scan")
    launches += 1


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch_bwd(x, dt, a, b, c, dy, dstate, scratch: dict, grads: dict, way: str) -> None:
    """Launch the backward on the current stream, on route ``way`` (which
    ``bwd_route`` chooses; "fma" takes every shape): the inputs as
    ``launch`` takes them, dy [B, S, H, P] in x's dtype and dstate
    [B, H, P, N] fp32 or None (zeros); ``scratch`` holds "states" and
    "dstates" [B, H, NC, P, N] and, beside each gradient of b, c and a that
    is asked for, "db_part", "dc_part" [B, S, bwd_parts(way, H), N] and
    "da_part" [B, NC, H], all fp32; ``grads`` maps each of "dx", "ddt",
    "db", "dc", "da" to its output or None, which is not computed.  Every
    tensor contiguous on one CUDA device, already checked by ``ops``.
    Raises if the launch is refused."""
    global bwd_launches, bwd_wgmma_launches
    lib = load().lib
    bs, s, h, p = x.shape
    n = b.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_bwd(
            DTYPES[x.dtype], int(way == "wgmma"), x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), dy.data_ptr(), _ptr(dstate),
            scratch["states"].data_ptr(), scratch["dstates"].data_ptr(),
            *(_ptr(grads[k]) for k in ("dx", "ddt")),
            *(_ptr(scratch.get(k)) for k in ("db_part", "dc_part", "da_part")),
            *(_ptr(grads[k]) for k in ("db", "dc", "da")), bs, s, h, p, n,
            bwd_parts(way, h), stream)
    _raise_on(lib, rc, "ssd_scan backward")
    bwd_launches += 1
    bwd_wgmma_launches += int(way == "wgmma")


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed ({rc}): {msg}")
