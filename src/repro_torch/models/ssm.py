"""Mamba-2 (SSD -- state-space duality) layer [arXiv:2405.21060].

Counterpart of the JAX package's ``models/ssm.py``.  The recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ;   y_t = C_t^T h_t + D x_t

with a scalar A per head (the SSD restriction) runs in two ways:

  * prefill and training: the whole sequence at once through
    ``kernels.ssd_scan`` -- the hand-written chunked-scan kernel on the card
    (its backward a hand-written kernel too), its plain chunked version on
    the CPU (``kernels/ssd_scan/ref.py::ssd_chunked``, the port of the
    reference's ``ssd_chunked``, in chunks of ``cfg.ssm.chunk_size``),
    differentiable either way;
  * decode: one token per row, in plain PyTorch (``ssd_step``), as the JAX
    package keeps it in XLA.

The input projections to z/x/B/C/dt are separate weight matrices and the
causal depthwise conv runs per part, as in the reference, so weights cross
the bridge unchanged.  Decode keeps O(1) state per layer: conv ring buffers
``conv_x``/``conv_b``/``conv_c`` [B, W-1, C] in the compute dtype and
``h`` [B, H, P, N] in fp32; a decode step writes them in place.

On a mesh whose ``model`` axis splits ``d_inner`` (the sharding rules'
``ff``), tensor parallelism runs per part: rank ``j`` holds its block of
the channels of ``w_z``, ``w_x``, ``conv_wx``, ``conv_bx`` and ``norm``
(those of its ``H/m`` heads, ``[j H/m, (j+1) H/m)``) and its rows of
``w_out``, whose partial outputs are summed over ``model``.  ``w_dt``,
``a_log``, ``d_skip`` and ``dt_bias`` are whole on every rank, which takes
its heads' slice; B and C (one group) are computed whole on every rank.
The gated RMS norm over ``d_inner`` spans the ranks: its sum of squares is
summed over ``model`` before the scale.  The rank's cache holds its
channels of ``conv_x`` and its heads of ``h``; the SSD scan runs on its
heads.

In training the backward follows ``core/collectives.py``'s convention:
``x``, the whole ``x @ w_dt``, B and C after their convolutions, and
``a_log``, ``dt_bias`` and ``d_skip`` are read through ``replicate`` where
the rank takes its heads' part of them, and so is the norm's sum of
squares, which every rank scales its own channels by; the SSD kernel runs
forward and backward on the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan.ref import ssd_chunked as _ssd_chunked_heads
from ..core import collectives as col
from ..runtime.sharding import model_split_dim
from .layers import dense_init, model_axis, rms_norm, zeros_init

__all__ = ["ssm_init", "ssm_apply", "init_ssm_cache", "ssd_chunked", "ssd_step", "softplus"]


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    """(d_inner, n_heads)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


SSM_AXES = {"w_z": ("embed", "ff"), "w_x": ("embed", "ff"), "w_b": ("embed", None),
            "w_c": ("embed", None), "w_dt": ("embed", None), "conv_wx": (None, "ff"),
            "conv_wb": (None, None), "conv_wc": (None, None), "conv_bx": ("ff",),
            "conv_bb": (None,), "conv_bc": (None,), "a_log": (None,), "d_skip": (None,),
            "dt_bias": (None,), "norm": ("ff",), "w_out": ("ff", "embed")}


def _local_heads(cfg: ModelConfig, mesh) -> tuple:
    """(the mesh where the rules split the ``ff`` (d_inner) leaves over its
    model axis else None, first head, number of heads) of this rank."""
    d_inner, nh = _dims(cfg)
    if model_split_dim(SSM_AXES["w_x"], (cfg.d_model, d_inner), mesh) is None:
        return None, 0, nh
    m, j = model_axis(mesh)
    if nh % m:
        raise NotImplementedError(f"{cfg.name}: {nh} SSM heads do not split over a model "
                                  f"axis of {m}")
    return mesh, j * (nh // m), nh // m


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    """Parameters of one SSM mixer, the reference's shapes and constants."""
    c = cfg.ssm
    d = cfg.d_model
    d_inner, nh = _dims(cfg)
    dev = gen.device
    return {
        "w_z": dense_init(gen, (d, d_inner), dtype),
        "w_x": dense_init(gen, (d, d_inner), dtype),
        "w_b": dense_init(gen, (d, c.state_dim), dtype),
        "w_c": dense_init(gen, (d, c.state_dim), dtype),
        "w_dt": dense_init(gen, (d, nh), dtype),
        "conv_wx": dense_init(gen, (c.conv_width, d_inner), dtype, scale=0.5),
        "conv_wb": dense_init(gen, (c.conv_width, c.state_dim), dtype, scale=0.5),
        "conv_wc": dense_init(gen, (c.conv_width, c.state_dim), dtype, scale=0.5),
        "conv_bx": zeros_init(gen, (d_inner,), dtype),
        "conv_bb": zeros_init(gen, (c.state_dim,), dtype),
        "conv_bc": zeros_init(gen, (c.state_dim,), dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)).to(dtype),
        "d_skip": torch.ones((nh,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.linspace(c.dt_min, c.dt_max, nh, device=dev)))
        .to(dtype),
        "norm": zeros_init(gen, (d_inner,), dtype),
        "w_out": dense_init(gen, (d_inner, d), dtype),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None,
                   mesh=None) -> dict:
    """Zero state; on a mesh, of this rank's channels and heads."""
    c = cfg.ssm
    _, _, nh = _local_heads(cfg, mesh)
    d_inner = nh * c.head_dim
    return {
        "conv_x": torch.zeros((batch, c.conv_width - 1, d_inner), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, c.conv_width - 1, c.state_dim), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, c.conv_width - 1, c.state_dim), dtype=dtype, device=device),
        "h": torch.zeros((batch, nh, c.head_dim, c.state_dim), dtype=torch.float32,
                         device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_depthwise_conv(x, w, bias, compute):
    """x [B,S,C]; w [W,C]; causal, silu activation.  Returns (out [B,S,C],
    the last W-1 input rows, zeros before the prompt, for the decode ring).
    The rows are a copy: a view would keep the whole padded input alive
    while the stack gathers every layer's cache."""
    bsz, s, ch = x.shape
    width = w.shape[0]
    padded = torch.cat([torch.zeros((bsz, width - 1, ch), dtype=compute, device=x.device), x], 1)
    out = sum(padded[:, i : i + s] * w[i][None, None, :] for i in range(width))
    return F.silu(out + bias.to(compute)), padded[:, -(width - 1):].clone() if width > 1 else None


def _conv_step(hist, new, w, bias, compute):
    """hist [B,W-1,C] ring; new [B,1,C] -> (out [B,C], new ring)."""
    full = torch.cat([hist.to(compute), new], dim=1)  # [B,W,C]
    out = (full * w[None]).sum(dim=1) + bias.to(compute)
    return F.silu(out), full[:, 1:]


def ssd_chunked(x, dt, a, b, c, chunk: int, h0=None, head_group: int = 8):
    """The plain chunked SSD scan with the reference's signature: x
    [B,S,H,P]; dt [B,S,H] (positive); a [H] (negative); b/c [B,S,N]; h0
    [B,H,P,N] or None (zeros) -> (y [B,S,H,P] in ``x.dtype``, h_final
    [B,H,P,N] fp32).  Heads run in groups of ``head_group`` (lowered to a
    divisor of H, as there), each through ``kernels/ssd_scan/ref.py::
    ssd_chunked``, which bounds the [B,H,Q,Q] decay tensor; every head's
    arithmetic is its own, so the result does not depend on ``head_group``.
    The sequence need not be a multiple of ``chunk``."""
    nh = x.shape[2]
    hg = min(head_group, nh)
    while nh % hg:
        hg -= 1
    parts = [_ssd_chunked_heads(x[:, :, g:g + hg], dt[:, :, g:g + hg], a[g:g + hg], b, c,
                                chunk, None if h0 is None else h0[:, g:g + hg])
             for g in range(0, nh, hg)]
    return torch.cat([y for y, _ in parts], dim=2), torch.cat([h for _, h in parts], dim=1)


def ssd_step(h, xt, dtt, a, bt, ct):
    """One decode step.  h [B,H,P,N]; xt [B,H,P]; dtt [B,H]; bt/ct [B,N] ->
    (y [B,H,P] fp32, h_next)."""
    g = torch.exp(dtt.float() * a.float()[None, :])  # [B,H]
    u = xt.float() * dtt.float()[..., None]
    h_next = h * g[:, :, None, None] + torch.einsum("bhp,bn->bhpn", u, bt.float())
    y = torch.einsum("bhpn,bn->bhp", h_next, ct.float())
    return y, h_next


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float,
                d_inner: int, mesh) -> torch.Tensor:
    """``rms_norm(y * silu(z))`` over ``d_inner`` channels, of which ``y``
    holds the rank's; with ``mesh`` the sum of squares is summed over
    ``model``."""
    g = y * F.silu(z)
    if mesh is None:
        return rms_norm(g, scale, eps)
    xf = g.float()
    # every rank scales its own channels by the sum: its gradient sums too
    ss = col.psum(xf.square().sum(dim=-1, keepdim=True), "model", mesh=mesh)
    var = col.replicate(ss, "model", mesh=mesh) / d_inner
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(g.dtype)


def ssm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *, cache: dict | None = None,
              update_cache: bool = False, mesh=None):
    """x [B,S,D] -> (out [B,S,D], cache).  Without ``cache`` (prefill) the
    whole sequence runs through the SSD scan from a zero state, and with
    ``update_cache`` the new decode state comes back.  With ``cache``
    (decode, S == 1) the state advances one token and is written into
    ``cache`` in place; the same dict comes back.  On a mesh the params
    are this rank's blocks and the heads its own (see the module's doc)."""
    c = cfg.ssm
    compute = x.dtype
    bsz, s, d = x.shape
    d_full, _ = _dims(cfg)
    tp, h0, nh = _local_heads(cfg, mesh)
    d_inner = nh * c.head_dim
    heads = slice(h0, h0 + nh)
    w = {k: params[k].to(compute) for k in ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_out",
                                            "conv_wx", "conv_wb", "conv_wc")}
    # rank-local work reads x and the per-head leaves whole (module doc)
    rep = lambda t: col.replicate(t, "model", mesh=tp)  # noqa: E731

    xr = rep(x)
    z = xr @ w["w_z"]
    xin = xr @ w["w_x"]
    braw = x @ w["w_b"]
    craw = x @ w["w_c"]
    dt = rep(x @ w["w_dt"])[..., heads]
    a = -torch.exp(rep(params["a_log"])[heads].float())
    dt_bias = rep(params["dt_bias"])[heads].float()

    if cache is None:
        xc, tail_x = _causal_depthwise_conv(xin, w["conv_wx"], params["conv_bx"], compute)
        bc, tail_b = _causal_depthwise_conv(braw, w["conv_wb"], params["conv_bb"], compute)
        cc, tail_c = _causal_depthwise_conv(craw, w["conv_wc"], params["conv_bc"], compute)
        dtp = softplus(dt.float() + dt_bias)
        y, h_final = ssd_ops.ssd(xc.reshape(bsz, s, nh, c.head_dim), dtp, a, rep(bc), rep(cc),
                                 chunk=c.chunk_size)
        new_cache = None
        if update_cache:
            new_cache = {"conv_x": tail_x, "conv_b": tail_b, "conv_c": tail_c, "h": h_final}
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        xc, hist_x = _conv_step(cache["conv_x"], xin, w["conv_wx"], params["conv_bx"], compute)
        bc, hist_b = _conv_step(cache["conv_b"], braw, w["conv_wb"], params["conv_bb"], compute)
        cc, hist_c = _conv_step(cache["conv_c"], craw, w["conv_wc"], params["conv_bc"], compute)
        dtp = softplus(dt[:, 0].float() + dt_bias)
        y, h_next = ssd_step(cache["h"], xc.reshape(bsz, nh, c.head_dim), dtp, a, bc, cc)
        y = y[:, None]  # [B,1,H,P]
        for name, t in (("conv_x", hist_x), ("conv_b", hist_b), ("conv_c", hist_c),
                        ("h", h_next)):
            cache[name].copy_(t)
        new_cache = cache

    y = y + xin.reshape(bsz, s, nh, c.head_dim).float() * rep(params["d_skip"])[heads].float(
        ).reshape(1, 1, nh, 1)
    y = y.reshape(bsz, s, d_inner).to(compute)
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps, d_full, tp)
    out = y @ w["w_out"]
    return (out if tp is None else col.psum(out, "model", mesh=tp)), new_cache
