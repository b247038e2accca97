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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ops as ssd_ops
from .layers import dense_init, rms_norm, zeros_init

__all__ = ["ssm_init", "ssm_apply", "init_ssm_cache", "ssd_step", "softplus"]


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    """(d_inner, n_heads)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


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


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    c = cfg.ssm
    d_inner, nh = _dims(cfg)
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


def ssd_step(h, xt, dtt, a, bt, ct):
    """One decode step.  h [B,H,P,N]; xt [B,H,P]; dtt [B,H]; bt/ct [B,N] ->
    (y [B,H,P] fp32, h_next)."""
    g = torch.exp(dtt.float() * a.float()[None, :])  # [B,H]
    u = xt.float() * dtt.float()[..., None]
    h_next = h * g[:, :, None, None] + torch.einsum("bhp,bn->bhpn", u, bt.float())
    y = torch.einsum("bhpn,bn->bhp", h_next, ct.float())
    return y, h_next


def ssm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *, cache: dict | None = None,
              update_cache: bool = False):
    """x [B,S,D] -> (out [B,S,D], cache).  Without ``cache`` (prefill) the
    whole sequence runs through the SSD scan from a zero state, and with
    ``update_cache`` the new decode state comes back.  With ``cache``
    (decode, S == 1) the state advances one token and is written into
    ``cache`` in place; the same dict comes back."""
    c = cfg.ssm
    compute = x.dtype
    bsz, s, d = x.shape
    d_inner, nh = _dims(cfg)
    w = {k: params[k].to(compute) for k in ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_out",
                                            "conv_wx", "conv_wb", "conv_wc")}

    z = x @ w["w_z"]
    xin = x @ w["w_x"]
    braw = x @ w["w_b"]
    craw = x @ w["w_c"]
    dt = x @ w["w_dt"]
    a = -torch.exp(params["a_log"].float())

    if cache is None:
        xc, tail_x = _causal_depthwise_conv(xin, w["conv_wx"], params["conv_bx"], compute)
        bc, tail_b = _causal_depthwise_conv(braw, w["conv_wb"], params["conv_bb"], compute)
        cc, tail_c = _causal_depthwise_conv(craw, w["conv_wc"], params["conv_bc"], compute)
        dtp = softplus(dt.float() + params["dt_bias"].float())
        y, h_final = ssd_ops.ssd(xc.reshape(bsz, s, nh, c.head_dim), dtp, a, bc, cc,
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
        dtp = softplus(dt[:, 0].float() + params["dt_bias"].float())
        y, h_next = ssd_step(cache["h"], xc.reshape(bsz, nh, c.head_dim), dtp, a, bc, cc)
        y = y[:, None]  # [B,1,H,P]
        for name, t in (("conv_x", hist_x), ("conv_b", hist_b), ("conv_c", hist_c),
                        ("h", h_next)):
            cache[name].copy_(t)
        new_cache = cache

    y = y + xin.reshape(bsz, s, nh, c.head_dim).float() * params["d_skip"].float().reshape(
        1, 1, nh, 1)
    y = y.reshape(bsz, s, d_inner).to(compute)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ w["w_out"], new_cache
