"""Plain PyTorch versions of the Mamba-2 SSD scan: the CPU path of
``ops.ssd`` and the oracle the CUDA kernel is held against on the card.

``reference_ssd`` is the literal per-timestep recurrence (the JAX package's
``ssd_scan/ref.py``)::

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T ;   y_t = h_t C_t

``ssd_chunked`` is the chunked schedule the JAX package's Pallas
``_ssd_kernel`` computes, one chunk of Q rows after another with an fp32
state ``S [P, N]`` per (batch, head)::

    cum = cumsum(dt a)                             [Q]
    G   = tril(C B^T * exp(cum_i - cum_j))         [Q, Q]  (mask in the exponent)
    y   = G u + exp(cum) * (C S^T),  u = x dt      [Q, P]
    S  <- exp(cum_Q) S + (exp(cum_Q - cum) u)^T B  [P, N]

The last chunk may be shorter than ``chunk``, so any S is taken: a short
chunk is the same algebra as a full one padded with ``dt = 0`` rows (decay
1, ``u`` 0).  The result does not depend on ``chunk``.
"""

from __future__ import annotations

import torch

__all__ = ["reference_ssd", "ssd_chunked"]


def reference_ssd(x, dt, a, b, c, h0=None):
    """x [B,S,H,P]; dt [B,S,H]; a [H]; b/c [B,S,N]; h0 [B,H,P,N] or None ->
    (y [B,S,H,P] in ``x.dtype``, h [B,H,P,N] fp32)."""
    bs, s, nh, p = x.shape
    n = b.shape[-1]
    xf, dtf, af, bf, cf = (t.float() for t in (x, dt, a, b, c))
    h = h0.float() if h0 is not None else x.new_zeros((bs, nh, p, n), dtype=torch.float32)
    ys = []
    for t in range(s):
        g = torch.exp(dtf[:, t] * af[None, :])  # [B,H]
        u = xf[:, t] * dtf[:, t][..., None]  # [B,H,P]
        h = h * g[:, :, None, None] + torch.einsum("bhp,bn->bhpn", u, bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked(x, dt, a, b, c, chunk: int, h0=None):
    """Chunked SSD scan, fp32 state math: x [B,S,H,P]; dt [B,S,H] (positive);
    a [H] (negative); b/c [B,S,N] (one group for all heads); h0 [B,H,P,N] or
    None (zeros) -> (y [B,S,H,P] in ``x.dtype``, h_final [B,H,P,N] fp32)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    bs, s, nh, p = x.shape
    n = b.shape[-1]
    xh = x.float().permute(0, 2, 1, 3)  # [B,H,S,P]
    dth = dt.float().permute(0, 2, 1)  # [B,H,S]
    af = a.float()[None, :, None]
    bf, cf = b.float(), c.float()
    state = h0.float() if h0 is not None else x.new_zeros((bs, nh, p, n), dtype=torch.float32)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, min(t0 + chunk, s))
        q = sl.stop - t0
        dtc = dth[..., sl]  # [B,H,Q]
        cum = torch.cumsum(dtc * af, dim=-1)
        u = xh[:, :, sl] * dtc[..., None]  # [B,H,Q,P]
        bc, cc = bf[:, sl], cf[:, sl]  # [B,Q,N]
        mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        # mask the exponent: the upper triangle would overflow
        diff = torch.where(mask, cum[..., :, None] - cum[..., None, :], float("-inf"))
        g = (cc @ bc.transpose(1, 2))[:, None] * torch.exp(diff)  # [B,H,Q,Q]
        y = g @ u + torch.exp(cum)[..., None] * (cc[:, None] @ state.transpose(-1, -2))
        tail = torch.exp(cum[..., -1:] - cum)  # [B,H,Q]
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + (u * tail[..., None]).transpose(-1, -2) @ bc[:, None])
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)  # [B,S,H,P]
    return y.to(x.dtype), state
