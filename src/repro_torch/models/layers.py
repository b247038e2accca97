"""Basic layers: norms, rotary embeddings, gated MLP, initialisers.

Counterpart of the JAX package's ``models/layers.py``.  Parameters are plain
dicts of tensors laid out as there (``x @ w`` with ``w`` of shape
``[in, out]``), so that weights cross the bridge unchanged.  Initialisers take
an explicit ``torch.Generator`` and draw from the same distributions as the
JAX ones; the numbers differ, since the generators do.

On a mesh with a ``model`` axis (``launch/mesh.py``) a rank holds the block
of each weight that ``runtime/sharding.py``'s rules give it, and the
activations between layers are whole on every rank.  The gated MLP is then
column-parallel over ``ff`` (``w_gate``, ``w_up``) and row-parallel
(``w_down``), its partial outputs summed over ``model``; the embedding is
vocab-parallel (a masked lookup of the rank's rows, then the sum, exact:
one row and zeros); the logits are the rank's vocab columns, gathered
over ``model`` (``gather_vocab``).  In training the backward follows
``core/collectives.py``'s convention: the input of each column-parallel
product is read through ``replicate``, the embedding's gradient lands in
the rank's rows only, and the logits' gradient is the rank's columns of
the whole one.  Which weights are the rank's blocks
is the rules' answer (``sharding.model_split_dim`` of the leaf's axes and
whole shape); a weight they leave whole is used whole, with no
collective.  The sums are ``psum``'s:
each element summed once, in rank order, so that every rank holds the
same bits.  The reference's ``constrain_ff_hidden`` is a layout hint to
its compiler with no numeric effect; this layout is its counterpart.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import collectives as col
from ..runtime.sharding import model_split_dim

__all__ = [
    "dense_init",
    "embed_init",
    "rms_norm",
    "layer_norm",
    "rope_frequencies",
    "apply_rope",
    "swiglu",
    "mlp_init",
    "mlp_apply",
    "cross_entropy_loss",
]


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated normal (+-2 sigma) with fan-in std, on ``gen``'s device."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


def zeros_init(gen: torch.Generator, shape: tuple[int, ...], dtype=torch.float32):
    """Norm scales start at zero (``rms_norm`` scales by ``1 + scale``)."""
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 over the last axis: ``(x - mean) / sqrt(var + eps)
    * scale + bias``, back in ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings (half of head_dim)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Half-split
    rotation computed in fp32."""
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * inv  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


MLP_AXES = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"), "w_down": ("ff", "embed")}
EMBED_AXES = ("vocab", "embed")
LM_HEAD_AXES = ("embed", "vocab")


def model_axis(mesh) -> tuple[int, int]:
    """(size, this rank's index) of ``mesh``'s ``model`` axis; (1, 0)
    without a mesh or without that axis."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1, 0
    return mesh.axis_size("model"), mesh.axis_index("model")


def gather_vocab(logits: torch.Tensor, mesh) -> torch.Tensor:
    """[..., V/m] vocab columns of every rank of the ``model`` axis ->
    [..., V], in rank order.  Every rank uses the whole logits the same
    way, so the gradient of its columns is its slice of theirs."""
    parts = col.all_gather(logits, "model", mesh=mesh, grad="slice")  # [m, ..., V/m]
    return torch.cat(list(parts.unbind(0)), dim=-1)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, vocab: int,
                 mesh=None) -> torch.Tensor:
    """``embed[tokens]``; with a mesh whose ``model`` axis splits the vocab,
    ``embed`` is the rank's rows: tokens outside them read zeros, and the
    rows are summed over ``model``."""
    if model_split_dim(EMBED_AXES, (vocab, embed.shape[1]), mesh) is None:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - model_axis(mesh)[1] * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], embed[local.clamp(0, rows - 1)], 0)
    return col.psum(x, "model", mesh=mesh)


def mlp_apply(params: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Dense SwiGLU.  The weights are used in ``x``'s dtype; a ``.to`` is a
    no-op once the model's weights were cast at load time.  With ``mesh``
    the weights are the rank's ``ff`` block (pass it where the rules split
    ``MLP_AXES``' ``ff``: ``mlp_mesh``) and the partial outputs are summed
    over ``model``; ``x`` is read through ``replicate``, so its gradient
    sums the ranks' parts."""
    dt = x.dtype
    if mesh is not None:
        x = col.replicate(x, "model", mesh=mesh)
    h = swiglu(x @ params["w_gate"].to(dt), x @ params["w_up"].to(dt))
    out = h @ params["w_down"].to(dt)
    return out if mesh is None else col.psum(out, "model", mesh=mesh)


def mlp_mesh(d_model: int, d_ff: int, mesh):
    """``mesh`` where the rules split an MLP of these widths over ``model``
    (``mlp_apply``'s ``mesh``), else None."""
    return None if model_split_dim(MLP_AXES["w_down"], (d_ff, d_model), mesh) is None else mesh


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over the positions ``mask`` keeps, in
    fp32: logsumexp minus the gold logit, masked, over ``max(mask.sum(), 1)``.
    The gold logit is gathered; the JAX package contracts a one-hot instead
    (for vocab-sharded logits), which gives the same value in fp32 and would
    cost another [B, S, V] tensor here."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
