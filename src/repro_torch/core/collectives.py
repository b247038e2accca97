"""CLEX-staged collectives over the process groups of a mesh.

Counterpart of the JAX package's ``core/collectives.py``.  A multi-pod
machine is a CLEX-like hierarchy: the ``data`` axis rides the cheap
intra-pod links, the ``pod`` axis the scarce ones.  The paper's rule, push
traffic to the cheap levels and send only 1/n_low of the bytes across the
top, becomes these schedules:

* ``hierarchical_all_reduce``: reduce-scatter over the low axes,
  all-reduce only the shard across the high axis (optionally int8 with
  error feedback), all-gather back over the low axes;
* ``compressed_psum``: int8 quantisation of the top-level traffic;
* ``two_stage_all_to_all``: the A(2) recursion, an all-to-all inside the
  clique to the gateway, then one across the bundle.

Each function takes the reference's arguments and then a keyword-only
``mesh`` (``launch/mesh.py``) whose process groups the axis names select;
where the reference runs inside a ``shard_map`` region, every rank of the
mesh calls the function with its own tensors.  The tensor layouts and
orders are the reference's: a reduce-scatter leaves shard ``i`` on the rank
whose coordinate on the axis is ``i``, a leaf whose size does not divide is
zero-padded at the end, and a group over several axes is ordered row-major
(``pod`` major, ``data`` minor).

The process groups take the tensors where they lie: NCCL the card's, gloo
(the CPU's backend, and the card's when several ranks share it) the CPU's
and the card's, which it copies through the host itself.  Only two
collectives run here, ``all_gather_into_tensor`` and ``all_to_all_single``;
``chip_smoke.py`` phase 11 checks that gloo takes both on CUDA tensors.

``mesh.sent`` counts, per axis set (``"pod,data"``), the bytes this rank
sent in the collectives of this module over that mesh: from each call's
tensor sizes, the send volume of the ring algorithm (all-reduce
``2 (n-1)/n`` of the tensor, reduce-scatter and all-to-all ``(n-1)/n`` of
it, all-gather ``n-1`` times this rank's piece; ``psum_scatter`` is an
all-to-all, ``psum`` an all-to-all and an all-gather).  ``CollectiveCostModel``
(``core/cost_model.py``) is re-exported here, as in the reference.

**The backward convention** (tensor parallelism over ``model``, Megatron's
*f* and *g*).  ``psum``, ``all_gather`` and ``all_to_all`` are
differentiable, and ``replicate`` is the identity whose backward sums:

* an activation that every rank of a ``model`` slice holds whole has a
  whole gradient, bit-identical on each of those ranks;
* where rank-local work reads such a value (the input of a column-parallel
  product, a rank's block of the tokens, its slice of the heads, a leaf
  that is whole on every rank but read in part, the input of a gathered
  K/V), it is read through ``replicate``, whose backward is the ``psum``
  of the ranks' partial gradients (*f*);
* a forward ``psum`` whose result every rank uses the same way has an
  identity backward (*g*); where each rank uses the sum on its own part
  (the gated norm's sum of squares), it is read through ``replicate`` too;
* ``all_gather``'s backward is the rank's slice of the gradient: taken as
  it is where every rank uses the gathered tensor the same way
  (``grad="slice"``: the logits before the loss, the MoE layer's output),
  summed over the slice first where each rank uses its own part of it
  (``grad="sum"``, a ``psum_scatter``: the K/V gather);
* ``all_to_all``'s backward is the reverse ``all_to_all``.

Every backward sum is the ordered ``psum`` / ``psum_scatter`` below, so
leaves that are whole on every rank stay bit-identical across the ranks
after any number of steps, and the backward's bytes are counted in
``mesh.sent`` like the forward's.  The gradient syncs run outside autograd
and call the same functions on tensors that need no gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map
from .cost_model import CollectiveCostModel

__all__ = [
    "hierarchical_all_reduce",
    "compressed_psum",
    "quantize_int8",
    "dequantize_int8",
    "two_stage_all_to_all",
    "error_feedback_slots",
    "psum",
    "pmean",
    "psum_scatter",
    "all_gather",
    "all_to_all",
    "replicate",
    "CollectiveCostModel",
]


def _count(mesh, axes, nbytes: float) -> None:
    mesh.sent[",".join(mesh.ordered_axes(axes))] += int(nbytes)


def _collective(fn, out_shape, x: torch.Tensor, group) -> torch.Tensor:
    """``fn(out, inp, group)`` into a new tensor of ``out_shape`` and
    ``x``'s dtype on ``x``'s device."""
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    fn(out, x.contiguous(), group)
    return out


def _psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of this rank's slice over ``axes``
    (``jax.lax.psum``); a new tensor.  It runs as a reduce-scatter and an
    all-gather (the two halves of a ring all-reduce, the same bytes), so
    each element is summed once, by one rank, and every rank gets the same
    bits.  An all-reduce does not promise that (gloo's over 4 ranks on CUDA
    tensors gave ranks different bits), and data-parallel ranks whose
    gradients differ in the last bit drift apart."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x.clone()
    flat = x.reshape(-1)
    if flat.numel() % n:
        flat = torch.cat([flat, flat.new_zeros(n - flat.numel() % n)])
    out = _all_gather(_psum_scatter(flat, axes, mesh), axes, True, mesh)
    return out[: x.numel()].reshape(x.shape)


def pmean(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """``psum`` divided by the slice's size (``jax.lax.pmean``)."""
    return psum(x, axes, mesh=mesh) / mesh.axis_size(axes)


def _psum_scatter(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=0, tiled=True)``:
    the sum's ``i``-th block of rows on the rank at index ``i`` of the
    slice.  It runs as an all-to-all of the blocks (the bytes of a
    reduce-scatter) and a sum of the received blocks in slice order, so the
    sum's order is the same on every backend."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x.clone()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    blocks = _all_to_all(x, axes, mesh)
    return blocks.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])).sum(dim=0)


def _all_gather(x: torch.Tensor, axes, tiled: bool, mesh) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=0, tiled=tiled)``: every rank's
    ``x`` in slice order, stacked on a new leading axis, or with ``tiled``
    concatenated along axis 0."""
    n, group = mesh.axis_size(axes), mesh.group(axes)
    flat = x.reshape((1,) + tuple(x.shape)) if x.dim() == 0 or not tiled else x
    if n == 1:
        out = flat.clone()
    else:
        _count(mesh, axes, (n - 1) * x.numel() * x.element_size())
        out = _collective(lambda o, i, g: dist.all_gather_into_tensor(o, i, group=g),
                          (n * flat.shape[0],) + tuple(flat.shape[1:]), flat, group)
    return out if tiled else out.reshape((n,) + tuple(x.shape))


def _all_to_all(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, 0, 0, tiled=True)`` on x [n * m, ...]:
    block ``j`` of ``n`` goes to the rank at index ``j`` of the slice; the
    result's block ``i`` came from the rank at index ``i``."""
    n, group = mesh.axis_size(axes), mesh.group(axes)
    if n == 1:
        return x.clone()
    _count(mesh, axes, (n - 1) / n * x.numel() * x.element_size())
    return _collective(lambda o, i, g: dist.all_to_all_single(o, i, group=g), x.shape, x, group)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Psum(torch.autograd.Function):
    """The ordered ``psum``; backward the identity (*g*)."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _psum(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    """The identity; backward the ordered ``psum`` (*f*)."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axes, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    """``all_gather``; backward the rank's slice of the gradient, summed
    over the slice first (``psum_scatter``) where ``grad`` is "sum"."""

    @staticmethod
    def forward(ctx, x, axes, tiled, mesh, grad):
        ctx.axes, ctx.tiled, ctx.mesh, ctx.grad, ctx.shape = axes, tiled, mesh, grad, x.shape
        return _all_gather(x, axes, tiled, mesh)

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.mesh.axis_size(ctx.axes), ctx.mesh.axis_index(ctx.axes)
        if ctx.tiled:  # [n * rows, ...] -> [n, rows, ...]
            g = g.reshape((n, -1) + tuple(g.shape[1:]))
        if ctx.grad == "sum" and n > 1:
            mine = _psum_scatter(g.contiguous(), ctx.axes, ctx.mesh)[0]
        else:
            mine = g[i]
        return mine.reshape(ctx.shape), None, None, None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all``; backward the reverse ``all_to_all``."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _all_to_all(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axes, ctx.mesh), None, None


def psum(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of this rank's slice over ``axes``
    (``jax.lax.psum``); a new tensor, the same bits on every rank (see
    ``_psum``).  Its gradient is passed through as it is (*g*): read the
    sum through ``replicate`` where each rank uses it on its own part."""
    return _Psum.apply(x, axes, mesh) if _needs_grad(x) else _psum(x, axes, mesh)


def replicate(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """``x`` itself, marked as read by rank-local work: its gradient is
    the ordered ``psum`` of the ranks' partial gradients over ``axes``
    (Megatron's *f*).  Without a gradient to take, or on a slice of one
    rank, ``x`` as it is."""
    if mesh is None or mesh.axis_size(axes) == 1 or not _needs_grad(x):
        return x
    return _Replicate.apply(x, axes, mesh)


def psum_scatter(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=0, tiled=True)``
    (see ``_psum_scatter``); not differentiable."""
    return _psum_scatter(x, axes, mesh)


def all_gather(x: torch.Tensor, axes, tiled: bool = False, *, mesh,
               grad: str = "sum") -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=0, tiled=tiled)`` (see
    ``_all_gather``).  Its gradient is the rank's slice of the result's:
    ``grad="sum"`` sums it over the slice first (each rank uses its own
    part of the result), ``grad="slice"`` takes it as it is (every rank
    uses the result the same way)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f'grad must be "sum" or "slice", got {grad!r}')
    if _needs_grad(x):
        return _AllGather.apply(x, axes, tiled, mesh, grad)
    return _all_gather(x, axes, tiled, mesh)


def all_to_all(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, 0, 0, tiled=True)`` (see
    ``_all_to_all``); its gradient goes back by the reverse all-to-all."""
    return _AllToAll.apply(x, axes, mesh) if _needs_grad(x) else _all_to_all(x, axes, mesh)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation.  Returns (q, scale), scale a
    0-d fp32 tensor; rounding is half to even, as ``jnp.round``'s."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(x: torch.Tensor, axis: str, *, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce over ``axis`` moving int8 and one fp32 scale per rank
    instead of the full-precision tensor: quantise, all-gather the int8
    tensors and the scales, dequantise and sum locally (in slice order).

    Returns (sum, quantisation error); feed the error into the next step's
    input (error feedback)."""
    q, scale = quantize_int8(x)
    err = x - dequantize_int8(q, scale, x.dtype)
    qs = all_gather(q, axis, mesh=mesh)  # [n, ...] int8
    ss = all_gather(scale.reshape(1), axis, mesh=mesh)  # [n, 1]
    total = (qs.float() * ss.reshape((-1,) + (1,) * q.dim())).sum(dim=0)
    return total.to(x.dtype), err


def error_feedback_slots(params, n_low: int):
    """Zero fp32 residuals shaped as the reduce-scattered shards of
    ``hierarchical_all_reduce`` with one low axis of size ``n_low``: a
    ``[ceil(size / n_low)]`` vector per leaf, on the leaf's device."""
    return tree_map(lambda p: torch.zeros((-(-p.numel() // n_low),), dtype=torch.float32,
                                          device=p.device), params)


def hierarchical_all_reduce(
    tree,
    low_axes: Sequence[str] = ("data",),
    high_axis: str | None = "pod",
    average: bool = True,
    compress_high: bool = False,
    residuals=None,
    *,
    mesh,
):
    """CLEX-staged all-reduce of a gradient tree:
    reduce-scatter(low) -> [compressed] all-reduce(high) -> all-gather(low),
    in fp32.  Its flat equivalent is a psum over the low and high axes; the
    staged schedule sends 1/prod(low) of the bytes across ``high_axis``.
    With ``compress_high`` that shard moves as int8 with error feedback:
    pass the previous step's ``residuals`` (``error_feedback_slots``) and
    carry the returned ones forward.

    Returns (reduced tree, residual tree), each leaf of the reduced tree in
    its gradient's dtype and divided by the mesh's product of the axes'
    sizes when ``average``."""
    denom = 1.0
    for ax in low_axes:
        denom *= mesh.axis_size(ax)
    if high_axis is not None:
        denom *= mesh.axis_size(high_axis)
    leaves = tree_leaves(tree)
    res_leaves = tree_leaves(residuals) if compress_high and residuals is not None else []
    if len(res_leaves) != len(leaves):
        res_leaves = [None] * len(leaves)

    def reduce_leaf(g, res):
        flat = g.reshape(-1).float()
        chunk = flat
        for ax in low_axes:
            size = mesh.axis_size(ax)
            if chunk.shape[0] % size:
                pad = size - chunk.shape[0] % size
                chunk = torch.cat([chunk, chunk.new_zeros((pad,))])
            chunk = psum_scatter(chunk, ax, mesh=mesh)
        err = torch.zeros_like(chunk)
        if high_axis is not None:
            if compress_high:
                if res is not None:
                    chunk = chunk + res
                chunk, err = compressed_psum(chunk, high_axis, mesh=mesh)
            else:
                chunk = psum(chunk, high_axis, mesh=mesh)
        for ax in reversed(low_axes):
            chunk = all_gather(chunk, ax, tiled=True, mesh=mesh)
        total = chunk[: flat.shape[0]].reshape(g.shape)
        if average:
            total = total / denom
        return total.to(g.dtype), err

    out = [reduce_leaf(g, r) for g, r in zip(leaves, res_leaves)]
    reduced, errors = iter([t for t, _ in out]), iter([e for _, e in out])
    return tree_map(lambda _: next(reduced), tree), tree_map(lambda _: next(errors), tree)


def two_stage_all_to_all(
    x: torch.Tensor,
    low_axis: str,
    high_axis: str,
    split_axis: int = 0,
    concat_axis: int = 0,
    *,
    mesh,
) -> torch.Tensor:
    """A(2) as a collective: the all-to-all over the product axis (high x
    low) staged as (i) an all-to-all over ``low_axis`` grouping entries by
    destination high-shard (to the gateway inside the clique), then (ii) one
    over ``high_axis`` (the bundle hop).

    ``x`` is split along ``split_axis`` into low*high equal destination
    groups ordered (high, low) major/minor; the result concatenates the
    source shards along ``concat_axis`` in the same order, exactly as a
    flat tiled all-to-all over the ``(high, low)`` group."""
    nl, nh = mesh.axis_size(low_axis), mesh.axis_size(high_axis)
    if x.shape[split_axis] % (nl * nh):
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split into "
                         f"{nh} x {nl} groups")
    shape = x.shape
    x = x.reshape(shape[:split_axis] + (nh * nl, shape[split_axis] // (nh * nl))
                  + shape[split_axis + 1:]).movedim(split_axis, 0)
    rest = x.shape[1:]
    x = x.reshape((nh, nl) + rest)
    # stage 1, inside the clique: block [h, l] goes to low rank l, which then
    # holds, for every destination high-shard, its gateway slot's traffic
    x = all_to_all(x.transpose(0, 1).contiguous(), low_axis, mesh=mesh).transpose(0, 1)
    # stage 2, across the bundle: block [h, :] goes to high rank h
    x = all_to_all(x.contiguous(), high_axis, mesh=mesh)
    x = x.reshape((nh * nl,) + rest).movedim(0, concat_axis)
    shape = x.shape
    return x.reshape(shape[:concat_axis] + (shape[concat_axis] * shape[concat_axis + 1],)
                     + shape[concat_axis + 2:])
