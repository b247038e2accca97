"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

Counterpart of the JAX package's ``runtime/sharding.py``.  Param leaves
carry logical axis names (``Model.param_axes``); the rules below map them
onto a mesh (``launch/mesh.py``).  Within one leaf a mesh axis is used at
most once (greedy left-to-right), e.g. MoE expert weights ("experts",
"embed", "ff") shard experts over ``model`` and leave ff replicated:
expert parallelism subsumes tensor parallelism there.

A spec is a plain tuple with one entry per dim: None (replicated), a mesh
axis name, or a tuple of two or more names (the dim split over those axes
together, row-major; one name stands alone, as ``PartitionSpec`` writes
it), in place of the reference's ``PartitionSpec`` inside a
``NamedSharding``.  The rules are pure functions of the axes, the shapes
and the mesh's axis names and sizes, so they give the reference's entries
leaf for leaf.  ``reshard_params`` returns this rank's block of every
leaf, as its spec names it: the block that the reference's ``device_put``
leaves on the device at this rank's place in the mesh.
"""

from __future__ import annotations

import math

import torch

from ..core.collectives import all_gather

__all__ = [
    "LOGICAL_RULES",
    "spec_for_axes",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "opt_state_shardings",
    "reshard_params",
    "model_dims",
    "map_blocks",
    "whole_leaves",
    "model_blocks",
]

LOGICAL_RULES: dict[str, str | None] = {
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "experts": "model",
    "embed": None,  # activations replicated along d_model (TP over heads/ff)
    "layers": None,  # the reference's scan axis
}


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def spec_for_axes(axes: tuple, mesh, shape=None, fsdp_axis: str | None = None) -> tuple:
    """The spec of a leaf with logical ``axes``: each named dim on its
    rule's mesh axis where the mesh has it, it is not used yet in this leaf
    and (with ``shape``) it divides the dim; then, with ``fsdp_axis``, the
    first remaining divisible dim (never ``layers``) over that axis."""
    sizes = _sizes(mesh)
    used = set()
    entries = []
    for i, name in enumerate(axes):
        target = LOGICAL_RULES.get(name) if name else None
        if (
            target is not None
            and target in sizes
            and target not in used
            and (shape is None or shape[i] % sizes[target] == 0)
        ):
            entries.append(target)
            used.add(target)
        else:
            entries.append(None)
    if fsdp_axis and fsdp_axis in sizes and fsdp_axis not in used and shape:
        for i, name in enumerate(axes):
            if (
                entries[i] is None
                and name != "layers"
                and shape[i] % sizes[fsdp_axis] == 0
                and shape[i] >= sizes[fsdp_axis]
            ):
                entries[i] = fsdp_axis
                break
    return tuple(entries)


def model_split_dim(axes: tuple, shape: tuple, mesh) -> int | None:
    """The dim of a leaf with logical ``axes`` and whole ``shape`` that the
    rules split over ``model`` on ``mesh``; None where they leave the leaf
    whole over ``model`` (no mesh, no such axis above 1, or no divisible
    dim).  The models' layers ask this one question of the rules to know
    which of their weights are the rank's blocks."""
    if mesh is None or _sizes(mesh).get("model", 1) == 1:
        return None
    spec = spec_for_axes(axes, mesh, shape)
    return spec.index("model") if "model" in spec else None


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree, whose leaves are tuples of
    names, and trees of the same structure (in the first one's key order)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in (trees[0] if trees else axes_tree)}
    return type(axes_tree)(_map_axes(fn, *xs) for xs in zip(axes_tree, *trees))


def param_shardings(axes_tree, mesh, params_tree=None, fsdp_axis: str | None = None):
    """A spec per leaf of ``axes_tree``; with ``params_tree`` the divisibility
    and FSDP rules read each leaf's shape."""
    if params_tree is None:
        return _map_axes(lambda axes: spec_for_axes(axes, mesh), axes_tree)
    return _map_axes(lambda axes, p: spec_for_axes(axes, mesh, shape=tuple(p.shape),
                                                   fsdp_axis=fsdp_axis), axes_tree, params_tree)


def _dp(mesh):
    """The data-parallel axes as a spec entry: their tuple, or the one name
    alone, as ``PartitionSpec`` normalises it; None without them."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _dp_size(mesh) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def batch_shardings(batch_tree, mesh):
    """The leading (batch) dim over the data-parallel axes when they divide it."""
    dp = _dp(mesh)
    dpn = _dp_size(mesh)

    def leaf(x):
        if dp and x.shape and x.shape[0] % dpn == 0:
            return (dp,) + (None,) * (x.ndim - 1)
        return (None,) * x.ndim

    return _map_leaves(leaf, batch_tree)


def cache_shardings(cache_tree, mesh, cfg, batch: int):
    """Decode caches, walked by leaf name: batch over the data-parallel axes
    when divisible; KV heads over ``model`` when divisible, else the
    sequence axis (the reference's split-KV decode); MLA's latent over the
    sequence; a ``conv`` leaf's channels and ``h``'s heads over ``model``
    (no SSM cache leaf is named ``conv``: ``conv_x``, ``conv_b`` and
    ``conv_c`` stay whole over ``model`` here, as in the reference).  A
    leaf whose first dim is not ``batch`` has a leading layer dim (the
    reference's scan axis; every leaf of the port's stacked caches)."""
    dp = _dp(mesh)
    dpn = _dp_size(mesh)
    mp = _sizes(mesh).get("model", 1)

    def spec(name: str, arr) -> tuple:
        lead = 0 if (arr.ndim and arr.shape[0] == batch) else 1
        entries: list = [None] * arr.ndim
        bdim = lead
        if dp and arr.shape[bdim] % dpn == 0 and arr.shape[bdim] > 1:
            entries[bdim] = dp
        if mp > 1:
            if name in ("k", "v"):
                kvdim, sdim = bdim + 2, bdim + 1
                if arr.shape[kvdim] % mp == 0:
                    entries[kvdim] = "model"
                elif arr.shape[sdim] % mp == 0:
                    entries[sdim] = "model"
            elif name in ("ckv", "k_rope"):
                sdim = bdim + 1
                if arr.shape[sdim] % mp == 0:
                    entries[sdim] = "model"
            elif name == "conv":
                cdim = bdim + 2
                if arr.shape[cdim] % mp == 0:
                    entries[cdim] = "model"
            elif name == "h":
                hdim = bdim + 1
                if arr.shape[hdim] % mp == 0:
                    entries[hdim] = "model"
        return tuple(entries)

    def walk(subtree):
        if isinstance(subtree, dict):
            return {k: (spec(k, v) if not isinstance(v, (dict, tuple, list)) else walk(v))
                    for k, v in subtree.items()}
        if isinstance(subtree, (tuple, list)):
            return type(subtree)(walk(v) for v in subtree)
        return (None,) * subtree.ndim

    return walk(cache_tree)


def opt_state_shardings(param_shardings_tree, mesh):
    """Adam's moments mirror the params' specs; the step is replicated."""
    return {"step": (), "m": param_shardings_tree, "v": param_shardings_tree}


def _block(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: along each split dim, the
    piece at the rank's index over the dim's axes (row-major)."""
    sizes, coords = _sizes(mesh), dict(zip(mesh.axis_names, mesh.coords))
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in names:
            n, idx = n * sizes[a], idx * sizes[a] + coords[a]
        if n > 1:
            step = t.shape[dim] // n
            out = out.narrow(dim, idx * step, step)
    return out.clone() if out is not t else out


def reshard_params(axes_tree, params, mesh):
    """This rank's block of every leaf of ``params``, as the spec the rules
    give it on ``mesh`` names it (a copy where the leaf is split, the leaf
    itself where it is replicated): pure data movement, bit-exact."""
    psh = param_shardings(axes_tree, mesh, params)
    return _map_axes(lambda _, p, s: _block(p, s, mesh), axes_tree, params, psh)


def model_dims(axes_tree, params, mesh):
    """The dim of each leaf of ``params`` (whole leaves) that the rules
    split over ``model`` on ``mesh``, None where they leave it whole: where
    a rank's block of the leaf (``reshard_params``) is cut.  The trainer
    and the checkpoints read it to put the blocks back together, since a
    block's shape alone does not say which of its dims was cut."""
    return _map_axes(lambda axes, p: model_split_dim(axes, tuple(p.shape), mesh), axes_tree,
                     params)


def map_blocks(fn, dims, *trees):
    """``fn(dim, *leaves)`` on each leaf of ``trees`` (of one structure)
    that ``dims`` (``model_dims``, mirroring them or a prefix of them: None
    where a leaf or a subtree is whole) names as cut over ``model`` at
    ``dim``; the first tree's leaf where it is whole.  The one walk by which
    the trainer, the checkpoints and the bridge put the ranks' blocks
    together and take them apart."""
    first = trees[0]
    if dims is None:
        return first
    if isinstance(first, dict):
        return {k: map_blocks(fn, dims.get(k), *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(map_blocks(fn, d, *xs) for d, *xs in zip(dims, *trees))
    return fn(dims, *trees)


def whole_leaves(tree, dims, mesh):
    """The whole leaves of this rank's blocks ``tree``: each leaf that
    ``dims`` names gathered over ``model`` in rank order along its dim.  A
    collective call on every rank; no gradient flows through it."""
    return map_blocks(lambda d, t: torch.cat(list(all_gather(t.detach(), "model", mesh=mesh)
                                                  .unbind(0)), dim=d), dims, tree)


def model_blocks(tree, dims, mesh):
    """This rank's block of each whole leaf of ``tree`` (tensors or numpy
    arrays) that ``dims`` names, the inverse of ``whole_leaves``."""
    if dims is None:
        return tree
    m, j = _sizes(mesh).get("model", 1), dict(zip(mesh.axis_names, mesh.coords)).get("model", 0)

    def block(d, t):
        n = t.shape[d] // m
        out = t[(slice(None),) * d + (slice(j * n, (j + 1) * n),)]
        return out.contiguous() if isinstance(out, torch.Tensor) else out

    return map_blocks(block, dims, tree)
