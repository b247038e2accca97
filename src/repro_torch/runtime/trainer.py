"""Trainer: train step with gradient accumulation, and the data-parallel
gradient sync across ranks, flat, CLEX-staged or int8-compressed.

Counterpart of the JAX package's ``runtime/trainer.py``.  The step is
``Model.train_loss`` -> gradients of the fp32 master params ->
``adamw_update``, with weight decay on the leaves the reference decays
(``Model.decay_mask``); with ``microbatches`` m > 1 the batch is split into
m equal slices, the gradients are seeded from slice 0, summed and divided
by m, and the loss is the mean of the slices' cross entropies.  There is no
jit: the step updates the params and the optimizer state in place and
returns them (``Trainer.jitted_step(donate=False)`` copies them first).

With a mesh (``launch/mesh.py``) every rank of it calls the step with the
same global batch and the same params, and takes its rows of the batch as
the reference's ``P(("pod", "data"), None)`` gives them: pod major, data
minor.  Its gradients are then synced in one of three ways:

* flat (``hierarchical_grad_sync=False``, or no ``pod`` axis): one
  all-reduce over the data-parallel group, divided by its size, the
  counterpart of the reference's GSPMD sync;
* hierarchical (a ``pod`` axis): ``hierarchical_all_reduce`` with the
  ``data`` axis low and ``pod`` high;
* compressed (and ``compress_cross_pod``): the same with the cross-pod
  shard in int8 and error feedback.  The int8 scale is one per leaf, so
  this sync groups the gradients into the reference's leaves first: the
  layers stacked over the repeats of the pattern, as the JAX package's
  scan stacks them (``bridge.reference_leaves``), and split back
  after.  ``Trainer.init`` adds ``err`` to the optimizer state, in that
  layout: on each rank its own row of the reference's
  ``[dp_total, ceil(size / n_data)]`` leaf, the row at the rank's
  flattened ``(pod, data)`` index, kept as a ``[1, ...]`` block.

Clipping and AdamW run after the sync, identically on every rank, and the
metrics are averaged over the data-parallel group.  An MoE config takes the
flat sync whatever the config asks, as in the reference (its hierarchical
path is for dense and SSM configs).  Without a mesh the step is the
single-device one whatever the ``ParallelConfig``, as in the reference.

On a ``model`` axis above 1 each rank holds its blocks of the params and
of AdamW's moments (``runtime/sharding.py``'s rules, as
``opt_state_shardings`` places them; ``Trainer.init`` draws the whole
params from the seed on every rank and keeps its blocks), and the ranks of
one ``model`` slice hold the same rows, which they compute
tensor-parallel (``Model.train_loss`` on the mesh).  Flat and hierarchical
syncs run on each rank's blocks over the data-parallel axes: a sum of
blocks is the block of the sum.  The compressed sync's int8 scale is one
per chunk of the reference's flattened whole leaf, so the split gradients
are first gathered over ``model`` into whole leaves (those bytes counted
under ``model``), synced as above, and each rank keeps its block; the
``err`` rows keep the whole-leaf layout, the same on the ranks of a
``model`` slice.  The clipping norm is the whole leaves'
(``adamw.global_norm``).  Which dim of each leaf is split
(``sharding.model_dims``) follows from the whole leaves' shapes, which
``model.init`` gives on the meta device without a draw (the reference's
``jax.eval_shape``).

An MoE config on a mesh whose ``model`` axis is 1 routes the tokens of all
the data-parallel ranks as one block, as the reference's ``moe_local``
routes its global batch there: each MoE layer gathers them
(``moe_apply``'s ``rows``).  With ``microbatches`` each microbatch is a
slice of the global batch, as in the reference, and a rank takes its rows
of each (``local_rows``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..bridge import port_leaves, reference_leaves
from ..configs.base import ParallelConfig
from ..core.collectives import error_feedback_slots, hierarchical_all_reduce, pmean, psum
from ..models import Model
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_copy, tree_leaves, tree_map
from .sharding import model_blocks, model_dims, reshard_params, whole_leaves

__all__ = ["Trainer", "make_train_step", "value_and_grads", "local_rows"]


class _OnMeta(torch.overrides.TorchFunctionMode):
    """Every call that names a device lands on the meta device: tensors
    with shapes and dtypes, no memory, no draw."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


def _split_dims(model: Model, mesh):
    """The dim of each param leaf that a ``model`` axis above 1 splits
    (``sharding.model_dims`` of the whole leaves' shapes, from ``init`` on
    the meta device); None without such an axis."""
    if not _model_axis(mesh):
        return None
    with _OnMeta():
        shapes = type(model)(model.cfg, device="cpu").init(torch.Generator())
    return model_dims(model.param_axes(), shapes, mesh)


def value_and_grads(model: Model, params, batch: dict, microbatches: int = 1, mesh=None):
    """(gradients mirroring ``params``, {"loss"}) of ``model.train_loss``
    (on ``mesh``), accumulated over ``microbatches`` equal slices of the
    batch.  The gradients are those of the loss that is minimised (for an
    MoE config the cross entropy plus 0.01 x the load-balancing loss);
    "loss" is the cross entropy alone, as the reference reports it.  Each
    slice routes its own tokens, so an MoE layer's capacity follows the
    slice's size."""
    leaves = tree_leaves(params)
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch of {b} rows does not split into {microbatches} microbatches")
    mb = b // microbatches

    def micro(i):
        sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics = model.train_loss(params, sl, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return list(grads), metrics["loss"].detach()

    grads, loss = micro(0)
    for i in range(1, microbatches):
        g, l = micro(i)
        for acc, x in zip(grads, g):
            acc.add_(x)
        loss = loss + l
    if microbatches > 1:
        for g in grads:
            g.div_(microbatches)
        loss = loss / microbatches
    it = iter(grads)
    return tree_map(lambda _: next(it), params), {"loss": loss}


def local_rows(batch: dict, mesh, microbatches: int = 1) -> dict:
    """This rank's rows of the global ``batch``, as the reference's
    ``P(("pod", "data"), None)`` places them: block ``i`` of ``n``, ``i``
    the rank's flattened (pod, data) index.  With ``microbatches`` the
    rank's block of each of the global batch's equal slices in turn, as the
    reference slices its global batch."""
    dp = mesh.data_parallel_axes
    n, i = mesh.axis_size(dp), mesh.axis_index(dp)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (n * microbatches):
            raise ValueError(f"batch of {v.shape[0]} rows does not split over {n} ranks and "
                             f"{microbatches} microbatches")
        rows = v.shape[0] // (n * microbatches)
        blocks = v.reshape((microbatches, n, rows) + tuple(v.shape[1:]))[:, i]
        out[k] = blocks.reshape((microbatches * rows,) + tuple(v.shape[1:]))
    return out


def _model_axis(mesh) -> bool:
    return mesh is not None and mesh.axis_sizes().get("model", 1) > 1


def make_train_step(model: Model, opt_cfg: AdamWConfig, pcfg: ParallelConfig, mesh=None,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}), updating params and state in place."""
    decay = None  # the decay mask depends only on the config and the tree: made at the first step
    tp = _model_axis(mesh)
    dims = _split_dims(model, mesh)
    split = tree_map(lambda d: d is not None, dims) if tp else None

    def update(params, grads, opt_state):
        nonlocal decay
        if decay is None:
            decay = model.decay_mask(params)
        return adamw_update(params, grads, opt_state, opt_cfg, decay,
                            mesh=mesh if tp else None, split=split)

    if mesh is None:
        def train_step(params, opt_state, batch):
            grads, metrics = value_and_grads(model, params, batch, microbatches)
            params, opt_state, om = update(params, grads, opt_state)
            return params, opt_state, {**metrics, **om}

        return train_step

    dp = mesh.data_parallel_axes
    hier = (pcfg.hierarchical_grad_sync and "pod" in mesh.axis_names
            and model.cfg.moe is None)
    low_axes = tuple(a for a in ("data",) if a in mesh.axis_names)

    def train_step(params, opt_state, batch):
        grads, metrics = value_and_grads(model, params, local_rows(batch, mesh, microbatches),
                                         microbatches, mesh)
        if hier and pcfg.compress_cross_pod:
            residuals = None
            if "err" in opt_state:
                residuals = tree_map(lambda e: e[0], opt_state["err"])
            if tp:  # the int8 scales are the whole leaves'
                grads = whole_leaves(grads, dims, mesh)
            synced, new_res = hierarchical_all_reduce(
                reference_leaves(model.cfg, grads), low_axes=low_axes, high_axis="pod",
                average=True, compress_high=True, residuals=residuals, mesh=mesh)
            grads = port_leaves(model.cfg, synced)
            if tp:
                grads = model_blocks(grads, dims, mesh)
            if "err" in opt_state:
                for e, r in zip(tree_leaves(opt_state["err"]), tree_leaves(new_res)):
                    e.copy_(r[None])
        elif hier:
            grads, _ = hierarchical_all_reduce(grads, low_axes=low_axes, high_axis="pod",
                                               average=True, mesh=mesh)
        else:
            n = mesh.axis_size(dp)
            grads = tree_map(lambda g: psum(g, dp, mesh=mesh).div_(n), grads)
        params, opt_state, om = update(params, grads, opt_state)
        # loss and grad norm averaged over the data-parallel group in one call
        loss, gnorm = pmean(torch.stack([metrics["loss"].float(), om["grad_norm"].float()]), dp,
                            mesh=mesh)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": om["lr"]}

    return train_step


@dataclasses.dataclass
class Trainer:
    """Host-level training driver: ``init``, ``jitted_step`` and ``step``
    (the in-place step, ``jitted_step(donate=True)``)."""

    model: Model
    opt_cfg: AdamWConfig
    pcfg: ParallelConfig = ParallelConfig()
    mesh: object | None = None
    microbatches: int = 1

    def __post_init__(self):
        self.dims = _split_dims(self.model, self.mesh)  # None without a model axis above 1
        self.step = make_train_step(self.model, self.opt_cfg, self.pcfg, self.mesh,
                                    self.microbatches)

    def init(self, gen: torch.Generator):
        """(fp32 master params that require grad, optimizer state), the params
        drawn from ``gen`` on the model's device; every rank of a mesh draws
        the same params from the same seed.  With a compressed sync on a
        mesh the state holds this rank's ``err`` row.  On a ``model`` axis
        above 1 the params and moments are this rank's blocks, cut at
        ``dims``."""
        params = self.model.init(gen)
        opt_state = {}
        if self.pcfg.compress_cross_pod and self.mesh is not None:
            n_low = self.mesh.axis_sizes().get("data", 1)
            slots = error_feedback_slots(reference_leaves(self.model.cfg, params), n_low)
            opt_state["err"] = tree_map(lambda e: e[None], slots)
        if self.dims is not None:
            params = reshard_params(self.model.param_axes(), params, self.mesh)
        params = tree_map(lambda t: t.requires_grad_(), params)
        return params, {**adamw_init(params, self.opt_cfg), **opt_state}

    def checkpoint_dims(self):
        """The ``dims`` of ``(params, optimizer state)`` for
        ``save_checkpoint`` and ``restore_checkpoint``: the split dim of
        each leaf of the params and of the moments on a ``model`` axis above
        1, else None."""
        return None if self.dims is None else (self.dims, {"m": self.dims, "v": self.dims})

    def jitted_step(self, donate: bool = True):
        """The train step.  With ``donate`` (the reference's buffer
        donation) it updates the caller's params and optimizer state in
        place.  With ``donate=False`` it first copies both trees (params
        keep ``requires_grad``), so the caller's tensors stay valid and
        unchanged, as in the reference; the copies double the fp32 state
        (16 bytes a parameter) while the step runs, so full-width callers
        keep the in-place step."""
        if donate:
            return self.step

        def step(params, opt_state, batch):
            return self.step(tree_copy(params), tree_copy(opt_state), batch)

        return step
