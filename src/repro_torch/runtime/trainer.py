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
metrics are averaged over the data-parallel group.  A ``model`` axis above
1 (tensor parallelism) and an MoE config with a mesh raise
``NotImplementedError``: training on a ``model`` axis and MoE across
ranks in training are the next slice (ROADMAP A11c; serving on a
``model`` axis is ported).  Without a mesh the step is the
single-device one whatever the ``ParallelConfig``, as in the reference.
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

__all__ = ["Trainer", "make_train_step", "value_and_grads", "local_rows"]

_NEXT_SLICE = ("training on a model axis above 1 and MoE on a mesh in training are the next "
               "slice of the port (ROADMAP A11c)")


def value_and_grads(model: Model, params, batch: dict, microbatches: int = 1):
    """(gradients mirroring ``params``, {"loss"}) of ``model.train_loss``,
    accumulated over ``microbatches`` equal slices of the batch.  The
    gradients are those of the loss that is minimised (for an MoE config the
    cross entropy plus 0.01 x the load-balancing loss); "loss" is the cross
    entropy alone, as the reference reports it.  Each slice routes its own
    tokens, so an MoE layer's capacity follows the slice's size."""
    leaves = tree_leaves(params)
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch of {b} rows does not split into {microbatches} microbatches")
    mb = b // microbatches

    def micro(i):
        sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics = model.train_loss(params, sl)
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


def local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of the global ``batch``, as the reference's
    ``P(("pod", "data"), None)`` places them: block ``i`` of ``n``, ``i``
    the rank's flattened (pod, data) index."""
    dp = mesh.data_parallel_axes
    n, i = mesh.axis_size(dp), mesh.axis_index(dp)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} rows does not split over {n} ranks")
        rows = v.shape[0] // n
        out[k] = v[i * rows:(i + 1) * rows]
    return out


def make_train_step(model: Model, opt_cfg: AdamWConfig, pcfg: ParallelConfig, mesh=None,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}), updating params and state in place."""
    decay = None  # the decay mask depends only on the config and the tree: made at the first step

    def update(params, grads, opt_state):
        nonlocal decay
        if decay is None:
            decay = model.decay_mask(params)
        return adamw_update(params, grads, opt_state, opt_cfg, decay)

    if mesh is None:
        def train_step(params, opt_state, batch):
            grads, metrics = value_and_grads(model, params, batch, microbatches)
            params, opt_state, om = update(params, grads, opt_state)
            return params, opt_state, {**metrics, **om}

        return train_step

    if mesh.axis_sizes().get("model", 1) > 1:
        raise NotImplementedError(f"a model axis of {mesh.axis_sizes()['model']}: {_NEXT_SLICE}")
    if model.cfg.moe is not None:
        raise NotImplementedError(f"{model.cfg.name} is an MoE config on a mesh: {_NEXT_SLICE}")
    dp = mesh.data_parallel_axes
    hier = pcfg.hierarchical_grad_sync and "pod" in mesh.axis_names
    low_axes = tuple(a for a in ("data",) if a in mesh.axis_names)

    def train_step(params, opt_state, batch):
        grads, metrics = value_and_grads(model, params, local_rows(batch, mesh), microbatches)
        if hier and pcfg.compress_cross_pod:
            residuals = None
            if "err" in opt_state:
                residuals = tree_map(lambda e: e[0], opt_state["err"])
            synced, new_res = hierarchical_all_reduce(
                reference_leaves(model.cfg, grads), low_axes=low_axes, high_axis="pod",
                average=True, compress_high=True, residuals=residuals, mesh=mesh)
            grads = port_leaves(model.cfg, synced)
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
        self.step = make_train_step(self.model, self.opt_cfg, self.pcfg, self.mesh,
                                    self.microbatches)

    def init(self, gen: torch.Generator):
        """(fp32 master params that require grad, optimizer state), the params
        drawn from ``gen`` on the model's device; every rank of a mesh draws
        the same params from the same seed.  With a compressed sync on a
        mesh the state holds this rank's ``err`` row."""
        params = tree_map(lambda t: t.requires_grad_(), self.model.init(gen))
        opt_state = adamw_init(params, self.opt_cfg)
        if self.pcfg.compress_cross_pod and self.mesh is not None:
            n_low = self.mesh.axis_sizes().get("data", 1)
            with torch.no_grad():
                slots = error_feedback_slots(reference_leaves(self.model.cfg, params), n_low)
            opt_state["err"] = tree_map(lambda e: e[None], slots)
        return params, opt_state

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
