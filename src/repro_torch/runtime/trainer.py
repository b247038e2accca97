"""Trainer on one device: train step with gradient accumulation.

Counterpart of the single-device branch of the JAX package's
``runtime/trainer.py`` (``make_train_step`` without a mesh, and
``Trainer``).  The step is ``Model.train_loss`` -> gradients of the fp32
master params -> ``adamw_update``, with weight decay on the leaves the
reference decays (``Model.decay_mask``); with ``microbatches`` m > 1 the
batch is split into m equal slices, the gradients are seeded from slice 0,
summed and divided by m, and the loss is the mean of the slices' cross
entropies.  There is no jit: the step updates the params and the optimizer
state in place (where the JAX ``Trainer.jitted_step`` donates their
buffers) and returns them.

A mesh or a ``ParallelConfig`` (sharded state, the hierarchical and
compressed gradient sync) waits for the multi-device work (ROADMAP A11) and
raises ``NotImplementedError``; the arguments keep the JAX package's order.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import Model
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_leaves, tree_map

__all__ = ["Trainer", "make_train_step", "value_and_grads"]


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


def make_train_step(model: Model, opt_cfg: AdamWConfig, pcfg=None, mesh=None,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})."""
    if pcfg is not None or mesh is not None:
        raise NotImplementedError(
            "the port's trainer runs on one device: a mesh and a ParallelConfig (the "
            "hierarchical and compressed gradient sync) wait for ROADMAP A11")

    decay = None  # the decay mask depends only on the config and the tree: made at the first step

    def train_step(params, opt_state, batch):
        nonlocal decay
        if decay is None:
            decay = model.decay_mask(params)
        grads, metrics = value_and_grads(model, params, batch, microbatches)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg, decay)
        return params, opt_state, {**metrics, **om}

    return train_step


@dataclasses.dataclass
class Trainer:
    """Host-level training loop on one device: ``init`` and ``step``."""

    model: Model
    opt_cfg: AdamWConfig
    pcfg: object | None = None
    mesh: object | None = None
    microbatches: int = 1

    def __post_init__(self):
        self.step = make_train_step(self.model, self.opt_cfg, self.pcfg, self.mesh,
                                    self.microbatches)

    def init(self, gen: torch.Generator):
        """(fp32 master params that require grad, optimizer state), the params
        drawn from ``gen`` on the model's device."""
        params = tree_map(lambda t: t.requires_grad_(), self.model.init(gen))
        return params, adamw_init(params, self.opt_cfg)
