"""AdamW with decoupled weight decay, gradient clipping and a cosine
schedule.

Counterpart of the JAX package's ``optim/adamw.py``.  The state is
``{"step", "m", "v"}``: fp32 moments mirroring the param tree (nested dicts
and lists of tensors) and the step as a Python int, so that the schedule is
computed on the host without waiting for the device.  The JAX package's
error-feedback slot (compressed cross-pod sync) comes with the multi-device
work (ROADMAP A11).

``adamw_update`` updates the params and moments in place, under
``torch.no_grad``, and returns the same tensors: a functional update, as the
JAX package's, would hold a second fp32 copy of every param (7.6 GB for a
1.9 B-parameter model) while it runs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def cosine_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup to ``cfg.lr``, then a cosine decay to a tenth of it."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    progress = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * progress))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """The fp32 2-norm of all leaves together (a 0-d tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def adamw_init(params, cfg: AdamWConfig) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"step": 0, "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _decay_mask(leaf: torch.Tensor) -> bool:
    """The reference's rule for one leaf: no weight decay on 1-D leaves (norm
    scales, biases).  On a model's per-layer tree ``Model.decay_mask``
    applies it as the reference does on its stacked tree."""
    return leaf.dim() >= 2


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, decay):
    """Returns (params, state, {"grad_norm", "lr"}), params and state
    updated in place.  ``grads`` mirrors ``params``, and so does ``decay``,
    a bool per leaf that says whether it takes weight decay: a model's
    params take ``Model.decay_mask``, the reference's decision on its
    stacked tree; a plain tree ``tree_map(_decay_mask, params)``."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.betas
    bc1, bc2 = 1 - b1**step, 1 - b2**step
    for p, g, m, v, d in zip(*map(tree_leaves, (params, grads, state["m"], state["v"], decay))):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if d:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float().sub_(delta, alpha=lr))  # p.float() is p itself for fp32 leaves
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
