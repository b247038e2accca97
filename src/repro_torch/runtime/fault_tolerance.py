"""Fault tolerance on one device: the restart loop, the straggler monitor
and the elastic re-mesh plan.

Counterpart of the JAX package's ``runtime/fault_tolerance.py``:

* ``run_with_restarts`` -- the launcher's watchdog loop: run the training
  function; on (injected or real) failure, restore the latest intact
  checkpoint and resume with exact data skip-ahead.  The data pipeline is
  stateless (batch = f(seed, step)), so resume is bit-exact.  The port's
  step updates its state in place, so the loop keeps a copy of
  ``init_state`` taken at entry for a failure before the first checkpoint.
* ``StragglerMonitor`` -- per-step wall-time ring buffer; flags steps slower
  than ``threshold``x the running median (the drain/replace signal).  Its
  clock is an argument, so tests drive it without sleeping.
* ``ElasticPlan`` / ``plan_remesh`` -- given the surviving device count,
  the new mesh and microbatching that keep the global batch.  The port's
  trainer runs on one device (meshes wait for ROADMAP A11); the plan is
  arithmetic and is ported as it is.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..checkpoint.checkpointing import restore_checkpoint, save_checkpoint
from ..tree import tree_map

__all__ = ["run_with_restarts", "StragglerMonitor", "ElasticPlan", "plan_remesh"]


def _copy(tree):
    """A copy of ``tree`` whose tensors and arrays share no memory with it
    (tensors requiring grad where the originals do)."""
    def leaf(t):
        if isinstance(t, torch.Tensor):
            return t.detach().clone().requires_grad_(t.requires_grad)
        return np.array(t) if isinstance(t, np.ndarray) else t
    return tree_map(leaf, tree)


def run_with_restarts(
    step_fn: Callable,  # (state, step) -> state ; may raise
    init_state,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 10,
    on_restore: Callable | None = None,
):
    """Watchdog loop with checkpoint/restart.  Returns (state, restarts)."""
    initial = _copy(init_state)  # step_fn may update init_state in place

    def resume():
        """(state, step) after the newest intact checkpoint, or None."""
        try:
            state, last = restore_checkpoint(ckpt_dir, initial)
        except OSError:  # none there, or none intact
            return None
        return state, last + 1

    restarts = 0
    state, step = resume() or (init_state, 0)
    while step < n_steps:
        try:
            state = step_fn(state, step)
            if step % ckpt_every == 0 or step == n_steps - 1:
                save_checkpoint(ckpt_dir, step, state)
            step += 1
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            state, step = resume() or (_copy(initial), 0)
            if on_restore is not None:
                on_restore(restarts, step)
    return state, restarts


@dataclasses.dataclass
class StragglerMonitor:
    window: int = 64
    threshold: float = 2.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._times: list[float] = []
        self._t0: float | None = None

    def step_start(self):
        self._t0 = self.clock()

    def step_end(self) -> bool:
        """Record; return True if this step was a straggler."""
        dt = self.clock() - self._t0
        self._times.append(dt)
        self._times = self._times[-self.window :]
        med = float(np.median(self._times))
        return len(self._times) >= 8 and dt > self.threshold * med

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data_parallel: int
    model_parallel: int
    microbatches: int
    note: str


def plan_remesh(
    surviving_devices: int,
    model_parallel: int,
    global_batch: int,
    prev_dp: int,
    prev_microbatches: int = 1,
) -> ElasticPlan:
    """Resize the data axis to the surviving devices — shrink *or* grow —
    keep the model axis (parameter sharding must still fit), and adjust
    grad-accumulation so the global batch — and training dynamics — are
    unchanged.  ``prev_microbatches`` carries the accumulation already in
    force, so a shrink→grow round trip lands back at the original plan
    (``dp * microbatches`` is invariant) instead of compounding."""
    if model_parallel <= 0:
        raise ValueError(f"model_parallel must be positive, got {model_parallel}")
    if surviving_devices <= 0:
        raise ValueError(f"surviving_devices must be positive, got {surviving_devices}")
    if global_batch <= 0 or prev_dp <= 0:
        raise ValueError(
            f"global_batch and prev_dp must be positive, got {global_batch} / {prev_dp}"
        )
    if prev_microbatches <= 0:
        raise ValueError(f"prev_microbatches must be positive, got {prev_microbatches}")
    if surviving_devices < model_parallel:
        raise ValueError("fewer devices than the model-parallel degree; cannot re-mesh")
    dp = surviving_devices // model_parallel
    # largest power-of-two dp that divides the global batch
    while dp > 1 and (global_batch % dp or dp & (dp - 1)):
        dp -= 1
    micro = max(1, prev_dp * prev_microbatches // dp)
    return ElasticPlan(
        data_parallel=dp,
        model_parallel=model_parallel,
        microbatches=micro,
        note=f"{surviving_devices} devices -> mesh ({dp}, {model_parallel}), "
        f"{micro} microbatches preserve global batch {global_batch}",
    )
