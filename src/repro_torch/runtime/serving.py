"""Continuous-batching serving: RequestQueue -> Scheduler -> KVPool -> decode.

Counterpart of the JAX package's ``runtime/serving.py``:

* ``RequestQueue`` -- admission-ordered queue of ragged requests.
* ``KVPool`` -- ``n_slots`` cache rows of the model's decode layout,
  allocated per request and reused on completion.
* ``Scheduler`` -- ``fcfs`` or ``cost_aware`` admission (MoE-heavy requests
  are co-scheduled, priced by the collective cost model).
* ``ContinuousBatchingEngine`` -- bucketed, grouped prefill into free slots
  (for stacks with SSM layers: one request at a time at its exact length)
  and one ragged decode step over all active slots per round.
* ``ServingEngine`` -- the one-shot lockstep baseline.

Tiered pools, sessions, migration and observability spans wait for later
slices; the engine's counters are plain attributes.  Where the JAX engine
returns new cache buffers, this one writes the pool's tensors in place.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.cost_model import CollectiveCostModel
from ..models.model import Model

__all__ = [
    "Request",
    "RequestQueue",
    "KVPool",
    "SchedulerConfig",
    "Scheduler",
    "EngineMetrics",
    "ContinuousBatchingEngine",
    "ServingEngine",
]

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"
# SHED: rejected at submit (queue over max_queue_depth) or dropped past its
# deadline -- never allocated a KV slot
SHED = "shed"


# --------------------------------------------------------------------------
# requests
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One generation request moving through queued -> running -> finished."""

    rid: int
    prompt: np.ndarray  # [L] int32
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    arrival_time: Optional[float] = None  # None = available immediately
    # estimated MoE all-to-all bytes per decoded token (0 for dense models)
    dispatch_weight: float = 0.0
    deadline: Optional[float] = None  # unadmitted past this -> SHED

    state: str = QUEUED
    tokens_out: list = dataclasses.field(default_factory=list)
    deferred: int = 0  # admission rounds the scheduler has deferred this request
    slot: Optional[int] = None
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def moe_heavy(self) -> bool:
        return self.dispatch_weight > 0.0

    @property
    def done(self) -> bool:
        return self.state == FINISHED


class RequestQueue:
    """FIFO of queued requests; ``arrived(now)`` filters by arrival time.

    Closed-loop requests (``arrival_time=None``) go onto an eligible list in
    submission order; open-loop ones wait in a heap keyed by arrival time
    and graduate as the clock passes them.  ``remove`` is lazy."""

    _COMPACT_AT = 64  # lazily deleted entries tolerated before a sweep

    def __init__(self):
        self._seq = itertools.count()
        self._ready: list[tuple[int, Request]] = []  # eligible, sorted by seq
        self._pending: list[tuple[float, int, Request]] = []  # heap by arrival
        self._gone: set[int] = set()  # id()s removed but not yet swept

    def push(self, req: Request) -> None:
        seq = next(self._seq)
        if req.arrival_time is None:
            self._ready.append((seq, req))
        else:
            heapq.heappush(self._pending, (req.arrival_time, seq, req))

    def __len__(self) -> int:
        return len(self._ready) + len(self._pending) - len(self._gone)

    def __iter__(self):
        live = [(s, r) for s, r in self._ready if id(r) not in self._gone]
        live += [(s, r) for _, s, r in self._pending if id(r) not in self._gone]
        return iter(r for _, r in sorted(live, key=lambda e: e[0]))

    def _graduate(self, now: float) -> None:
        while self._pending and self._pending[0][0] <= now:
            _, seq, req = heapq.heappop(self._pending)
            if id(req) in self._gone:
                self._gone.discard(id(req))
                continue
            bisect.insort(self._ready, (seq, req), key=lambda e: e[0])

    def _compact(self) -> None:
        if len(self._gone) < self._COMPACT_AT:
            return
        self._ready = [(s, r) for s, r in self._ready if id(r) not in self._gone]
        still = {id(r) for _, r in self._ready}
        still |= {id(r) for _, _, r in self._pending}
        self._gone &= still

    def arrived(self, now: Optional[float]) -> list[Request]:
        """Requests eligible for admission at time ``now`` (``None``: all)."""
        if now is None:
            return list(self)
        self._graduate(now)
        self._compact()
        return [r for _, r in self._ready if id(r) not in self._gone]

    def remove(self, reqs: Sequence[Request]) -> None:
        self._gone.update(id(r) for r in reqs)

    def next_arrival(self) -> Optional[float]:
        """Earliest not-yet-graduated arrival time."""
        while self._pending and id(self._pending[0][2]) in self._gone:
            self._gone.discard(id(heapq.heappop(self._pending)[2]))
        return self._pending[0][0] if self._pending else None


# --------------------------------------------------------------------------
# pooled KV cache
# --------------------------------------------------------------------------


class KVPool:
    """``n_slots`` fixed-size KV-cache rows, allocated per request and freed
    for reuse on completion.  The pooled cache is the model's decode layout
    (``[n_layers, n_slots, L, ...]``, batch on dim 1); each slot holds
    ``capacity`` ring entries (SWA layers ``min(capacity, window)``).  Freed
    slots are reused LIFO."""

    def __init__(self, model: Model, n_slots: int, capacity: int):
        if n_slots < 1:
            raise ValueError("KVPool needs at least one slot")
        self.model = model
        self.n_slots = n_slots
        self.capacity = capacity
        self.caches = model.init_cache(n_slots, capacity)
        self._free: list[int] = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0 first
        self.slot_rid: list[Optional[int]] = [None] * n_slots
        self.n_alloc = 0
        self.n_evict = 0
        self.high_water = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free)

    def allocate(self, rid: int) -> Optional[int]:
        """Claim a free slot for ``rid``; None when the pool is exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.slot_rid[slot] = rid
        self.n_alloc += 1
        self.high_water = max(self.high_water, self.n_used)
        return slot

    def free(self, slot: int) -> None:
        """Evict ``slot``'s row: its contents are dead until the next write."""
        if self.slot_rid[slot] is None:
            raise ValueError(f"slot {slot} is not allocated")
        self.slot_rid[slot] = None
        self._free.append(slot)
        self.n_evict += 1

    def write(self, slots: Sequence[int], caches: dict) -> None:
        """Install prepared decode caches (batch ``len(slots)``) into the rows
        ``slots``, in place."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.model.device)
        for name, pool_t in self.caches.items():
            pool_t[:, idx] = caches[name].to(pool_t.dtype)

    def check(self) -> None:
        """Slot-accounting invariants: the free list and the allocated slots
        partition the pool, and no request id owns two slots."""
        free = set(self._free)
        used = {s for s, r in enumerate(self.slot_rid) if r is not None}
        if len(free) != len(self._free):
            raise AssertionError(f"free list has duplicates: {self._free}")
        if free & used or free | used != set(range(self.n_slots)):
            raise AssertionError(
                f"slot accounting corrupt: free={sorted(free)} used={sorted(used)} "
                f"of {self.n_slots} slots"
            )
        rids = [r for r in self.slot_rid if r is not None]
        if len(rids) != len(set(rids)):
            raise AssertionError(f"request id owns two slots: {self.slot_rid}")


# --------------------------------------------------------------------------
# scheduler
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission knobs.

    policy           "fcfs" (arrival order) or "cost_aware" (price MoE
                     dispatch with the cost model and co-schedule)
    a2a_budget_s     per-decode-step all-to-all budget for MoE-heavy requests
    min_coschedule   hold MoE-heavy requests until this many can enter the
                     same step, unless...
    max_defer_steps  ...one has been deferred this many rounds (aging)
    work_conserving  never leave a slot idle when anything is queued
    n_low / n_pods   mesh shape priced by the cost model
    """

    policy: str = "cost_aware"
    a2a_budget_s: float = 2e-3
    min_coschedule: int = 2
    max_defer_steps: int = 8
    work_conserving: bool = True
    n_low: int = 8
    n_pods: int = 2
    bytes_per_elem: float = 2.0


class Scheduler:
    """Picks which arrived requests enter free decode slots.  ``cost_aware``
    batches MoE-heavy requests into the same decode steps so one staged
    all-to-all serves them together; light requests fill the remaining slots
    in arrival order."""

    def __init__(self, cfg: SchedulerConfig, cost_model: Optional[CollectiveCostModel] = None,
                 d_model: int = 1024, top_k: int = 0, n_moe_layers: int = 0):
        if cfg.policy not in ("fcfs", "cost_aware"):
            raise ValueError(f"unknown policy {cfg.policy!r}")
        self.cfg = cfg
        self.cost_model = cost_model or CollectiveCostModel()
        self.d_model = d_model
        self.top_k = top_k
        self.n_moe_layers = n_moe_layers
        self.last_step_cost = 0.0  # predicted a2a seconds of the last admitted step

    def _step_cost(self, n_heavy: int) -> float:
        return self.cost_model.decode_step_a2a_cost(
            n_heavy, self.d_model, max(self.top_k, 1), max(self.n_moe_layers, 1),
            self.cfg.n_low, self.cfg.n_pods, self.cfg.bytes_per_elem,
        )

    def select(self, candidates: Sequence[Request], n_free: int,
               n_heavy_active: int = 0) -> list[Request]:
        """Choose up to ``n_free`` requests to admit this round.
        ``n_heavy_active`` MoE-heavy requests are already decoding."""
        if n_free <= 0 or not candidates:
            return []
        if self.cfg.policy == "fcfs":
            return list(candidates[:n_free])

        heavy = [r for r in candidates if r.moe_heavy]
        light = [r for r in candidates if not r.moe_heavy]
        picks: list[Request] = []
        aged = any(r.deferred >= self.cfg.max_defer_steps for r in heavy)
        group_ready = len(heavy) + n_heavy_active >= self.cfg.min_coschedule
        admit_heavy = heavy and (group_ready or aged or not light)

        if admit_heavy:
            n_heavy = n_heavy_active
            for r in heavy:
                # aging overrides the budget; every heavy request left behind
                # (budget or slots) accrues deferral so aging never pauses
                admit = len(picks) < n_free and (
                    self._step_cost(n_heavy + 1) <= self.cfg.a2a_budget_s
                    or r.deferred >= self.cfg.max_defer_steps
                    or (self.cfg.work_conserving and not picks and not light)
                )
                if admit:
                    picks.append(r)
                    n_heavy += 1
                else:
                    r.deferred += 1
            self.last_step_cost = self._step_cost(n_heavy)
        else:
            for r in heavy:
                r.deferred += 1
            self.last_step_cost = self._step_cost(n_heavy_active)

        for r in light:
            if len(picks) >= n_free:
                break
            picks.append(r)

        if not picks and self.cfg.work_conserving:
            picks = list(candidates[:n_free])
        return picks


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def stream_seed(seed: int, rid: int, idx: int) -> int:
    """Seed of the sampling stream of token ``idx`` of request ``rid``."""
    return _mix64(_mix64(_mix64(seed) ^ rid) ^ idx)


def sample_tokens(logits: torch.Tensor, temps: Sequence[float], seeds: Sequence[int]) -> np.ndarray:
    """One token per row of ``logits`` [B, V]: argmax where the temperature
    is 0, else a Gumbel-max draw from ``softmax(logits / t)`` with noise from
    a generator seeded by the row's ``seeds`` entry -- a row's token depends
    on its own (seed, rid, idx), never on its slot."""
    toks = logits.argmax(dim=-1)
    for i, t in enumerate(temps):
        if t > 0.0:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(seeds[i])
            u = torch.rand(logits.shape[-1], generator=gen, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            toks[i] = (logits[i].float() / max(t, 1e-6) + gumbel).argmax()
    return toks.cpu().numpy().astype(np.int32)


# --------------------------------------------------------------------------
# continuous-batching engine
# --------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _one_device(mesh) -> None:
    """The engines take the reference's ``mesh`` in its place; the port
    serves on one device until the multi-device work."""
    if mesh is not None:
        raise NotImplementedError("the port serves on one device: mesh must be None")


@dataclasses.dataclass
class EngineMetrics:
    """Engine counters, and the host-clock wall time of every prefill group
    and decode step (each ends in a device sync: the sampled tokens are
    copied to the host)."""

    steps: int = 0
    decode_steps: int = 0
    prefills: int = 0
    active_slot_steps: int = 0
    total_slot_steps: int = 0
    predicted_a2a_s: float = 0.0
    rejected: int = 0  # refused at submit (queue over max_queue_depth)
    deadline_drops: int = 0  # dropped unadmitted past their deadline
    shed_tokens: int = 0  # token budget of all shed requests
    prefill_walls: list = dataclasses.field(default_factory=list)  # (group, bucket, s)
    decode_walls: list = dataclasses.field(default_factory=list)  # (active rows, s)

    @property
    def slot_utilization(self) -> float:
        return self.active_slot_steps / self.total_slot_steps if self.total_slot_steps else 0.0


class ContinuousBatchingEngine:
    """Prefill/decode-interleaved serving over a pooled KV cache.

    Per step: (1) the scheduler admits arrived requests into free slots,
    grouped by power-of-two prompt bucket; each group is one batched prefill
    whose prepared cache rows are written into their slots; (2) one ragged
    decode step advances every active slot; rows that finish (token budget
    or EOS) free their slot for the next admission.

    SSM state has no positional record, so right-padded prefill would
    advance it through pad tokens: only pure-attention stacks are bucketed,
    and a stack with SSM layers prefills each request alone at its exact
    length.  Idle slots of such a stack advance their state on stale tokens
    in every decode step; that is harmless, since admission overwrites every
    leaf of the slot (``KVPool.write``).

    Sampling is deterministic per (seed, request id, token index): results do
    not depend on slot assignment, pool size or admission order.
    """

    def __init__(
        self,
        model: Model,
        params: dict,
        n_slots: int = 8,
        max_len: int = 512,
        mesh=None,
        scheduler: Optional[Scheduler] = None,
        cost_model: Optional[CollectiveCostModel] = None,
        policy: str = "cost_aware",
        seed: int = 0,
        pad_id: int = 0,
        min_prompt_bucket: int = 8,
        audit: bool = False,
        tiers=None,
        max_queue_depth: Optional[int] = None,
        obs=None,
    ):
        _one_device(mesh)
        # the reference's parameters in its order; these wait for the rest of
        # serving (ROADMAP A5)
        for name, on in (("audit", audit), ("tiers", tiers is not None), ("obs", obs is not None)):
            if on:
                raise NotImplementedError(f"{name} is not ported yet (ROADMAP A5)")
        self.model = model
        self.params = model.load(params)
        self.pad_id = pad_id
        self.seed = seed
        self.queue = RequestQueue()
        self.max_queue_depth = max_queue_depth
        self.pool = KVPool(model, n_slots, max_len)
        self.metrics = EngineMetrics()
        self._rid = itertools.count()
        self.requests: dict[int, Request] = {}
        self.min_prompt_bucket = min_prompt_bucket

        cfg = model.cfg
        self._bucket_prompts = all(cfg.layer_is_attention(i) for i in range(cfg.n_layers))
        n_moe_layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        self._dispatch_weight = (
            float(cfg.moe.top_k * cfg.d_model * 2 * n_moe_layers) if cfg.moe is not None else 0.0
        )
        self.scheduler = scheduler or Scheduler(
            SchedulerConfig(policy=policy), cost_model or CollectiveCostModel(),
            d_model=cfg.d_model, top_k=cfg.moe.top_k if cfg.moe else 0,
            n_moe_layers=n_moe_layers,
        )
        self._slot_req: list[Optional[Request]] = [None] * n_slots
        self._tokens = np.zeros((n_slots,), np.int64)
        self._pos = np.zeros((n_slots,), np.int64)

    # ---------------- submission ----------------

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        arrival_time: Optional[float] = None,
        dispatch_weight: Optional[float] = None,
        now: Optional[float] = None,
        session_id: Optional[int] = None,
        deadline: Optional[float] = None,
    ) -> int:
        """Enqueue one request; returns its request id.  Past
        ``max_queue_depth`` the request is rejected (state ``SHED``, no slot)
        and its id is still returned; past ``deadline`` an unadmitted request
        is dropped.  ``session_id`` (tiered sessions) waits for ROADMAP A5."""
        if session_id is not None:
            raise NotImplementedError("session_id is not ported yet (ROADMAP A5)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.pool.capacity:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds pool capacity {self.pool.capacity}"
            )
        req = Request(
            rid=next(self._rid),
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            eos_id=eos_id,
            arrival_time=arrival_time,
            dispatch_weight=(
                self._dispatch_weight if dispatch_weight is None else dispatch_weight
            ),
            deadline=deadline,
            t_submit=now if now is not None else time.monotonic(),
        )
        self.requests[req.rid] = req
        if self.max_queue_depth is not None and len(self.queue) >= self.max_queue_depth:
            req.state = SHED
            self.metrics.rejected += 1
            self.metrics.shed_tokens += req.max_new_tokens
            return req.rid
        self.queue.push(req)
        return req.rid

    # ---------------- serving loop ----------------

    def _bucket(self, length: int) -> int:
        if not self._bucket_prompts:
            return length
        return min(max(_next_pow2(length), self.min_prompt_bucket), self.pool.capacity)

    def _admission_groups(self, picks: list[Request]) -> list[list[Request]]:
        """Group admitted requests by prompt bucket (stable), then split each
        bucket run into power-of-two group sizes.  Stacks with SSM layers
        prefill one request at a time."""
        if not self._bucket_prompts:
            return [[r] for r in picks]
        by_bucket: dict[int, list[Request]] = {}
        for r in picks:
            by_bucket.setdefault(self._bucket(r.prompt_len), []).append(r)
        groups = []
        for bucket in sorted(by_bucket):
            run, i = by_bucket[bucket], 0
            while i < len(run):
                g = 1 << ((len(run) - i).bit_length() - 1)  # largest pow2 <= rest
                groups.append(run[i : i + g])
                i += g
        return groups

    def _seeds(self, rids, idxs) -> list[int]:
        return [stream_seed(self.seed, r, i) for r, i in zip(rids, idxs)]

    def _admit_group(self, group: list[Request], now: float) -> None:
        model = self.model
        slots = [self.pool.allocate(r.rid) for r in group]
        if any(s is None for s in slots):
            raise RuntimeError("admitted more requests than free slots")
        bucket = max(self._bucket(r.prompt_len) for r in group)
        toks = np.full((len(group), bucket), self.pad_id, np.int64)
        for i, r in enumerate(group):
            toks[i, : r.prompt_len] = r.prompt
        true_len = torch.as_tensor([r.prompt_len for r in group], device=model.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches = model.prefill(
                self.params, torch.as_tensor(toks, device=model.device), last_pos=true_len - 1
            )
            caches = model.mask_prompt_cache(caches, true_len)
            caches = model.prepare_decode_caches(caches, capacity=self.pool.capacity)
            self.pool.write(slots, caches)
            firsts = sample_tokens(
                logits[:, 0], [r.temperature for r in group],
                self._seeds([r.rid for r in group], [0] * len(group)),
            )
        self.metrics.prefill_walls.append((len(group), bucket, time.perf_counter() - t0))
        self.metrics.prefills += 1
        for req, slot, tok in zip(group, slots, firsts):
            tok = int(tok)
            req.state = RUNNING
            req.slot = slot
            req.t_admit = now
            req.t_first = now
            req.tokens_out.append(tok)
            self._slot_req[slot] = req
            self._tokens[slot] = tok
            self._pos[slot] = req.prompt_len
            self._maybe_finish(req, tok, now)

    def _maybe_finish(self, req: Request, last_tok: int, now: float) -> None:
        hit_eos = req.eos_id is not None and last_tok == req.eos_id
        if hit_eos or len(req.tokens_out) >= req.max_new_tokens:
            req.state = FINISHED
            req.t_done = now
            self.pool.free(req.slot)
            self._slot_req[req.slot] = None
            req.slot = None

    def _shed_deadlines(self, now: float) -> None:
        expired = [
            r for r in self.queue.arrived(now) if r.deadline is not None and now > r.deadline
        ]
        if not expired:
            return
        self.queue.remove(expired)
        for r in expired:
            r.state = SHED
            self.metrics.shed_tokens += r.max_new_tokens
        self.metrics.deadline_drops += len(expired)

    def _decode(self, now: float) -> int:
        model = self.model
        active = [(s, r) for s, r in enumerate(self._slot_req) if r is not None]
        idxs = [len(r.tokens_out) if r is not None else 0 for r in self._slot_req]
        rids = [r.rid if r is not None else 0 for r in self._slot_req]
        temps = [r.temperature if r is not None else 0.0 for r in self._slot_req]
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = model.decode_step(
                self.params, self.pool.caches,
                torch.as_tensor(self._tokens[:, None], device=model.device),
                torch.as_tensor(self._pos, device=model.device), ragged=True,
            )
            toks = sample_tokens(logits[:, 0], temps, self._seeds(rids, idxs))
        self.metrics.decode_walls.append((len(active), time.perf_counter() - t0))
        self.metrics.decode_steps += 1
        self.metrics.total_slot_steps += self.pool.n_slots
        for slot, req in active:
            tok = int(toks[slot])
            req.tokens_out.append(tok)
            self._tokens[slot] = tok
            self._pos[slot] += 1
            self.metrics.active_slot_steps += 1
            self._maybe_finish(req, tok, now)
        return len(active)

    def step(self, now: Optional[float] = None) -> int:
        """One scheduling round: admit, then one ragged decode step for all
        active slots.  Returns the number of tokens produced."""
        if now is None:
            now = time.monotonic()
        produced = 0
        self._shed_deadlines(now)
        candidates = self.queue.arrived(now) if self.pool.n_free else []
        if candidates:
            n_heavy_active = sum(1 for r in self._slot_req if r is not None and r.moe_heavy)
            picks = self.scheduler.select(candidates, self.pool.n_free, n_heavy_active)
            self.queue.remove(picks)
            for group in self._admission_groups(picks):
                self._admit_group(group, now)
                produced += len(group)
            self.metrics.predicted_a2a_s += self.scheduler.last_step_cost
        if any(r is not None for r in self._slot_req):
            produced += self._decode(now)
        self.metrics.steps += 1
        return produced

    def run(self, clock: Optional[Callable[[], float]] = None,
            max_steps: int = 1_000_000) -> dict[int, np.ndarray]:
        """Drive ``step()`` until queue and slots drain; returns {rid:
        generated tokens}.  ``clock`` gates open-loop arrivals (default
        ``time.monotonic``): with the wall clock an idle engine sleeps until
        the next arrival, with a virtual clock it jumps to it."""
        wall = clock is None
        clock = clock or time.monotonic
        for _ in range(max_steps):
            if not len(self.queue) and not any(r is not None for r in self._slot_req):
                break
            made = self.step(clock())
            if made == 0 and not any(r is not None for r in self._slot_req):
                nxt = self.queue.next_arrival()
                if nxt is not None and clock() < nxt:
                    if wall:
                        while clock() < nxt:
                            time.sleep(min(1e-3, max(nxt - clock(), 0.0)))
                    else:
                        self.step(nxt)
        return {
            rid: np.asarray(r.tokens_out, np.int32) for rid, r in self.requests.items() if r.done
        }

    def generate(self, prompts, max_new_tokens, temperature: float = 0.0,
                 eos_id: Optional[int] = None) -> list[np.ndarray]:
        """Closed-loop convenience: submit ``prompts`` (1-D arrays or a 2-D
        array), run to completion, return outputs in submission order."""
        if isinstance(prompts, np.ndarray) and prompts.ndim == 2:
            prompts = list(prompts)
        budgets = (
            max_new_tokens if isinstance(max_new_tokens, (list, tuple))
            else [max_new_tokens] * len(prompts)
        )
        if len(budgets) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts but {len(budgets)} max_new_tokens entries")
        rids = [self.submit(p, b, temperature=temperature, eos_id=eos_id)
                for p, b in zip(prompts, budgets)]
        out = self.run()
        return [out[r] for r in rids]


# --------------------------------------------------------------------------
# one-shot lockstep engine (the baseline)
# --------------------------------------------------------------------------


class ServingEngine:
    """One-shot batch generator: one prefill over a fixed (left-padded)
    batch, then lockstep decode for a fixed token budget -- the baseline
    continuous batching is measured against.  A stack with SSM layers takes
    unpadded rows of one length: its state would run through the padding."""

    def __init__(self, model: Model, params: dict, max_len: int = 512, mesh=None):
        _one_device(mesh)
        self.model = model
        self.params = model.load(params)
        self.max_len = max_len

    def generate(self, prompts: np.ndarray, max_new_tokens: int, pad_id: int = 0,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """``prompts`` [B, S] int; returns generated tokens [B, max_new_tokens].
        ``pad_id`` is accepted and unused, as in the reference."""
        model = self.model
        b, s = prompts.shape
        temps = [temperature] * b
        with torch.no_grad():
            logits, caches = model.prefill(
                self.params, torch.as_tensor(prompts, dtype=torch.long, device=model.device)
            )
            caches = model.prepare_decode_caches(caches, capacity=self.max_len)
            pos = torch.full((b,), s, dtype=torch.long, device=model.device)
            out = [sample_tokens(logits[:, 0], temps, self._seeds(seed, 0, b))]
            for i in range(max_new_tokens - 1):
                tok = torch.as_tensor(out[-1][:, None], dtype=torch.long, device=model.device)
                logits, caches = model.decode_step(self.params, caches, tok, pos + i)
                out.append(sample_tokens(logits[:, 0], temps, self._seeds(seed, i + 1, b)))
        return np.stack(out, axis=1)

    @staticmethod
    def _seeds(seed: int, step: int, b: int) -> list[int]:
        return [stream_seed(seed, row, step) for row in range(b)]
