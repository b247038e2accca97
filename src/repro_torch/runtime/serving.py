"""Continuous-batching serving: RequestQueue -> Scheduler -> KVPool -> decode.

Counterpart of the JAX package's ``runtime/serving.py``:

* ``RequestQueue`` -- admission-ordered queue of ragged requests.
* ``KVPool`` -- ``n_slots`` cache rows of the model's decode layout,
  allocated per request and reused on completion; ``extract``/``insert``
  move a row to and from the host (the wire format of migrations and of
  the tiered pool).
* ``TieredKVPool`` -- the same pool behind a memory hierarchy: a finished
  session's row is demoted to host instead of discarded, spilled to a
  modeled pooled tier LRU-first when host fills, dropped to its sampling
  metadata past that, and paged back on wakeup, so that a resumed session
  skips its prefill.  Transfers are priced by
  ``CollectiveCostModel.tier_transfer_cost``.
* ``Scheduler`` -- ``fcfs`` or ``cost_aware`` admission (MoE-heavy requests
  are co-scheduled, priced by the collective cost model).
* ``ContinuousBatchingEngine`` -- bucketed, grouped prefill into free slots
  (for stacks with SSM layers: one request at a time at its exact length)
  and one ragged decode step over all active slots per round.
* ``ServingEngine`` -- the one-shot lockstep baseline.

The engine's counters are a view over an ``obs`` metrics registry, and its
prefill, decode and wakeup spans, shed instants and calibration records sit
behind ``obs.enabled`` as in the reference.  Migration onto another device
set waits for the elastic runtime.  Where the JAX engine returns new cache
buffers, this one writes the pool's tensors in place.

With a ``mesh`` (``launch/mesh.py``) every rank runs an engine: the same
host-side queue, scheduler, pool ledger and sampler on each, fed the same
submissions.  Each holds its blocks of the weights (``reshard_params``)
and the pool rows its computation needs (the KV heads, SSM heads and
channels of its place on the ``model`` axis; whole over ``data``), and the
model's entry points give every rank the same logits, so every rank
samples the same tokens.  The scheduler reads one clock on every rank:
each ``step`` (and ``run``'s wait for the next arrival, and ``shed_queue``)
takes rank 0's ``now`` (``mesh_time``, an all-gather of one float), so
open-loop arrivals and deadlines admit and shed alike on every rank; the
submissions' ``arrival_time`` and ``deadline`` are in that clock
(``mesh_time()`` gives a base).  So every rank's scheduler stays in step.
The engine checks that: after each prefill group and decode step the ranks
all-gather a checksum of the tokens they sampled, and a difference raises,
naming the step and the ranks.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import collectives as col
from ..core.cost_model import CollectiveCostModel
from ..models.model import Model
from ..obs import NULL_SPAN, get_obs
from ..obs.metrics import MetricsRegistry, registry_field

__all__ = [
    "Request",
    "RequestQueue",
    "KVPool",
    "TierConfig",
    "SessionRecord",
    "TieredKVPool",
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
    # multi-turn identity on a TieredKVPool engine: on finish the cache row
    # is demoted, and a later request with the same id wakes it up
    session_id: Optional[int] = None
    deadline: Optional[float] = None  # unadmitted past this -> SHED

    state: str = QUEUED
    tokens_out: list = dataclasses.field(default_factory=list)
    deferred: int = 0  # admission rounds the scheduler has deferred this request
    slot: Optional[int] = None
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # sampling identity: a resumed session keeps its first request's id and
    # its token-index offset, so its continuation is the stream of a
    # never-demoted run (set at admission from the session record)
    sample_rid: Optional[int] = None
    idx_base: int = 0
    last_token: Optional[int] = None  # last sampled token (pending decode input)
    # wakeup hint refreshed each admission round: the tier of the request's
    # session (None: cold prefill) and the row bytes its wakeup moves
    resume_tier: Optional[str] = None
    resume_bytes: int = 0

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


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy type of a host row's leaf: bf16 as its 2-byte words (uint16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _host_leaf(leaf, like: torch.Tensor) -> np.ndarray:
    """A host row's leaf, checked against the pool leaf ``like`` it goes
    into: its words must be of ``like``'s type (bf16 as uint16)."""
    leaf = np.ascontiguousarray(leaf)
    if leaf.dtype != _np_dtype(like.dtype):
        raise ValueError(f"row leaf of {leaf.dtype} for a pool leaf of {like.dtype}")
    return leaf


def _to_device_leaf(leaf, like: torch.Tensor) -> torch.Tensor:
    """A cache leaf (a tensor, or a host row's numpy array) in ``like``'s
    dtype on its device."""
    if isinstance(leaf, np.ndarray):
        t = torch.from_numpy(_host_leaf(leaf, like))
        leaf = t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t
    return leaf.to(device=like.device, dtype=like.dtype)


class KVPool:
    """``n_slots`` fixed-size KV-cache rows, allocated per request and freed
    for reuse on completion.  The pooled cache is the model's decode layout
    (``[n_layers, n_slots, L, ...]``, batch on dim 1); each slot holds
    ``capacity`` ring entries (SWA layers ``min(capacity, window)``).  Freed
    slots are reused LIFO.

    A row on the host (``extract``) is a dict of numpy arrays of the pool's
    own layout with batch dim 1, bf16 leaves as their ``uint16`` words."""

    tiered = False  # TieredKVPool overrides; the engine branches on this
    _ALIGN = 16  # bytes: alignment of each leaf in a packed transfer buffer

    def __init__(self, model: Model, n_slots: int, capacity: int, *, mesh=None):
        if n_slots < 1:
            raise ValueError("KVPool needs at least one slot")
        self.model = model
        self.n_slots = n_slots
        self.capacity = capacity
        self.caches = model.init_cache(n_slots, capacity, mesh=mesh)  # this rank's rows
        self._free: list[int] = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0 first
        self.slot_rid: list[Optional[int]] = [None] * n_slots
        self.n_alloc = 0
        self.n_evict = 0
        self.high_water = 0
        # (name, a row's shape without its batch dim, bytes, byte offset) of
        # each leaf in a packed row of _row_bytes bytes
        self._layout = []
        off = 0
        for name, t in self.caches.items():
            nbytes = t[:, 0].numel() * t.element_size()
            self._layout.append((name, (t.shape[0],) + tuple(t.shape[2:]), nbytes, off))
            off += -(-nbytes // self._ALIGN) * self._ALIGN
        self._row_bytes = off

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free)

    # a plain pool holds sessions only while they occupy a slot
    @property
    def resident_sessions(self) -> int:
        return self.n_used

    @property
    def demoted_sessions(self) -> int:
        return 0

    def active_slots(self) -> list[int]:
        return [s for s, r in enumerate(self.slot_rid) if r is not None]

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

    def write(self, slot, one_caches: dict) -> None:
        """Install prepared decode caches into row ``slot`` (the reference's
        call: one slot, batch-1 caches) or into the rows of a list of slots
        (batch ``len(slot)``), in place.  Leaves are tensors or a host row's
        numpy arrays."""
        slots = [int(slot)] if isinstance(slot, (int, np.integer)) else list(slot)
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.model.device)
        for name, pool_t in self.caches.items():
            pool_t[:, idx] = _to_device_leaf(one_caches[name], pool_t)

    # -------- the wire format: rows to and from the host --------

    def _check_allocated(self, slots: Sequence[int], hint: str = "") -> None:
        for s in slots:
            if self.slot_rid[s] is None:
                raise ValueError(f"slot {s} is not allocated{hint}")

    def extract(self, slot: int) -> dict:
        """Copy ``slot``'s live row out to the host; ``extract`` then
        ``insert`` round-trips bit for bit."""
        return self.extract_all([slot])[0]

    def insert(self, slot: int, row: dict) -> None:
        """Install an extracted row into (allocated) ``slot``: the inverse of
        :meth:`extract`."""
        self._check_allocated([slot], " -- allocate before insert")
        self.write(slot, row)

    def extract_all(self, slots: Sequence[int]) -> list[dict]:
        """Extract many rows with one device-to-host copy: each leaf's rows
        are gathered into one packed device buffer, which crosses once, and
        the rows are cut out of it on the host (views into its copy)."""
        self._check_allocated(slots)
        if not slots:
            return []
        k, dev = len(slots), self.model.device
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
        packed = torch.empty((k, self._row_bytes), dtype=torch.uint8, device=dev)
        for name, shape, nbytes, off in self._layout:
            t = self.caches[name]
            dst = packed[:, off:off + nbytes].view(t.dtype).view((k,) + shape)
            dst.copy_(t.index_select(1, idx).movedim(1, 0))
        host = packed.cpu().numpy()
        return [
            {name: host[i, off:off + nbytes].view(_np_dtype(self.caches[name].dtype))
             .reshape((shape[0], 1) + shape[1:])
             for name, shape, nbytes, off in self._layout}
            for i in range(k)
        ]

    def insert_all(self, slots: Sequence[int], rows: Sequence[dict]) -> None:
        """Install many extracted rows with one host-to-device copy: the rows
        are packed on the host, cross once, and each leaf is scattered into
        its slots -- the inverse of :meth:`extract_all`."""
        if len(slots) != len(rows):
            raise ValueError(f"{len(slots)} slots but {len(rows)} rows")
        if not slots:
            return
        self._check_allocated(slots, " -- allocate before insert")
        k, dev = len(slots), self.model.device
        host = np.empty((k, self._row_bytes), np.uint8)
        for i, row in enumerate(rows):
            for name, _, nbytes, off in self._layout:
                leaf = _host_leaf(row[name], self.caches[name])
                host[i, off:off + nbytes] = leaf.reshape(-1).view(np.uint8)
        packed = torch.from_numpy(host).to(dev)
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
        for name, shape, nbytes, off in self._layout:
            t = self.caches[name]
            t[:, idx] = packed[:, off:off + nbytes].view(t.dtype).view((k,) + shape).movedim(0, 1)

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
# tiered memory hierarchy: HBM slots -> host rows -> modeled pooled tier
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Capacities of the demoted-session tiers.

    host_sessions    cache rows kept in host memory (numpy rows: a wakeup
                     pays one host-to-device insert)
    pooled_sessions  rows spilled onward to the modeled pooled tier (they
                     stay in host memory in this process; the extra
                     pooled<->host hop is priced, not performed)
    """

    host_sessions: int = 64
    pooled_sessions: int = 256

    def __post_init__(self):
        if self.host_sessions < 0 or self.pooled_sessions < 0:
            raise ValueError("tier capacities must be >= 0")


@dataclasses.dataclass
class SessionRecord:
    """A demoted session: what resuming its decode needs.  ``row`` is the
    :meth:`KVPool.extract` wire format; ``pos``/``last_token`` restore the
    ring position and the pending decode input; ``sample_rid``/``idx_base``
    pin the sampling stream, also for a cold resume after the row was
    dropped."""

    sid: int
    pos: int
    last_token: int
    sample_rid: int
    idx_base: int
    tier: str = "host"  # "host" | "pooled" | "dropped"
    row: object = None  # None once dropped (metadata only)
    nbytes: int = 0


class TieredKVPool(KVPool):
    """A :class:`KVPool` whose evictions feed a memory hierarchy: HBM slots
    (active decode) -> host rows (demoted sessions, LRU) -> a modeled pooled
    tier -> metadata only (dropped).

    * :meth:`demote` extracts a finishing slot's row to the host ledger;
      host overflow spills the least recently demoted row to the pooled
      tier, pooled overflow drops the row and keeps the sampling metadata
      (a later wakeup then re-prefills cold, on the same sampling stream).
    * :meth:`promote` pages a resident row back into a free slot (a pooled
      row pays the modeled pooled->host hop first).
    * every transfer is priced by ``CollectiveCostModel.tier_transfer_cost``
      and summed in ``modeled_tier_s``.
    """

    tiered = True

    def __init__(self, model: Model, n_slots: int, capacity: int,
                 tiers: TierConfig = TierConfig(),
                 cost_model: Optional[CollectiveCostModel] = None, obs=None, *, mesh=None):
        super().__init__(model, n_slots, capacity, mesh=mesh)
        self.tiers = tiers
        self.cost_model = cost_model or CollectiveCostModel()
        self._obs = obs if obs is not None else get_obs()
        self.host: OrderedDict[int, SessionRecord] = OrderedDict()
        self.pooled: OrderedDict[int, SessionRecord] = OrderedDict()
        self.dropped: dict[int, SessionRecord] = {}
        self.n_demote = 0
        self.n_promote = 0
        self.n_spill = 0
        self.n_refill = 0
        self.n_drop = 0
        self.modeled_tier_s = 0.0

    # ---------------- residency accounting ----------------

    @property
    def resident_sessions(self) -> int:
        """Sessions whose row is held somewhere: a slot, host or pooled."""
        return self.n_used + len(self.host) + len(self.pooled)

    @property
    def demoted_sessions(self) -> int:
        return len(self.host) + len(self.pooled)

    def _account(self, nbytes: int, src: str, dst: str) -> None:
        self.modeled_tier_s += self.cost_model.tier_transfer_cost(nbytes, src, dst)

    def session_tier(self, sid: int) -> Optional[str]:
        rec = self.lookup(sid)
        return rec.tier if rec is not None else None

    def lookup(self, sid: int) -> Optional[SessionRecord]:
        return self.host.get(sid) or self.pooled.get(sid) or self.dropped.get(sid)

    # ---------------- demotion / promotion ----------------

    def demote(self, slot: int, rec: SessionRecord) -> SessionRecord:
        """Evict ``slot`` into the hierarchy: extract its row to the host,
        free the slot, and spill LRU-first past the tier caps."""
        obs = self._obs
        t0 = time.monotonic()
        rec.row = self.extract(slot)  # ends in the device-to-host copy
        rec.nbytes = int(sum(leaf.nbytes for leaf in rec.row.values()))
        if obs.enabled:
            # calibration: the hbm->host price the hierarchy bills against
            # the extract's wall
            obs.calibration.observe(
                obs.calibration.record(
                    "tier_transfer",
                    self.cost_model.tier_transfer_cost(rec.nbytes, "hbm", "host"),
                    note="demote hbm->host",
                ),
                time.monotonic() - t0,
            )
            obs.tracer.instant("demote", "serve", sid=rec.sid, nbytes=rec.nbytes)
        self.free(slot)
        # a re-demoted session id supersedes any stale ledger entry
        self.host.pop(rec.sid, None)
        self.pooled.pop(rec.sid, None)
        self.dropped.pop(rec.sid, None)
        rec.tier = "host"
        self.host[rec.sid] = rec
        self.n_demote += 1
        self._account(rec.nbytes, "hbm", "host")
        while len(self.host) > self.tiers.host_sessions:
            sid, cold = self.host.popitem(last=False)  # least recently demoted
            cold.tier = "pooled"
            self.pooled[sid] = cold
            self.n_spill += 1
            self._account(cold.nbytes, "host", "pooled")
        while len(self.pooled) > self.tiers.pooled_sessions:
            sid, cold = self.pooled.popitem(last=False)
            cold.tier = "dropped"
            cold.row = None
            self.dropped[sid] = cold
            self.n_drop += 1
        return rec

    def promote(self, sid: int, rid: int) -> tuple[int, SessionRecord]:
        """Page session ``sid`` back into a newly allocated slot for request
        ``rid``; returns (slot, record).  The caller guarantees a free slot."""
        rec = self.host.pop(sid, None)
        if rec is None:
            rec = self.pooled.pop(sid, None)
            if rec is None:
                raise KeyError(f"session {sid} has no resident row to promote")
            self.n_refill += 1
            self._account(rec.nbytes, "pooled", "host")
        slot = self.allocate(rid)
        if slot is None:
            raise RuntimeError("promote called with no free slot")
        self.insert(slot, rec.row)
        self._account(rec.nbytes, "host", "hbm")
        self.n_promote += 1
        rec.row = None
        rec.tier = "hbm"
        return slot, rec

    def claim_dropped(self, sid: int) -> Optional[SessionRecord]:
        """Take the metadata-only record of a dropped session (a cold resume
        re-prefills but keeps the sampling identity)."""
        return self.dropped.pop(sid, None)

    def adopt(self, old: "TieredKVPool") -> None:
        """Carry the demoted ledgers and their counters over from the pool
        being replaced: host rows do not depend on the device set."""
        self.host = old.host
        self.pooled = old.pooled
        self.dropped = old.dropped
        self.n_demote = old.n_demote
        self.n_promote = old.n_promote
        self.n_spill = old.n_spill
        self.n_refill = old.n_refill
        self.n_drop = old.n_drop
        self.modeled_tier_s = old.modeled_tier_s

    def check(self) -> None:
        """Slot invariants plus the ledgers': a session lives in one ledger,
        resident tiers hold rows (dropped holds none), and no ledger exceeds
        its capacity."""
        super().check()
        sids = list(self.host) + list(self.pooled) + list(self.dropped)
        if len(sids) != len(set(sids)):
            raise AssertionError(f"session in two tiers: {sorted(sids)}")
        for name, ledger in (("host", self.host), ("pooled", self.pooled)):
            for sid, rec in ledger.items():
                if rec.row is None:
                    raise AssertionError(f"{name} session {sid} lost its row")
                if rec.tier != name:
                    raise AssertionError(
                        f"session {sid} in {name} ledger but tagged {rec.tier!r}"
                    )
        for sid, rec in self.dropped.items():
            if rec.row is not None:
                raise AssertionError(f"dropped session {sid} still holds a row")
        for name, ledger, cap in (("host", self.host, self.tiers.host_sessions),
                                  ("pooled", self.pooled, self.tiers.pooled_sessions)):
            if len(ledger) > cap:
                raise AssertionError(f"{name} ledger over capacity: {len(ledger)} > {cap}")


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

    def admission_cost(self, r: Request) -> float:
        """Seconds to get ``r`` decoding: waking a tier-resident session pays
        the priced row transfer, anything else a modeled cold prefill."""
        if r.resume_tier is not None:
            return self.cost_model.wakeup_cost(r.resume_bytes, r.resume_tier)
        return self.cost_model.cold_prefill_cost(r.prompt_len)

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
        # when a candidate can be woken, order each class by admission cost
        # (stable: rounds of cold requests only keep arrival order)
        if any(r.resume_tier is not None for r in candidates):
            heavy = sorted(heavy, key=self.admission_cost)
            light = sorted(light, key=self.admission_cost)
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


def _sent(mesh) -> dict:
    return {} if mesh is None else dict(mesh.sent)


def _sent_since(mesh, before: dict) -> dict:
    """The bytes the rank sent since ``before`` (``_sent``), by group."""
    return {k: v - before.get(k, 0) for k, v in _sent(mesh).items() if v != before.get(k, 0)}


def _agree(mesh, toks: np.ndarray, device: torch.device, what: str) -> None:
    """Raise unless every rank of ``mesh`` sampled ``toks``: one all-gather
    of a checksum of them (the tokens weighted by their place)."""
    if mesh is None or mesh.size == 1:
        return
    t = torch.as_tensor(np.asarray(toks, np.int64).reshape(-1), device=device)
    mine = (t * torch.arange(1, t.numel() + 1, device=device)).sum().reshape(1)
    sums = col.all_gather(mine, mesh.axis_names, mesh=mesh).reshape(-1).tolist()
    bad = [r for r, v in enumerate(sums) if v != sums[0]]
    if bad:
        raise RuntimeError(f"ranks {bad} of the mesh sampled other tokens than rank 0 at {what} "
                           f"(checksums {sums})")


def _rank0_time(mesh, now: float, device: torch.device) -> float:
    """``now`` as rank 0 of ``mesh`` has it: one all-gather of a float64,
    so that every rank schedules by one clock."""
    if mesh is None or mesh.size == 1:
        return now
    t = torch.tensor([now], dtype=torch.float64, device=device)
    return float(col.all_gather(t, mesh.axis_names, mesh=mesh).reshape(-1)[0])


class EngineMetrics:
    """Engine counters as a view over a
    :class:`~repro_torch.obs.metrics.MetricsRegistry`: each field is a
    property over the ``serve.engine.*`` metric of the same name.  Built
    without a registry it makes a private one.  Beside the view, the
    host-clock wall time of every prefill group and decode step (each ends
    in a device sync: the sampled tokens are copied to the host) and, on a
    mesh, the bytes the rank sent in each, by group of axes."""

    _SCALARS = (
        ("steps", 0),
        ("decode_steps", 0),
        ("prefills", 0),
        ("active_slot_steps", 0),
        ("total_slot_steps", 0),
        ("predicted_a2a_s", 0.0),
        # tiered pooling (TieredKVPool engines only)
        ("demotions", 0),  # finished sessions parked in the hierarchy
        ("wakeups", 0),  # resumes served from a resident row (no prefill)
        ("cold_resumes", 0),  # resumes whose row was dropped (re-prefilled)
        ("rejected", 0),  # refused at submit (queue over max_queue_depth) or shed
        ("deadline_drops", 0),  # dropped unadmitted past their deadline
        ("shed_tokens", 0),  # token budget of all shed requests
    )

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = MetricsRegistry() if registry is None else registry
        for name, default in self._SCALARS:
            # reset, not get-or-create: a shared registry starts from zero
            self.registry.counter(f"serve.engine.{name}", default).value = default
        self.prefill_walls: list = []  # (group, bucket, s)
        self.decode_walls: list = []  # (active rows, s)
        # on a mesh, the bytes this rank sent in each prefill group and
        # decode step, by group of axes (the mesh's ``sent`` counter)
        self.prefill_sent: list = []
        self.decode_sent: list = []

    @property
    def slot_utilization(self) -> float:
        return self.active_slot_steps / self.total_slot_steps if self.total_slot_steps else 0.0


for _name, _default in EngineMetrics._SCALARS:
    setattr(EngineMetrics, _name, registry_field(f"serve.engine.{_name}"))
del _name, _default


def _sync(device: torch.device) -> None:
    """Wait for the card, so that a host-clock wall covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ContinuousBatchingEngine:
    """Prefill/decode-interleaved serving over a pooled KV cache.

    Per step: (1) the scheduler admits arrived requests into free slots,
    grouped by power-of-two prompt bucket; each group is one batched prefill
    whose prepared cache rows are written into their slots, and a request
    whose session is tier-resident is woken instead (its row paged back, no
    prefill); (2) one ragged decode step advances every active slot; rows
    that finish (token budget or EOS) free their slot for the next
    admission, or demote it into the hierarchy when they carry a session.

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
        tiers: Optional[TierConfig] = None,
        max_queue_depth: Optional[int] = None,
        obs=None,
    ):
        if model.cfg.enc_dec:  # the reference's refusal, before anything is built
            raise NotImplementedError("continuous batching supports decoder-only models")
        model.check_mesh(mesh)
        self.model = model
        self.mesh = mesh
        self.params = model.load(params)
        self.pad_id = pad_id
        self.seed = seed
        # the observability bundle: NULL_OBS unless a launcher installed one;
        # every hot-path hook hides behind its `enabled` attribute
        self._obs = obs if obs is not None else get_obs()
        self.queue = RequestQueue()
        self.max_queue_depth = max_queue_depth
        # tiers=TierConfig(...) turns on the memory hierarchy: finished
        # sessions demote to host/pooled and wake up via submit(session_id=)
        self.tiers = tiers
        self._cost_model = cost_model or CollectiveCostModel()
        self.pool = self._make_pool(n_slots, max_len)
        self.metrics = EngineMetrics(
            registry=self._obs.registry if self._obs.enabled else None
        )
        self._rid = itertools.count()
        self.requests: dict[int, Request] = {}
        self._busy_sessions: set[int] = set()  # one in-flight request per session
        self.min_prompt_bucket = min_prompt_bucket

        cfg = model.cfg
        self._bucket_prompts = all(cfg.layer_is_attention(i) for i in range(cfg.n_layers))
        n_moe_layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        self._dispatch_weight = (
            float(cfg.moe.top_k * cfg.d_model * 2 * n_moe_layers) if cfg.moe is not None else 0.0
        )
        self.scheduler = scheduler or Scheduler(
            SchedulerConfig(policy=policy), self._cost_model,
            d_model=cfg.d_model, top_k=cfg.moe.top_k if cfg.moe else 0,
            n_moe_layers=n_moe_layers,
        )
        # paused admission, and the (rid, token index) audit trail of every
        # produced token (opt-in: it grows one tuple a token)
        self._paused = False
        self.audit_enabled = audit
        self.audit: list[tuple[int, int]] = []
        self._slot_req: list[Optional[Request]] = [None] * n_slots
        self._tokens = np.zeros((n_slots,), np.int64)
        self._pos = np.zeros((n_slots,), np.int64)

    def _make_pool(self, n_slots: int, capacity: int) -> KVPool:
        if self.tiers is not None:
            return TieredKVPool(self.model, n_slots, capacity, self.tiers,
                                cost_model=self._cost_model, obs=self._obs, mesh=self.mesh)
        return KVPool(self.model, n_slots, capacity, mesh=self.mesh)

    def absorb_pool_metrics(self, registry: Optional[MetricsRegistry] = None) -> None:
        """Refresh the ``serve.pool.*`` counters of ``registry`` (default: the
        metrics' registry) from the live pool; last write wins, so calling
        again updates rather than duplicates."""
        reg = registry if registry is not None else self.metrics.registry
        pool = self.pool
        stats = {"n_slots": pool.n_slots, "n_alloc": pool.n_alloc,
                 "n_evict": pool.n_evict, "high_water": pool.high_water}
        if pool.tiered:
            stats.update(
                n_demote=pool.n_demote, n_promote=pool.n_promote,
                n_spill=pool.n_spill, n_refill=pool.n_refill,
                n_drop=pool.n_drop, modeled_tier_s=pool.modeled_tier_s,
                resident_sessions=pool.resident_sessions,
                demoted_sessions=pool.demoted_sessions,
            )
        reg.absorb("serve.pool", stats)

    def mesh_time(self, now: Optional[float] = None) -> float:
        """``now`` (default ``time.monotonic()``) as rank 0 of the mesh has
        it, the clock that ``step`` schedules by; ``now`` itself without a
        mesh.  On a mesh a collective call: every rank calls it at the same
        point."""
        return _rank0_time(self.mesh, time.monotonic() if now is None else now,
                           self.model.device)

    # ---------------- admission control ----------------

    def pause_admission(self) -> None:
        """Stop admitting queued requests; active slots keep decoding."""
        self._paused = True

    def resume_admission(self) -> None:
        self._paused = False

    def active_requests(self) -> list[Request]:
        return [r for r in self._slot_req if r is not None]

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
        """Enqueue one request; returns its request id.

        ``session_id`` (tiered engines): a caller-chosen identity.  When the
        first request of a session finishes, its cache row demotes into the
        hierarchy.  A later request with the same id resumes it: ``prompt``
        must then be the session's whole history (prompt and every token
        generated so far), and admission pages the resident row back in
        with no prefill, or re-prefills the history if the row was dropped;
        either way on the session's sampling stream.  One request may be in
        flight per session.

        Past ``max_queue_depth`` the request is rejected (state ``SHED``, no
        slot, no session reserved) and its id is still returned; past
        ``deadline`` an unadmitted request is dropped."""
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
        t_submit = now if now is not None else time.monotonic()
        if self.max_queue_depth is not None and len(self.queue) >= self.max_queue_depth:
            req = Request(
                rid=next(self._rid), prompt=prompt, max_new_tokens=int(max_new_tokens),
                temperature=float(temperature), eos_id=eos_id, arrival_time=arrival_time,
                session_id=session_id, deadline=deadline, state=SHED, t_submit=t_submit,
            )
            self.requests[req.rid] = req
            self.metrics.rejected += 1
            self.metrics.shed_tokens += req.max_new_tokens
            return req.rid
        if session_id is not None and self.pool.tiered:
            if session_id in self._busy_sessions:
                raise ValueError(f"session {session_id} already has a request in flight")
            rec = self.pool.lookup(session_id)
            if rec is not None and prompt.size != rec.pos + 1:
                raise ValueError(
                    f"resume of session {session_id} must carry its full "
                    f"token history ({rec.pos + 1} tokens), got {prompt.size}"
                )
            self._busy_sessions.add(session_id)
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
            session_id=session_id,
            deadline=deadline,
            t_submit=t_submit,
        )
        self.requests[req.rid] = req
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
        for r in group:
            if r.sample_rid is None:
                r.sample_rid = r.rid
        bucket = max(self._bucket(r.prompt_len) for r in group)
        toks = np.full((len(group), bucket), self.pad_id, np.int64)
        for i, r in enumerate(group):
            toks[i, : r.prompt_len] = r.prompt
        true_len = torch.as_tensor([r.prompt_len for r in group], device=model.device)
        obs = self._obs
        span = (obs.tracer.span("prefill", "serve", group=len(group), bucket=bucket)
                if obs.enabled else NULL_SPAN)
        t0, sent = time.perf_counter(), _sent(self.mesh)
        with span, torch.no_grad():
            logits, caches = model.prefill(
                self.params, torch.as_tensor(toks, device=model.device), mesh=self.mesh,
                last_pos=true_len - 1
            )
            caches = model.mask_prompt_cache(caches, true_len)
            caches = model.prepare_decode_caches(caches, capacity=self.pool.capacity)
            self.pool.write(slots, caches)
            # idx_base: 0 for a fresh request, the session's token count for
            # a cold resume, so that its stream goes on where it stopped
            firsts = sample_tokens(
                logits[:, 0], [r.temperature for r in group],
                self._seeds([r.sample_rid for r in group], [r.idx_base for r in group]),
            )
            _agree(self.mesh, firsts, model.device,
                   f"prefill {self.metrics.prefills} (requests {[r.rid for r in group]})")
        wall = time.perf_counter() - t0
        self.metrics.prefill_walls.append((len(group), bucket, wall))
        if self.mesh is not None:
            self.metrics.prefill_sent.append(_sent_since(self.mesh, sent))
        self.metrics.prefills += 1
        if obs.enabled:
            # calibration: the modeled cold-prefill price of the group against
            # its wall (which ends in the sampled tokens' copy to the host)
            obs.calibration.observe(
                obs.calibration.record(
                    "cold_prefill",
                    sum(self.scheduler.cost_model.cold_prefill_cost(r.prompt_len)
                        for r in group),
                    note=f"group={len(group)}",
                ),
                wall,
            )
        for req, slot, tok in zip(group, slots, firsts):
            tok = int(tok)
            req.state = RUNNING
            req.slot = slot
            req.t_admit = now
            req.t_first = now
            req.tokens_out.append(tok)
            req.last_token = tok
            if self.audit_enabled:
                self.audit.append((req.rid, 0))
            self._slot_req[slot] = req
            self._tokens[slot] = tok
            self._pos[slot] = req.prompt_len
            self._maybe_finish(req, tok, now)

    def _admit_resume(self, req: Request, now: float) -> None:
        """Wake a tier-resident session: page its row into a free slot and
        resume decode where it stopped, with no prefill.  The first new
        token comes from the next decode step (``t_first`` is stamped then)."""
        obs = self._obs
        if obs.enabled:
            # calibration: the wakeup price admission used, beside the cold
            # prefill it displaced; observed is the promote's wall
            cost = self.scheduler.cost_model
            cal = obs.calibration.record(
                "wakeup", cost.wakeup_cost(req.resume_bytes, req.resume_tier or "host"),
                alternative_s=cost.cold_prefill_cost(req.prompt_len),
                chosen="wakeup", note=req.resume_tier or "host",
            )
            with obs.tracer.span("wakeup", "serve", sid=req.session_id, tier=req.resume_tier):
                t0 = time.monotonic()
                slot, rec = self.pool.promote(req.session_id, req.rid)
                _sync(self.model.device)
                obs.calibration.observe(cal, time.monotonic() - t0)
        else:
            slot, rec = self.pool.promote(req.session_id, req.rid)
        req.state = RUNNING
        req.slot = slot
        req.t_admit = now
        req.sample_rid = rec.sample_rid
        req.idx_base = rec.idx_base
        req.last_token = rec.last_token
        self._slot_req[slot] = req
        self._tokens[slot] = rec.last_token
        self._pos[slot] = rec.pos
        self.metrics.wakeups += 1

    def _maybe_finish(self, req: Request, last_tok: int, now: float) -> None:
        hit_eos = req.eos_id is not None and last_tok == req.eos_id
        if hit_eos or len(req.tokens_out) >= req.max_new_tokens:
            req.state = FINISHED
            req.t_done = now
            slot = req.slot
            if req.session_id is not None and self.pool.tiered:
                # park the session in the hierarchy: a wakeup resumes from here
                self.pool.demote(slot, SessionRecord(
                    sid=req.session_id, pos=int(self._pos[slot]),
                    last_token=int(self._tokens[slot]), sample_rid=req.sample_rid,
                    idx_base=req.idx_base + len(req.tokens_out),
                ))
                self.metrics.demotions += 1
            else:
                self.pool.free(slot)
            if req.session_id is not None:
                self._busy_sessions.discard(req.session_id)
            self._slot_req[slot] = None
            req.slot = None

    def _shed_queued(self, reqs: list, *, deadline: bool) -> int:
        """Drop still-queued requests: take them off the queue, mark them
        ``SHED`` and release their session reservations.  A queued request
        holds no slot, so the pool has nothing to free."""
        victims = [r for r in reqs if r.state == QUEUED]
        if not victims:
            return 0
        self.queue.remove(victims)
        for r in victims:
            r.state = SHED
            self.metrics.shed_tokens += r.max_new_tokens
            if r.session_id is not None:
                self._busy_sessions.discard(r.session_id)
        if deadline:
            self.metrics.deadline_drops += len(victims)
        else:
            self.metrics.rejected += len(victims)
        if self._obs.enabled:
            self._obs.tracer.instant("shed", "serve", n=len(victims), deadline=deadline)
        return len(victims)

    def shed_queue(self, keep_depth: int, now: Optional[float] = None) -> int:
        """Shed the newest queued requests until at most ``keep_depth``
        remain in the arrived backlog (the oldest have waited longest).
        ``now=None`` sheds against the whole queue, pending arrivals
        included (on a mesh, rank 0's ``now``).  Returns the number shed."""
        backlog = self.queue.arrived(None if now is None else self.mesh_time(now))
        excess = len(backlog) - max(keep_depth, 0)
        if excess <= 0:
            return 0
        return self._shed_queued(backlog[len(backlog) - excess:], deadline=False)

    def _decode(self, now: float) -> int:
        model = self.model
        active = [(s, r) for s, r in enumerate(self._slot_req) if r is not None]
        idxs = [r.idx_base + len(r.tokens_out) if r is not None else 0 for r in self._slot_req]
        rids = [r.sample_rid if r is not None else 0 for r in self._slot_req]
        temps = [r.temperature if r is not None else 0.0 for r in self._slot_req]
        obs = self._obs
        t0, sent = time.perf_counter(), _sent(self.mesh)
        with (obs.tracer.span("decode", "serve") if obs.enabled else NULL_SPAN), \
                torch.no_grad():
            logits, _ = model.decode_step(
                self.params, self.pool.caches,
                torch.as_tensor(self._tokens[:, None], device=model.device),
                torch.as_tensor(self._pos, device=model.device), mesh=self.mesh, ragged=True,
            )
            toks = sample_tokens(logits[:, 0], temps, self._seeds(rids, idxs))
            _agree(self.mesh, toks, model.device, f"decode step {self.metrics.decode_steps}")
        self.metrics.decode_walls.append((len(active), time.perf_counter() - t0))
        if self.mesh is not None:
            self.metrics.decode_sent.append(_sent_since(self.mesh, sent))
        self.metrics.decode_steps += 1
        self.metrics.total_slot_steps += self.pool.n_slots
        for slot, req in active:
            tok = int(toks[slot])
            if self.audit_enabled:
                self.audit.append((req.rid, len(req.tokens_out)))
            req.tokens_out.append(tok)
            req.last_token = tok
            if req.t_first is None:
                req.t_first = now  # a woken session skipped its prefill
            self._tokens[slot] = tok
            self._pos[slot] += 1
            self.metrics.active_slot_steps += 1
            self._maybe_finish(req, tok, now)
        return len(active)

    def step(self, now: Optional[float] = None) -> int:
        """One scheduling round: deadline drops, admission (wakeups and
        prefill groups), then one ragged decode step for all active slots.
        Returns the number of tokens produced.  On a mesh ``now`` (default
        the wall clock) is rank 0's (``mesh_time``)."""
        now = self.mesh_time(now)
        produced = 0
        if self._obs.enabled:
            self._obs.tracer.step = self.metrics.steps
        expired = [r for r in self.queue.arrived(now)
                   if r.deadline is not None and now > r.deadline]
        if expired:
            self._shed_queued(expired, deadline=True)
        candidates = [] if self._paused or not self.pool.n_free else self.queue.arrived(now)
        if candidates:
            tiered = self.pool.tiered
            if tiered:
                # refresh each session request's wakeup hint: other demotions
                # can spill its row between rounds
                for r in candidates:
                    if r.session_id is not None:
                        rec = self.pool.lookup(r.session_id)
                        resident = rec is not None and rec.row is not None
                        r.resume_tier = rec.tier if resident else None
                        r.resume_bytes = rec.nbytes if resident else 0
            n_heavy_active = sum(1 for r in self._slot_req if r is not None and r.moe_heavy)
            picks = self.scheduler.select(candidates, self.pool.n_free, n_heavy_active)
            self.queue.remove(picks)
            cold: list[Request] = []
            for r in picks:
                if tiered and r.session_id is not None:
                    if self.pool.session_tier(r.session_id) in ("host", "pooled"):
                        self._admit_resume(r, now)  # wakeup: no prefill
                        continue
                    rec = self.pool.claim_dropped(r.session_id)
                    if rec is not None:
                        # the row was dropped: re-prefill the whole history on
                        # the session's sampling stream
                        r.sample_rid = rec.sample_rid
                        r.idx_base = rec.idx_base
                        self.metrics.cold_resumes += 1
                cold.append(r)
            for group in self._admission_groups(cold):
                self._admit_group(group, now)
                produced += len(group)
            self.metrics.predicted_a2a_s += self.scheduler.last_step_cost
        if any(r is not None for r in self._slot_req):
            produced += self._decode(now)
        self.metrics.steps += 1
        return produced

    def run(self, clock: Optional[Callable[[], float]] = None,
            max_steps: int = 1_000_000) -> dict[int, np.ndarray]:
        """Drive ``step()`` until queue and slots drain, or until nothing can
        progress while admission is paused; returns {rid: generated tokens}.
        ``clock`` gates open-loop arrivals (default ``time.monotonic``):
        with the wall clock an idle engine sleeps until the next arrival,
        with a virtual clock it jumps to it.  On a mesh every rank reads
        rank 0's clock (``mesh_time``), so all wait and step alike."""
        wall = clock is None
        clock = clock or time.monotonic
        for _ in range(max_steps):
            if not len(self.queue) and not any(r is not None for r in self._slot_req):
                break
            made = self.step(clock())
            if made == 0 and not any(r is not None for r in self._slot_req):
                if self._paused:
                    break  # admission paused and nothing active: no progress
                nxt = self.queue.next_arrival()
                if nxt is None:
                    continue
                now = self.mesh_time(clock())
                if now < nxt:
                    if wall:
                        time.sleep(nxt - now)
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
        model.check_mesh(mesh)
        self.model = model
        self.mesh = mesh
        self.params = model.load(params)
        self.max_len = max_len

    def generate(self, prompts: np.ndarray, max_new_tokens: int, pad_id: int = 0,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """``prompts`` [B, S] int; returns generated tokens [B, max_new_tokens].
        ``pad_id`` is accepted and unused, as in the reference, which also
        refuses an encoder-decoder here (its engine builds, as this one
        does)."""
        model = self.model
        b, s = prompts.shape
        if model.cfg.enc_dec:
            raise NotImplementedError("use generate_enc_dec for encoder-decoder models")
        temps = [temperature] * b
        with torch.no_grad():
            logits, caches = model.prefill(
                self.params, torch.as_tensor(prompts, dtype=torch.long, device=model.device),
                mesh=self.mesh,
            )
            caches = model.prepare_decode_caches(caches, capacity=self.max_len)
            pos = torch.full((b,), s, dtype=torch.long, device=model.device)
            out = [sample_tokens(logits[:, 0], temps, self._seeds(seed, 0, b))]
            _agree(self.mesh, out[-1], model.device, "the prefill")
            for i in range(max_new_tokens - 1):
                tok = torch.as_tensor(out[-1][:, None], dtype=torch.long, device=model.device)
                logits, caches = model.decode_step(self.params, caches, tok, pos + i,
                                                   mesh=self.mesh)
                out.append(sample_tokens(logits[:, 0], temps, self._seeds(seed, i + 1, b)))
                _agree(self.mesh, out[-1], model.device, f"decode step {i}")
        return np.stack(out, axis=1)

    @staticmethod
    def _seeds(seed: int, step: int, b: int) -> list[int]:
        return [stream_seed(seed, row, step) for row in range(b)]
