"""Synchronous simulator of CLEX point-to-point routing on tensors (the
golden engine).

The port's copy of the JAX package's ``core/simulator.py``.  It runs
Algorithm A(L) on C(s, 1/s) with the paper's simulation adaptations
(Sec. III): uniform traffic, so Valiant's trick is optional; Step 2
surplus edges chosen u.a.r.; A(1) first sends one message per link
directly; "dense" mode relays behind a request/ack (+2 rounds, requests
are not traffic), "light" mode sends the copies.  Every instance of A(l)
across the machine is one batched tensor program; the recursion is
unrolled as the paper's ("solving recursive calls iteratively").

Per-message state lives on the run's device.  The random draws are the
reference's numpy Generator calls, in its order and with its sizes
(:func:`~.topology.from_host`), so a run reproduces the reference's
numbers exactly: counts are ``int64`` on the device, and every float
statistic is formed from them on the host by the reference's own
expressions.

Stats per level match Tables I-IV:
  max_rounds   -- max number of rounds any instance of A(l) needed,
  avg_rounds   -- average over messages of the rounds spent on that level,
  max_avg_load -- max over instances of (messages physically handled / nodes),
  avg_hops     -- average number of level-l edges a message traversed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from .routing import (
    UnroutableError,
    _flat,
    _per_key_ranks,
    _row_perms,
    _shuffled_order,
    bundle_hop,
    copy_schedule,
    sample_gateways,
    sample_gateways_faulty,
    valiant_intermediate,
)
from .topology import CLEXTopology, FaultSet, as_long, digit, from_host, with_digit

__all__ = [
    "ClexMachine",
    "LevelStats",
    "SimulationResult",
    "simulate_point_to_point",
    "uniform_permutation_traffic",
]


def grow_hist(hist: torch.Tensor, min_len: int) -> torch.Tensor:
    """Return ``hist`` grown (by doubling, zero-filled) to hold at least
    ``min_len`` entries; both engines grow their phase histograms so."""
    if min_len <= hist.shape[0]:
        return hist
    new_len = hist.shape[0]
    while new_len < min_len:
        new_len *= 2
    out = torch.zeros(new_len, dtype=hist.dtype, device=hist.device)
    out[: hist.shape[0]] = hist
    return out


@dataclasses.dataclass
class LevelStats:
    level: int
    max_rounds: int = 0
    rounds_total: float = 0.0  # sum over messages of rounds spent on level
    hops_total: float = 0.0
    max_avg_load: float = 0.0
    n_messages: int = 0  # messages in the run (for averaging)
    detours: int = 0  # fault-forced reroutes through a sibling copy

    @property
    def avg_rounds(self) -> float:
        return self.rounds_total / max(self.n_messages, 1)

    @property
    def avg_hops(self) -> float:
        return self.hops_total / max(self.n_messages, 1)

    def row(self) -> dict:
        return {
            "lvl": self.level,
            "max_rds": self.max_rounds,
            "avg_rds": round(self.avg_rounds, 2),
            "max_avg_load": round(self.max_avg_load, 2),
            "avg_hops": round(self.avg_hops, 2),
        }


@dataclasses.dataclass
class SimulationResult:
    topo: CLEXTopology
    mode: str
    msgs_per_node: int
    levels: dict[int, LevelStats]
    lb_phase_histogram: np.ndarray  # instances (over all A(1) call batches) by #phases
    wall_seconds: float
    n_messages: int = 0  # live-pair messages actually routed
    n_dropped_dead: int = 0  # messages dropped for a dead source/destination
    fault_summary: dict | None = None  # FaultSet.describe() of the injected faults
    audit: dict | None = None  # traversal trace (audit=True runs only), tensors
    engine: str = "golden"  # which engine produced the result
    chunk_size: int | None = None  # streaming engine chunk size (None = golden)
    edge_load: dict | None = None  # streaming: per-level bundle-edge load summary

    def table(self) -> list[dict]:
        return [self.levels[l].row() for l in sorted(self.levels)]

    @property
    def sum_avg_rounds(self) -> float:
        return sum(s.avg_rounds for s in self.levels.values())

    @property
    def sum_avg_hops(self) -> float:
        return sum(s.avg_hops for s in self.levels.values())

    @property
    def total_detours(self) -> int:
        return sum(s.detours for s in self.levels.values())

    @property
    def delivered_fraction(self) -> float:
        """Fraction of live-pair messages delivered: 1.0 by construction
        (the simulator raises :class:`UnroutableError` otherwise)."""
        return 1.0


def uniform_permutation_traffic(
    topo: CLEXTopology, msgs_per_node: int, rng: np.random.Generator, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's traffic: destinations follow a uniformly random
    permutation of the multiset holding each node ``msgs_per_node`` times.
    The shuffle is the reference's Generator draw, made on the host."""
    dev = resolve_device(device)
    src = np.repeat(np.arange(topo.n, dtype=np.int64), msgs_per_node)
    dst = src.copy()
    rng.shuffle(dst)
    return from_host(src, dev), from_host(dst, dev)


def _group_first(keys: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """Boolean mask selecting one u.a.r. element per group of equal keys."""
    n = keys.shape[0]
    order = _shuffled_order(keys, rng)
    sorted_keys = keys[order]
    first_sorted = torch.ones(n, dtype=torch.bool, device=keys.device)
    first_sorted[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first = torch.empty(n, dtype=torch.bool, device=keys.device)
    first[order] = first_sorted
    return first


def _ranks_within(keys: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """Random ranks 0..q-1 within groups of equal keys."""
    return _per_key_ranks(keys, rng)[0]


def _phase_rounds(phase: torch.Tensor) -> torch.Tensor:
    """Rounds of a delivery in ``phase``: phase 1 one round, each later
    phase two."""
    return torch.where(phase <= 1, phase, 1 + 2 * (phase - 1))


class ClexMachine:
    """Batched executor of all concurrent instances of A(l).

    With ``faults`` the machine routes around dead nodes and dead bundle
    edges: clique relays are live nodes, gateways are sampled among live
    candidates with a live bundle edge, and bundle crossings balance load
    over the surviving parallel edges.  ``audit=True`` records every
    bundle-edge traversal and clique relay (as tensors).
    """

    def __init__(
        self,
        topo: CLEXTopology,
        mode: str,
        rng: np.random.Generator,
        max_phases: int = 50,
        faults: FaultSet | None = None,
        audit: bool = False,
        device=None,
    ):
        if mode not in ("dense", "light"):
            raise ValueError(mode)
        self.topo = topo
        self.mode = mode
        self.rng = rng
        self.faults = faults
        self.device = resolve_device(device)
        self.copies = copy_schedule(topo.m, max_phases)
        self.stats: dict[int, LevelStats] = {l: LevelStats(l) for l in range(1, topo.L + 1)}
        self.phase_hist = torch.zeros(max_phases + 1, dtype=torch.int64, device=self.device)
        self.audit: dict | None = (
            {"bundle": [], "relay": [], "positions": []} if audit else None
        )

    # -- A(1): parallel randomized load balancing on all cliques at once ---
    def lb_call(self, cur: torch.Tensor, dest: torch.Tensor, gidx=None, key=None) -> torch.Tensor:
        m = self.topo.m
        n = self.topo.n
        st = self.stats[1]
        nmsg = cur.shape[0]
        if nmsg == 0:
            return cur
        dev = cur.device
        inst_ids, inst_inv = torch.unique(cur // m, sorted=True, return_inverse=True)
        n_inst = inst_ids.shape[0]

        delivered_phase = torch.zeros(nmsg, dtype=torch.int64, device=dev)  # 0 = self
        hops = torch.zeros(nmsg, dtype=torch.int64, device=dev)
        load = torch.bincount(inst_inv, minlength=n_inst)  # physically handled messages

        remaining = cur != dest

        # Phase 1: send one message per (sender, destination) link directly.
        idx = _flat(remaining)
        if idx.numel():
            first = _group_first(cur[idx] * n + dest[idx], self.rng)
            winners = idx[first]
            delivered_phase[winners] = 1
            hops[winners] = 1
            remaining[winners] = False

        # Phases 2..: relay copies with balanced-random placement.  Each
        # phase delivers >= 1 remaining message per (relay, destination)
        # link, so the loop terminates; the copy schedule extends at its
        # cap on demand.
        phase = 1
        max_phase = nmsg + len(self.copies)
        while bool(remaining.any()):
            phase += 1
            if phase > max_phase:
                raise RuntimeError("A(1) failed to terminate (no phase progress)")
            if phase >= len(self.copies):
                self.copies.append(max(self.copies[-1], 1))
            if phase >= self.phase_hist.shape[0]:
                self.phase_hist = grow_hist(self.phase_hist, phase + 1)
            c = max(self.copies[phase], 1)
            idx = _flat(remaining)
            msg_of_copy = idx.repeat_interleave(c)
            copy_inst_inv = inst_inv[msg_of_copy]
            # balanced-random relay assignment inside each clique: random
            # rank within clique -> relay slot rank % m through a per-clique
            # random permutation.  Under faults only live members relay.
            ranks = _ranks_within(copy_inst_inv, self.rng)
            noise = from_host(self.rng.random((n_inst, m)), dev)
            if self.faults is None:
                relay_local = _row_perms(noise)[copy_inst_inv, ranks % m]
            else:
                members = inst_ids[:, None] * m + torch.arange(m, device=dev)[None, :]
                alive = self.faults.node_alive(members)  # [n_inst, m]
                live_counts = alive.sum(dim=1)
                perms = _row_perms(noise + (~alive).to(torch.float64) * 2.0)
                relay_local = perms[copy_inst_inv, ranks % live_counts[copy_inst_inv]]
            relay = inst_ids[copy_inst_inv] * m + relay_local
            if self.audit is not None:
                self.audit["relay"].append(relay.clone())
            # each relay forwards one copy per destination
            forwarded = _group_first(relay * n + dest[msg_of_copy], self.rng)
            delivered_now = torch.zeros(nmsg, dtype=torch.bool, device=dev)
            delivered_now[msg_of_copy[forwarded]] = True
            delivered_now &= remaining
            winners = _flat(delivered_now)
            delivered_phase[winners] = phase
            if self.mode == "light":
                # copies are physically sent (1 hop each) + each forwarded
                # copy travels one more hop to the destination
                hops += torch.bincount(msg_of_copy, minlength=nmsg)
                hops += torch.bincount(msg_of_copy[forwarded], minlength=nmsg)
                load += torch.bincount(copy_inst_inv, minlength=n_inst)
            else:
                # dense: after the ack the message goes source -> relay ->
                # destination (2 hops); only the winning relay handles it
                hops[winners] += 2
                load += torch.bincount(inst_inv[winners], minlength=n_inst)
            remaining &= ~delivered_now

        st.rounds_total += float(int(_phase_rounds(delivered_phase).sum()))
        st.hops_total += float(int(hops.sum()))
        inst_last_phase = torch.zeros(n_inst, dtype=torch.int64, device=dev).scatter_reduce_(
            0, inst_inv, delivered_phase, "amax")
        st.max_rounds = max(st.max_rounds, int(_phase_rounds(inst_last_phase).max()))
        st.max_avg_load = max(st.max_avg_load, float(int(load.max())) / m)
        self.phase_hist += torch.bincount(inst_last_phase, minlength=self.phase_hist.shape[0])
        return dest.clone()

    # -- Step 2 of A(level): bundle hop ------------------------------------
    def hop_call(self, cur: torch.Tensor, dest: torch.Tensor, level: int, gidx=None,
                 key=None) -> torch.Tensor:
        st = self.stats[level]
        new, rounds = bundle_hop(
            self.topo, cur, dest, level, self.rng,
            faults=self.faults,
            audit=None if self.audit is None else self.audit["bundle"],
        )
        st.rounds_total += float(int(rounds.sum()))
        st.hops_total += float(cur.shape[0])
        st.max_rounds = max(st.max_rounds, int(rounds.max()) if rounds.numel() else 0)
        return new

    def record_load(self, cur: torch.Tensor, level: int, gidx=None, key=None) -> None:
        """Per-A(level)-call load: messages handled / nodes of the instance."""
        st = self.stats[level]
        span = self.topo.m**level
        _, counts = torch.unique(cur // span, return_counts=True)
        top = int(counts.max()) if counts.numel() else 0
        st.max_avg_load = max(st.max_avg_load, float(top) / span)

    # -- routing-primitive hooks used by the shared _route recursion -------
    # ``gidx``/``key`` are the streaming engine's chunk-alignment handles;
    # the golden machine draws from its sequential Generator and ignores them.
    def gateways(self, cur, dest, level: int, gidx=None, key=None) -> torch.Tensor:
        return sample_gateways(self.topo, cur, dest, level, self.rng)

    def gateways_faulty(self, cur, target_copy, level: int, gidx=None, key=None):
        return sample_gateways_faulty(self.topo, cur, target_copy, level, self.rng, self.faults)

    def detours(self, cur, tgt, level: int, gidx=None, key=None):
        return _sample_detours(self.topo, cur, tgt, level, self.rng, self.faults)

    def count_detours(self, level: int, n: int) -> None:
        self.stats[level].detours += n

    def valiant_mid(self, src: torch.Tensor, within_level: int | None, gidx=None) -> torch.Tensor:
        return valiant_intermediate(self.topo, src, self.rng, within_level=within_level,
                                    faults=self.faults)


_MAX_DETOUR_ITERS = 16


def _sample_detours(
    topo: CLEXTopology,
    cur: torch.Tensor,
    tgt: torch.Tensor,
    level: int,
    rng: np.random.Generator,
    faults: FaultSet,
) -> tuple[torch.Tensor, torch.Tensor]:
    """For messages with no live gateway toward copy ``tgt``: pick a sibling
    copy b' != tgt with a live gateway (cross into b', then retry tgt from
    there).  Exhaustive over the m copies, so failure means the
    level-``level`` copy graph is disconnected."""
    return _detour_loop(topo, cur, tgt, level, rng.permutation(topo.m),
                        lambda b, sub, cand: sample_gateways_faulty(
                            topo, cur[sub], cand, level, rng, faults))


def _detour_loop(topo, cur, tgt, level, order, gateways):
    """Try sibling copies in ``order`` for the messages not yet detoured;
    ``gateways(b, sub, cand)`` samples gateways toward copy b for the
    messages ``sub``."""
    dev = cur.device
    nmsg = cur.shape[0]
    out_t = torch.full((nmsg,), -1, dtype=torch.int64, device=dev)
    out_g = torch.zeros(nmsg, dtype=torch.int64, device=dev)
    undone = torch.arange(nmsg, device=dev)
    for b in order.tolist():
        if undone.numel() == 0:
            break
        can_try = tgt[undone] != b
        sub = undone[can_try]
        if sub.numel():
            cand = torch.full((sub.shape[0],), b, dtype=torch.int64, device=dev)
            gw, stuck = gateways(b, sub, cand)
            ok = ~stuck
            out_t[sub[ok]] = b
            out_g[sub[ok]] = gw[ok]
            undone = torch.cat([undone[~can_try], sub[stuck]])
        else:
            undone = undone[~can_try]
    if bool((out_t < 0).any()):
        raise UnroutableError(
            f"level-{level} copy unreachable: faults disconnect the copy graph"
        )
    return out_t, out_g


def _route(machine, level: int, cur: torch.Tensor, dest: torch.Tensor, gidx: torch.Tensor,
           key: str) -> torch.Tensor:
    """The A(level) recursion, shared by both engines.

    The machine supplies the routing primitives (lb_call / hop_call /
    gateway sampling / load recording); this function owns the A(l) =
    A(l-1), HOP_l, A(l-1) recursion and the fault-detour control flow.
    ``gidx`` carries each message's global index and ``key`` a stable
    call-path key ("a"/"b" per recursion branch, "i<k>" per detour
    iteration) so a chunked machine can align its accumulators and hashed
    draws across chunks; the golden machine ignores both.
    """
    if level > 1:
        machine.record_load(cur, level, gidx=gidx, key=key)
    if level == 1:
        return machine.lb_call(cur, dest, gidx=gidx, key=key)
    topo = machine.topo
    if machine.faults is None:
        gw = machine.gateways(cur, dest, level, gidx=gidx, key=key)
        cur = _route(machine, level - 1, cur, gw, gidx, key + "a")
        cur = machine.hop_call(cur, dest, level, gidx=gidx, key=key)
        return _route(machine, level - 1, cur, dest, gidx, key + "b")
    # fault-aware: every message crosses the level once; messages whose
    # direct gateway is unreachable detour through a sibling copy and
    # retry, so only the stragglers re-enter the recursion.
    cur = cur.clone()
    crossed = torch.zeros(cur.shape[0], dtype=torch.bool, device=cur.device)
    for it in range(_MAX_DETOUR_ITERS):
        if bool(crossed.all()):
            break
        idx = _flat(~crossed)
        sub_cur, sub_dest, sub_gidx = cur[idx], dest[idx], gidx[idx]
        tgt = digit(sub_dest, level - 1, topo.m)
        ikey = key + f"i{it}"
        gw, stuck = machine.gateways_faulty(sub_cur, tgt, level, gidx=sub_gidx, key=ikey)
        if bool(stuck.any()):
            det_t, det_g = machine.detours(
                sub_cur[stuck], tgt[stuck], level, gidx=sub_gidx[stuck], key=ikey
            )
            tgt[stuck], gw[stuck] = det_t, det_g
            machine.count_detours(level, int(stuck.sum()))
        sub_cur = _route(machine, level - 1, sub_cur, gw, sub_gidx, ikey + "a")
        synth_dest = with_digit(sub_cur, level - 1, topo.m, tgt)
        cur[idx] = machine.hop_call(sub_cur, synth_dest, level, gidx=sub_gidx, key=ikey + "h")
        crossed[idx] = ~stuck
    if not bool(crossed.all()):
        raise UnroutableError(
            f"level-{level} crossings did not converge in {_MAX_DETOUR_ITERS} detour iterations"
        )
    return _route(machine, level - 1, cur, dest, gidx, key + "b")


def simulate_point_to_point(
    topo: CLEXTopology,
    msgs_per_node: int,
    mode: str = "dense",
    seed: int = 0,
    src=None,
    dst=None,
    valiant_level: int | None = None,
    faults: FaultSet | None = None,
    audit: bool = False,
    device=None,
) -> SimulationResult:
    """Run A(1/s) on C(s, 1/s) under the paper's uniform permutation
    traffic, on ``device`` (the card unless the caller passes ``"cpu"``).

    ``mode='dense'`` reproduces Tables I/II, ``mode='light'`` Tables III/IV.
    ``valiant_level`` routes every message first to a u.i.r. intermediate
    (globally if ``valiant_level >= topo.L``, else inside the
    level-``valiant_level`` copy of its source).  ``faults`` drops messages
    with a dead endpoint (``n_dropped_dead``) and delivers every live-pair
    message around the faults, counting detours; :class:`UnroutableError`
    signals true disconnection.  ``audit=True`` attaches a traversal trace.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if src is None or dst is None:
        src, dst = uniform_permutation_traffic(topo, msgs_per_node, rng, dev)
    src, dst = as_long(src, dev), as_long(dst, dev)
    n_dropped = 0
    if faults is not None:
        live = faults.node_alive(src) & faults.node_alive(dst)
        n_dropped = int((~live).sum())
        src, dst = src[live], dst[live]
    t0 = time.time()
    machine = ClexMachine(topo, mode, rng, faults=faults, audit=audit, device=dev)
    nmsg = src.shape[0]
    for st in machine.stats.values():
        st.n_messages = nmsg

    gidx = torch.arange(nmsg, dtype=torch.int64, device=dev)
    cur = src.clone()
    if valiant_level is not None:
        within = None if valiant_level >= topo.L else valiant_level
        mid = machine.valiant_mid(src, within, gidx=gidx)
        cur = _route(machine, topo.L, cur, mid, gidx, "v")
    final = _route(machine, topo.L, cur, dst, gidx, "r")
    if not torch.equal(final, dst):
        raise AssertionError("routing failed: some messages not delivered to their destination")
    if machine.audit is not None:
        machine.audit["positions"].append(final.clone())
    return SimulationResult(
        topo=topo,
        mode=mode,
        msgs_per_node=msgs_per_node,
        levels=machine.stats,
        lb_phase_histogram=machine.phase_hist.cpu().numpy(),
        wall_seconds=time.time() - t0,
        n_messages=nmsg,
        n_dropped_dead=n_dropped,
        fault_summary=faults.describe() if faults is not None else None,
        audit=machine.audit,
    )
