"""Paper-scale streaming engine for CLEX point-to-point simulation, on the
card.

The port's copy of the JAX package's ``core/streaming.py``.  The work
splits in two, as there:

* **Chunked position routing.**  Traffic goes through the golden engine's
  :func:`~.simulator._route` recursion in fixed-size message chunks.
  Every per-message draw (gateway lows, bundle edges, Valiant
  intermediates, fault detours) is a counter-based hash of (seed,
  call-path key, stage, global message index) (:mod:`.hashrng`), so a
  message's path is a pure function of its index, the chunk size never
  changes a result, and the draws are the same bits on the card as on
  the CPU.

* **Count-histogram statistics.**  Each A(1) / bundle-hop call batch
  accumulates ``torch.bincount`` histograms on the device, keyed by its
  call-path key: messages per destination, the distinct (sender,
  destination) pairs (a flag per pair), messages per gateway, messages
  per instance.  A finalize pass rebuilds the golden round accounting:
  bundle rounds from the closed form
  :func:`~.routing.bundle_rounds_from_counts`, and the A(1) relay phases
  replayed once, globally, over the messages the phase-1 direct send did
  not deliver.  The replay's draws are the reference's numpy Generator
  calls (a uniform and a priority per relay copy), made on the host in
  its order; the sorts, ranks and histograms around them run on the
  device.

Counts are ``int64`` on the device; every float statistic is formed from
them on the host by the reference's own expressions, so a run equals the
reference's field for field.  Device memory is O(chunk + n * m): per
A(1) call-path key two ``int64`` counters of n, an optional third for
self-deliveries, and n * m pair flags (33.5 MB at n = 2^20, m = 32).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..device import resolve_device
from ..obs import get_obs
from .hashrng import hash_randint, salt_for
from .routing import (
    UnroutableError,
    _flat,
    _sorted_ranks,
    bundle_edge_targets,
    bundle_rounds_from_counts,
    copy_schedule,
    flood_edge_keys,
    flood_route,
)
from .simulator import (
    LevelStats,
    SimulationResult,
    _detour_loop,
    _phase_rounds,
    _route,
    grow_hist,
    uniform_permutation_traffic,
)
from .topology import CLEXTopology, FaultSet, as_long, copy_index, digit, from_host

__all__ = [
    "DEFAULT_CHUNK",
    "DEFAULT_MAX_PAIRS",
    "simulate_all_to_all_streaming",
    "simulate_point_to_point_streaming",
]

DEFAULT_CHUNK = 1 << 20
DEFAULT_MAX_PAIRS = 1 << 26  # pair-enumeration budget for the faulted all-to-all
_INT64_MAX = np.iinfo(np.int64).max


def _peak_rss_mb() -> float:
    """Peak resident set size of this process in MiB (0.0 where the
    ``resource`` module is unavailable)."""
    try:
        import resource

        kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except (ImportError, ValueError):
        return 0.0
    return round(kb / 1024.0, 1)


def _host_rng(seed: int, salt: int) -> np.random.Generator:
    """The numpy Generator the reference seeds from (seed, salt) for its
    finalize replay and its detour order."""
    return np.random.default_rng([seed & 0x7FFFFFFF, int(salt) & 0x7FFFFFFF])


# ------------------------------------------------------------- accumulators
class _LbAcc:
    """Per-A(1)-call-batch histograms (one instance per call-path key).
    The reference's packed bitset of (destination, sender digit) pairs is
    a flag per pair here; its popcount per destination is the reference's
    count of distinct pairs, since the flags are set whatever the order."""

    def __init__(self, n: int, m: int, device: torch.device):
        self.cnt = torch.zeros(n, dtype=torch.int64, device=device)  # messages per dest
        self.self_cnt: torch.Tensor | None = None  # self-delivered per destination
        self.pairs = torch.zeros(n * m, dtype=torch.bool, device=device)


class _HopAcc:
    """Per-bundle-hop-call-batch histogram."""

    def __init__(self, n: int, level: int, device: torch.device):
        self.level = level
        self.gw_cnt = torch.zeros(n, dtype=torch.int64, device=device)  # messages per gateway


class _LoadAcc:
    """Per-A(level>1)-call-batch instance load histogram."""

    def __init__(self, n_inst: int, level: int, device: torch.device):
        self.level = level
        self.inst_cnt = torch.zeros(n_inst, dtype=torch.int64, device=device)


class _StreamState:
    """Global accumulators shared by all chunks of one simulation run."""

    def __init__(self, topo: CLEXTopology, mode: str, seed: int, faults: FaultSet | None,
                 device: torch.device, max_phases: int = 50):
        self.topo = topo
        self.mode = mode
        self.seed = seed
        self.faults = faults
        self.device = device
        self.max_phases = max_phases
        self.lb_accs: dict[str, _LbAcc] = {}
        self.hop_accs: dict[str, _HopAcc] = {}
        self.load_accs: dict[str, _LoadAcc] = {}
        self.detours: dict[int, int] = {}
        self._salts: dict[tuple, int] = {}

    def salt(self, *parts) -> int:
        try:
            return self._salts[parts]
        except KeyError:
            s = self._salts[parts] = salt_for(self.seed, *parts)
            return s

    def lb(self, key: str) -> _LbAcc:
        acc = self.lb_accs.get(key)
        if acc is None:
            acc = self.lb_accs[key] = _LbAcc(self.topo.n, self.topo.m, self.device)
        return acc

    def hop(self, key: str, level: int) -> _HopAcc:
        acc = self.hop_accs.get(key)
        if acc is None:
            acc = self.hop_accs[key] = _HopAcc(self.topo.n, level, self.device)
        return acc

    def load(self, key: str, level: int) -> _LoadAcc:
        acc = self.load_accs.get(key)
        if acc is None:
            acc = self.load_accs[key] = _LoadAcc(self.topo.n // self.topo.m**level, level,
                                                 self.device)
        return acc

    # ------------------------------------------------------------ finalize
    def finalize(self, nmsg: int) -> tuple[dict[int, LevelStats], np.ndarray, dict]:
        topo = self.topo
        stats = {l: LevelStats(l) for l in range(1, topo.L + 1)}
        for st in stats.values():
            st.n_messages = nmsg
        for level, k in self.detours.items():
            stats[level].detours = k
        phase_hist = torch.zeros(self.max_phases + 1, dtype=torch.int64, device=self.device)
        copies = copy_schedule(topo.m, self.max_phases)
        live_m = self._live_members_per_clique()
        for key in sorted(self.lb_accs):
            phase_hist = _finalize_lb(
                self, self.lb_accs[key], key, stats[1], phase_hist, copies, live_m
            )
        edge_load: dict[int, dict] = {}
        for key in sorted(self.hop_accs):
            _finalize_hop(self, self.hop_accs[key], stats, edge_load)
        for acc in self.load_accs.values():
            span = topo.m ** acc.level
            stats[acc.level].max_avg_load = max(
                stats[acc.level].max_avg_load, float(int(acc.inst_cnt.max())) / span,
            )
        return stats, phase_hist.cpu().numpy(), edge_load

    def _live_members_per_clique(self) -> torch.Tensor | None:
        if self.faults is None:
            return None
        n, m = self.topo.n, self.topo.m
        dead = torch.bincount(from_host(self.faults.dead_nodes, self.device) // m,
                              minlength=n // m)
        return m - dead


def _finalize_lb(
    state: _StreamState,
    acc: _LbAcc,
    key: str,
    st: LevelStats,
    phase_hist: torch.Tensor,
    copies: list[int],
    live_m: torch.Tensor | None,
) -> torch.Tensor:
    """Replay the A(1) phase dynamics from the count histograms.

    Phase 1 is exact: one winner per distinct (sender, destination) pair.
    The relay phases are then simulated globally over only the remaining
    messages (a remaining message is fully described by its destination),
    with the golden engine's balanced-rank relay assignment per clique.
    """
    topo = state.topo
    dev = state.device
    n, m = topo.n, topo.m
    cnt = acc.cnt
    nonself = cnt - acc.self_cnt if acc.self_cnt is not None else cnt
    u = acc.pairs.view(n, m).sum(dim=1)  # distinct (sender, dest) pairs per dest
    remaining_d = nonself - u

    clique_load = cnt.view(-1, m).sum(dim=1)
    present = clique_load > 0

    # phase 1: winners take 1 round / 1 hop each
    total_u = int(u.sum())
    st.rounds_total += float(total_u)
    st.hops_total += float(total_u)
    last_phase_d = (nonself > 0).to(torch.int64)  # per-dest last delivery phase

    active = _flat(remaining_d > 0)
    dest_of = active.repeat_interleave(remaining_d[active])
    rng = _host_rng(state.seed, state.salt(key, "lbfin"))
    phase = 1
    max_phase = int(nonself.sum()) + len(copies)
    while dest_of.numel():
        phase += 1
        if phase > max_phase:
            raise RuntimeError("A(1) finalize failed to terminate (no phase progress)")
        if phase >= len(copies):
            copies.append(max(copies[-1], 1))
        if phase >= phase_hist.shape[0]:
            phase_hist = grow_hist(phase_hist, phase + 1)
        c = max(copies[phase], 1)
        R = dest_of.numel()
        copy_dest = dest_of.repeat_interleave(c)
        copy_msg = torch.arange(R, dtype=torch.int64, device=dev).repeat_interleave(c)
        copy_clique = copy_dest // m
        # balanced-rank relay slots: random rank within each clique's copy
        # pool, slot = rank % live members.  The reference orders the pool
        # by np.lexsort((uniform, clique)); the uniforms are 53-bit draws,
        # tie-free in practice, so sorting by them and then stably by
        # clique gives the same order.
        by_noise = torch.argsort(from_host(rng.random(R * c), dev))
        order = by_noise[torch.sort(copy_clique[by_noise], stable=True).indices]
        rank = _sorted_ranks(copy_clique, order)
        pool = m if live_m is None else live_m[copy_clique]
        # one forward per (destination, relay slot); the winner is the
        # copy with the largest priority draw
        fkey = copy_dest * m + rank % pool
        uk, inv = torch.unique(fkey, sorted=True, return_inverse=True)
        pri = from_host(rng.integers(0, _INT64_MAX, size=R * c, dtype=np.int64), dev)
        best = torch.full((uk.shape[0],), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, inv, pri, "amax")
        delivered = torch.zeros(R, dtype=torch.bool, device=dev)
        delivered[copy_msg[pri == best[inv]]] = True
        ndel = int(delivered.sum())
        st.rounds_total += float(ndel * (1 + 2 * (phase - 1)))
        if state.mode == "light":
            st.hops_total += float(copy_dest.shape[0] + uk.shape[0])
            clique_load += torch.bincount(copy_clique, minlength=clique_load.shape[0])
        else:
            st.hops_total += float(2 * ndel)
            clique_load += torch.bincount(dest_of[delivered] // m,
                                          minlength=clique_load.shape[0])
        last_phase_d[dest_of[delivered]] = phase
        dest_of = dest_of[~delivered]

    inst_last = last_phase_d.view(-1, m).max(dim=1).values[present]
    if inst_last.numel():
        st.max_rounds = max(st.max_rounds, int(_phase_rounds(inst_last).max()))
    st.max_avg_load = max(st.max_avg_load, float(int(clique_load.max())) / m)
    return phase_hist + torch.bincount(inst_last, minlength=phase_hist.shape[0])


def _finalize_hop(state: _StreamState, acc: _HopAcc, stats: dict[int, LevelStats],
                  edge_load: dict[int, dict]) -> None:
    """Exact bundle-round accounting from the gateway-count histogram."""
    level = acc.level
    st = stats[level]
    occ = _flat(acc.gw_cnt > 0)
    c = acc.gw_cnt[occ]
    if state.faults is None:
        q = state.topo.m
        q_total = int(state.topo.m) * occ.shape[0]
    else:
        q = state.faults.live_edge_mask(occ, level).sum(dim=1)
        q_total = int(q.sum())
    total, max_rounds = bundle_rounds_from_counts(c, q)
    n_c = int(c.sum())
    st.rounds_total += float(total)
    st.hops_total += float(n_c)
    st.max_rounds = max(st.max_rounds, max_rounds)
    summary = edge_load.setdefault(
        level, {"max_edge_load": 0, "messages": 0, "bundles_used": 0, "live_edges": 0}
    )
    summary["max_edge_load"] = max(summary["max_edge_load"], max_rounds)
    summary["messages"] += n_c
    summary["bundles_used"] += occ.shape[0]
    summary["live_edges"] += q_total


# ------------------------------------------------------- streaming machine
class _StreamingMachine:
    """Chunk-shaped counterpart of :class:`~.simulator.ClexMachine`.

    Every method takes (and is deterministic in) the global message
    indices ``gidx`` and the call-path ``key`` supplied by ``_route``;
    nothing here depends on chunk boundaries.
    """

    def __init__(self, state: _StreamState):
        self.state = state
        self.topo = state.topo
        self.faults = state.faults

    # -- A(1): accumulate count histograms, deliver logically --------------
    def lb_call(self, cur: torch.Tensor, dest: torch.Tensor, gidx=None, key=None) -> torch.Tensor:
        if cur.shape[0] == 0:
            return cur
        st = self.state
        n, m = self.topo.n, self.topo.m
        acc = st.lb(key)
        acc.cnt += torch.bincount(dest, minlength=n)
        self_msg = cur == dest
        if bool(self_msg.any()):
            if acc.self_cnt is None:
                acc.self_cnt = torch.zeros(n, dtype=torch.int64, device=st.device)
            acc.self_cnt += torch.bincount(dest[self_msg], minlength=n)
        ns = ~self_msg
        acc.pairs[dest[ns] * m + cur[ns] % m] = True
        return dest.clone()

    # -- Step 2: positions now, rounds at finalize -------------------------
    def hop_call(self, cur: torch.Tensor, dest: torch.Tensor, level: int, gidx=None,
                 key=None) -> torch.Tensor:
        st = self.state
        m = self.topo.m
        acc = st.hop(key, level)
        acc.gw_cnt += torch.bincount(cur, minlength=self.topo.n)
        b = digit(dest, level - 1, m)
        if self.faults is None:
            edge = hash_randint(gidx, m, st.salt(key, "edge"))
        else:
            gw_ids, gw_inv = torch.unique(cur, sorted=True, return_inverse=True)
            mask = st.faults.live_edge_mask(gw_ids, level)
            q = mask.sum(dim=1)
            if bool((q == 0).any()):
                raise UnroutableError(
                    f"gateway with zero live level-{level} bundle edges selected"
                )
            # j-th live edge in column order, j hashed per message
            live_order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
            j = hash_randint(gidx, q[gw_inv], st.salt(key, "edge"))
            edge = live_order[gw_inv, j]
        return bundle_edge_targets(self.topo, cur, b, edge, level)

    def record_load(self, cur: torch.Tensor, level: int, gidx=None, key=None) -> None:
        acc = self.state.load(key, level)
        acc.inst_cnt += torch.bincount(cur // self.topo.m**level,
                                       minlength=acc.inst_cnt.shape[0])

    # -- gateway sampling: hashed instead of sequential --------------------
    def gateways(self, cur: torch.Tensor, dest: torch.Tensor, level: int, gidx=None,
                 key=None) -> torch.Tensor:
        m = self.topo.m
        base = copy_index(cur, level - 1, m) * m ** (level - 1)
        b = digit(dest, level - 1, m)
        low_span = m ** (level - 2)
        lows = hash_randint(gidx, low_span, self.state.salt(key, "gw")) if low_span > 1 else 0
        return base + b * low_span + lows

    def gateways_faulty(self, cur: torch.Tensor, target_copy: torch.Tensor, level: int,
                        gidx=None, key=None, max_tries: int = 8):
        """Hashed mirror of :func:`~.routing.sample_gateways_faulty`:
        rejection-samples the free low digits per message (draw t keyed by
        (key, t, gidx)), then checks the stragglers exhaustively, so
        ``stuck`` is exact."""
        st = self.state
        faults = st.faults
        m = self.topo.m
        dev = cur.device
        base = copy_index(cur, level - 1, m) * m ** (level - 1)
        low_span = m ** (level - 2)
        nmsg = cur.shape[0]

        def ok(gw: torch.Tensor) -> torch.Tensor:
            good = faults.node_alive(gw)
            if bool(good.any()):
                gw_ids, gw_inv = torch.unique(gw, sorted=True, return_inverse=True)
                good &= faults.live_edge_mask(gw_ids, level).any(dim=1)[gw_inv]
            return good

        if low_span > 1:
            lows = hash_randint(gidx, low_span, st.salt(key, "gwf", 0))
        else:
            lows = torch.zeros(nmsg, dtype=torch.int64, device=dev)
        gw = base + target_copy * low_span + lows
        good = ok(gw)
        tries = 1
        while not bool(good.all()) and tries < max_tries and low_span > 1:
            idx = _flat(~good)
            lows = hash_randint(gidx[idx], low_span, st.salt(key, "gwf", tries))
            cand = base[idx] + target_copy[idx] * low_span + lows
            fixed = ok(cand)
            gw[idx[fixed]] = cand[fixed]
            good[idx[fixed]] = True
            tries += 1
        if not bool(good.all()):
            idx = _flat(~good)
            pair_keys = base[idx] * m + target_copy[idx]
            for pk in torch.unique(pair_keys, sorted=True).tolist():
                sel = idx[pair_keys == pk]
                pbase, ptgt = pk // m, pk % m
                cand = pbase + ptgt * low_span + torch.arange(low_span, dtype=torch.int64,
                                                              device=dev)
                live = cand[ok(cand)]
                if live.numel():
                    pick = hash_randint(gidx[sel], live.numel(), st.salt(key, "gwx"))
                    gw[sel] = live[pick]
                    good[sel] = True
        return gw, ~good

    def detours(self, cur: torch.Tensor, tgt: torch.Tensor, level: int, gidx=None, key=None):
        """Hashed mirror of the golden ``_sample_detours``: sibling copies
        in a (seed, key)-derived order, gateway choice hashed per message."""
        st = self.state
        order = _host_rng(st.seed, st.salt(key, "detperm")).permutation(self.topo.m)
        return _detour_loop(self.topo, cur, tgt, level, order,
                            lambda b, sub, cand: self.gateways_faulty(
                                cur[sub], cand, level, gidx=gidx[sub], key=f"{key}d{b}"))

    def count_detours(self, level: int, n: int) -> None:
        st = self.state
        st.detours[level] = st.detours.get(level, 0) + n

    def valiant_mid(self, src: torch.Tensor, within_level: int | None, gidx=None) -> torch.Tensor:
        st = self.state
        topo = self.topo

        def draw(srcs: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
            if within_level is None:
                return hash_randint(idx, topo.n, st.salt("valiant", t))
            span = topo.m**within_level
            lows = hash_randint(idx, span, st.salt("valiant", t))
            return (srcs // span) * span + lows

        mid = draw(src, gidx, 0)
        if st.faults is not None:
            for t in range(1, 64):
                bad = ~st.faults.node_alive(mid)
                if not bool(bad.any()):
                    break
                mid[bad] = draw(src[bad], gidx[bad], t)
            if not bool(st.faults.node_alive(mid).all()):
                raise UnroutableError("no live Valiant intermediate found")
        return mid


# ------------------------------------------------------------- entry point
def _rechunk(traffic, chunk_size: int, device: torch.device):
    """Re-slice an iterable of ``(start, src, dst)`` traffic chunks to at
    most ``chunk_size`` messages per piece, on ``device``."""
    for _, src, dst in traffic:
        src, dst = as_long(src, device), as_long(dst, device)
        for off in range(0, src.shape[0], chunk_size):
            yield src[off : off + chunk_size], dst[off : off + chunk_size]


def simulate_point_to_point_streaming(
    topo: CLEXTopology,
    msgs_per_node: int,
    mode: str = "dense",
    seed: int = 0,
    src=None,
    dst=None,
    valiant_level: int | None = None,
    faults: FaultSet | None = None,
    audit: bool = False,
    chunk_size: int = DEFAULT_CHUNK,
    traffic=None,
    device=None,
) -> SimulationResult:
    """Streaming counterpart of :func:`~.simulator.simulate_point_to_point`,
    on ``device`` (the card unless the caller passes ``"cpu"``).

    Same traffic (bit-identical for the same seed), same recursion, same
    statistics contract; results are bit-identical across ``chunk_size``
    values and devices.  Traffic arrives as full ``src``/``dst`` arrays
    or as ``traffic=``, an iterable of ``(start, src_chunk, dst_chunk)``
    pieces (e.g. :func:`~.scenarios.iter_traffic`) consumed lazily.
    """
    if audit:
        raise ValueError("audit traces require the golden engine")
    if mode not in ("dense", "light"):
        raise ValueError(mode)
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if traffic is not None and (src is not None or dst is not None):
        raise ValueError("pass either src/dst arrays or traffic=, not both")
    dev = resolve_device(device)
    n_dropped = 0
    filter_chunks = faults is not None
    total = None  # unknown up front when traffic streams from a generator
    if traffic is None:
        if src is None or dst is None:
            src, dst = uniform_permutation_traffic(
                topo, msgs_per_node, np.random.default_rng(seed), dev
            )
        src, dst = as_long(src, dev), as_long(dst, dev)
        if faults is not None:
            live = faults.node_alive(src) & faults.node_alive(dst)
            n_dropped = int((~live).sum())
            src, dst = src[live], dst[live]
            filter_chunks = False
        total = int(src.shape[0])
        traffic = ((0, src, dst),)
    t0 = time.time()
    state = _StreamState(topo, mode, seed, faults, dev)
    machine = _StreamingMachine(state)
    within = None
    if valiant_level is not None:
        within = None if valiant_level >= topo.L else valiant_level
    obs = get_obs()
    nmsg = 0  # messages kept (post fault-filter) so far == next global index
    for s, d in _rechunk(traffic, chunk_size, dev):
        if filter_chunks:
            live = faults.node_alive(s) & faults.node_alive(d)
            n_dropped += int((~live).sum())
            s, d = s[live], d[live]
        if s.shape[0] == 0:
            continue
        gidx = torch.arange(nmsg, nmsg + s.shape[0], dtype=torch.int64, device=dev)
        nmsg += s.shape[0]
        cur = s.clone()
        if valiant_level is not None:
            mid = machine.valiant_mid(s, within, gidx=gidx)
            cur = _route(machine, topo.L, cur, mid, gidx, "v")
        final = _route(machine, topo.L, cur, d, gidx, "r")
        if not torch.equal(final, d):
            raise AssertionError(
                "routing failed: some messages not delivered to their destination"
            )
        if obs.enabled:
            elapsed = time.time() - t0
            rate = nmsg / elapsed if elapsed > 0 else 0.0
            rss_mb = _peak_rss_mb()
            obs.tracer.instant("sim_chunk", "sim", done=nmsg, total=total,
                               msgs_per_s=round(rate, 1), peak_rss_mb=rss_mb)
            obs.registry.gauge("sim.stream.msgs_per_s").set(round(rate, 1))
            obs.registry.gauge("sim.stream.peak_rss_mb").set(rss_mb)
    levels, phase_hist, edge_load = state.finalize(nmsg)
    return SimulationResult(
        topo=topo,
        mode=mode,
        msgs_per_node=msgs_per_node,
        levels=levels,
        lb_phase_histogram=phase_hist,
        wall_seconds=time.time() - t0,
        n_messages=nmsg,
        n_dropped_dead=n_dropped,
        fault_summary=faults.describe() if faults is not None else None,
        audit=None,
        engine="streaming",
        chunk_size=chunk_size,
        edge_load=edge_load,
    )


# ------------------------------------------------------ streaming all-to-all
def simulate_all_to_all_streaming(
    topo: CLEXTopology,
    bandwidth: dict | None = None,
    faults: FaultSet | None = None,
    seed: int = 0,
    chunk_size: int = DEFAULT_CHUNK,
    max_pairs: int = DEFAULT_MAX_PAIRS,
    device=None,
):
    """Streaming counterpart of the Sec. II-C all-to-all flooding
    simulation, on ``device``: the ordered node pairs ``[0, n^2)`` are
    enumerated in ``chunk_size`` pieces and per-edge loads accumulate into
    one ``torch.bincount`` array of n*m keys per level.  Fault-free runs
    above ``max_pairs`` take the exact closed form (every directed edge
    carries n/m; hop 1 is a no-op with probability 1/m, each hop l >= 2
    with 1/m^2).  Faulted runs patch their broken pairs through the
    fault-aware point-to-point engine, so they need ``n^2 <= max_pairs``.
    """
    from .analysis import all_to_all_comparison
    from .scenarios import AllToAllResult  # deferred: scenarios imports us

    n, m, L = topo.n, topo.m, topo.L
    bandwidth = dict(bandwidth or {})
    bound = n // m
    comp = all_to_all_comparison(topo, bandwidth)
    bound_rounds = comp["rounds_bound"]
    total_pairs = n * n

    def _result(max_loads, uniform, hops_sum, hops_max, n_ok, n_messages,
                n_dropped, n_patched, method):
        rounds_per_level = {
            level: math.ceil(max_loads[level] / max(int(bandwidth.get(level, 1)), 1))
            for level in range(1, L + 1)
        }
        total_rounds = sum(rounds_per_level.values())
        return AllToAllResult(
            topo=topo,
            bandwidth=bandwidth,
            rounds_per_level=rounds_per_level,
            total_rounds=total_rounds,
            max_edge_load_per_level=max_loads,
            per_edge_load_bound=bound,
            uniform_load=uniform,
            max_hops=hops_max,
            avg_hops=float(hops_sum) / n_ok if n_ok else 0.0,
            bound_rounds=bound_rounds,
            rounds_vs_bound=total_rounds / max(bound_rounds, 1),
            n_messages=n_messages,
            n_dropped_dead=n_dropped,
            n_patched=n_patched,
            fault_summary=faults.describe() if faults is not None else None,
            engine="streaming",
            method=method,
        )

    if total_pairs > max_pairs:
        if faults is not None:
            raise ValueError(
                "faulted streaming all-to-all enumerates the broken pairs to "
                f"patch them: n^2 = {total_pairs} exceeds max_pairs = {max_pairs}"
            )
        max_loads = {level: bound for level in range(1, L + 1)}
        hops_sum = total_pairs * L - total_pairs // m - (L - 1) * (total_pairs // (m * m))
        return _result(max_loads, True, hops_sum, L if L else 0, total_pairs,
                       total_pairs, 0, 0, "closed_form")

    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    dev = resolve_device(device)
    acc = {level: torch.zeros(n * m, dtype=torch.int64, device=dev) for level in range(1, L + 1)}
    hops_sum = 0
    hops_max = 0
    n_ok = 0
    n_messages = 0
    n_dropped = 0
    broken_src: list[torch.Tensor] = []
    broken_dst: list[torch.Tensor] = []
    obs = get_obs()
    t0 = time.time()
    for start in range(0, total_pairs, chunk_size):
        stop = min(start + chunk_size, total_pairs)
        pair = torch.arange(start, stop, dtype=torch.int64, device=dev)
        src = pair // n
        dst = pair % n
        if faults is not None:
            live = faults.node_alive(src) & faults.node_alive(dst)
            n_dropped += int((~live).sum())
            src, dst = src[live], dst[live]
        n_messages += src.shape[0]
        if src.shape[0] == 0:
            continue
        pos = flood_route(topo, src, dst)
        broken = torch.zeros(src.shape[0], dtype=torch.bool, device=dev)
        if faults is not None:
            for level in range(1, L):
                broken |= ~faults.node_alive(pos[level])
            for level in range(2, L + 1):
                broken |= ~faults.edge_alive(level, pos[level - 1], digit(dst, level - 2, m))
        ok = ~broken
        moved = (pos[1] != pos[0]) & ok
        acc[1] += torch.bincount(flood_edge_keys(topo, pos, dst, 1)[moved], minlength=n * m)
        for level in range(2, L + 1):
            acc[level] += torch.bincount(flood_edge_keys(topo, pos, dst, level)[ok],
                                         minlength=n * m)
        hops = (torch.diff(pos, dim=0) != 0).sum(dim=0)[ok]
        hops_sum += int(hops.sum())
        hops_max = max(hops_max, int(hops.max()) if hops.numel() else 0)
        n_ok += int(ok.sum())
        if bool(broken.any()):
            broken_src.append(src[broken])
            broken_dst.append(dst[broken])
        if obs.enabled:
            elapsed = time.time() - t0
            obs.tracer.instant(
                "a2a_chunk", "sim", done=stop, total=total_pairs,
                pairs_per_s=round(stop / elapsed, 1) if elapsed > 0 else 0.0,
                peak_rss_mb=_peak_rss_mb(),
            )
    uniform: "bool | None" = None
    if faults is None:
        uniform = all(bool((a[a > 0] == bound).all()) for a in acc.values())
    max_loads = {level: int(acc[level].max()) for level in range(1, L + 1)}
    n_patched = sum(a.shape[0] for a in broken_src)
    if n_patched:
        patched = simulate_point_to_point_streaming(
            topo, 1, mode="light", seed=seed,
            src=torch.cat(broken_src), dst=torch.cat(broken_dst),
            faults=faults, chunk_size=chunk_size, device=dev,
        )
        assert patched.delivered_fraction == 1.0
    return _result(max_loads, uniform, hops_sum, hops_max, n_ok, n_messages,
                   n_dropped, n_patched, "enumerated")
