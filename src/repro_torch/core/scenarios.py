"""Traffic-scenario engine for the CLEX simulator (and the torus baseline).

The port's copy of the JAX package's ``core/scenarios.py``.  The
generators are counter-hash tensor work on the run's device; the one
numpy draw left (a legacy Generator passed as the seed, and the fault
sample of :func:`fault_degradation_curve`) stays a host call.

The paper's experiments (Sec. III) only exercise fault-free uniform
permutation traffic.  Follow-up evaluations of low-latency topologies
(Deng et al.; Camarero et al.) stress exactly the regimes the paper's
*claims* cover but its tables do not: adversarial skew, bursty load,
degraded hardware.  This module closes that gap:

* :class:`TrafficScenario` — a named traffic generator working on both
  :class:`CLEXTopology` and :class:`TorusTopology` (``SCENARIOS`` registry:
  uniform, hotspot, transpose, same_copy, bursty), each with a
  recommended Valiant-randomization level that callers can override.
  Generators are *streaming*: endpoints are a pure counter-hash function
  of ``(seed, scenario, global message index)`` (permutations come from a
  Feistel bijection, :func:`~.hashrng.pseudo_permutation`), so
  :func:`iter_traffic` draws any chunk in O(chunk) and the stream is
  bit-invariant to chunk size — the same contract as the streaming
  engine's own RNG;
* :func:`run_clex_scenario` / :func:`run_torus_scenario` — drive either
  simulator through a scenario (CLEX optionally with injected
  :class:`FaultSet` faults); seeds split through :func:`_derive_seeds`
  so golden and streaming engines consume identical traffic;
* :func:`scenario_matrix` — CLEX-vs-torus across all scenarios, the
  ROADMAP's scenario-diversity table (tracer span + peak-RSS gauge per
  cell);
* :func:`simulate_all_to_all` — the Sec. II-C flooding schedule under an
  (asymmetric) per-level bandwidth assignment, validated against the
  analytic bound of :func:`analysis.all_to_all_comparison`; runs on the
  golden engine (explicit pairs, small n) or the streaming engine
  (:func:`~.streaming.simulate_all_to_all_streaming`, paper scale);
* :func:`fault_degradation_curve` — delivery/slowdown vs fault rate, the
  inherent-fault-tolerance demonstration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..obs import NULL_SPAN, get_obs
from .analysis import all_to_all_comparison
from .hashrng import hash_randint, hash_u01, pseudo_permutation, salt_for
from .routing import flood_edge_keys, flood_route
from .sim_engine import get_engine
from .simulator import SimulationResult, simulate_point_to_point
from .streaming import _peak_rss_mb
from .topology import CLEXTopology, FaultSet, TorusTopology, digit

__all__ = [
    "TrafficScenario",
    "SCENARIOS",
    "AllToAllResult",
    "make_traffic",
    "iter_traffic",
    "run_clex_scenario",
    "run_torus_scenario",
    "scenario_matrix",
    "simulate_all_to_all",
    "fault_degradation_curve",
]

Traffic = "tuple[torch.Tensor, torch.Tensor]"


@dataclasses.dataclass(frozen=True)
class TrafficScenario:
    """A named streaming traffic pattern on any topology exposing ``.n``.

    ``chunk(topo, msgs_per_node, seed, gidx)`` returns the ``(src, dst)``
    endpoints for the global message indices ``gidx`` — a pure function
    of ``(seed, gidx)``, so any chunking of ``[0, count)`` yields the
    same stream (the generators' chunk-size-invariance contract, pinned
    by tests/test_scenarios.py).  ``count(topo, msgs_per_node)`` is the
    total number of messages the scenario emits.

    ``valiant_level`` is the recommended Valiant randomization for CLEX
    runs: ``None`` (uniform enough already), ``"global"`` (u.i.r. over
    the whole machine), or an int level for the lightweight within-copy
    variant.  Callers toggle it per run via
    ``run_clex_scenario(..., valiant=...)``.
    """

    name: str
    description: str
    chunk: Callable
    valiant_level: "str | int | None" = None
    count: Callable = lambda topo, msgs_per_node: topo.n * msgs_per_node


def _tsalt(seed: int, name: str, stage: str) -> int:
    """Salt for one (scenario, stage) draw stream — distinct per scenario
    so e.g. hotspot's base permutation differs from uniform's."""
    return salt_for(seed, "traffic", name, stage)


def _perm_sources(msgs_per_node: int, gidx: torch.Tensor) -> torch.Tensor:
    """The balanced source multiset: node i sends messages
    [i * msgs_per_node, (i+1) * msgs_per_node)."""
    return gidx // msgs_per_node


def _uniform_chunk(topo, msgs_per_node: int, seed: int, gidx: torch.Tensor):
    """The paper's traffic: a uniform permutation of the balanced multiset
    (dst is the same multiset as src, in Feistel-permuted order)."""
    total = topo.n * msgs_per_node
    src = _perm_sources(msgs_per_node, gidx)
    dst = pseudo_permutation(gidx, total, _tsalt(seed, "uniform", "perm"))
    return src, dst // msgs_per_node


def _hotspot_chunk(topo, msgs_per_node: int, seed: int, gidx: torch.Tensor,
                   hot_fraction: float = 1 / 64, p_hot: float = 0.5):
    """A small hot set draws ``p_hot`` of all traffic; the rest is a uniform
    permutation — the incast pattern that collapses mesh networks.  The
    hot set is the first ``ceil(hot_fraction * n)`` entries of a Feistel
    permutation of the nodes (O(n/64) state, recomputed per chunk)."""
    n = topo.n
    total = n * msgs_per_node
    src = _perm_sources(msgs_per_node, gidx)
    dst = pseudo_permutation(gidx, total, _tsalt(seed, "hotspot", "perm")) // msgs_per_node
    k = max(1, int(round(hot_fraction * n)))
    hot = pseudo_permutation(torch.arange(k, dtype=torch.int64, device=gidx.device), n,
                             _tsalt(seed, "hotspot", "hotset"))
    to_hot = hash_u01(gidx, _tsalt(seed, "hotspot", "tohot")) < p_hot
    dst[to_hot] = hot[hash_randint(gidx[to_hot], k, _tsalt(seed, "hotspot", "pick"))]
    return src, dst


def _transpose_chunk(topo, msgs_per_node: int, seed: int, gidx: torch.Tensor):
    """Digit/coordinate reversal: the classic adversarial permutation for
    dimension-ordered and hierarchical routers (every message must cross
    the whole hierarchy; no locality to exploit).  Pure digit arithmetic
    per chunk — no RNG, no O(n) permutation array."""
    n = topo.n
    src = _perm_sources(msgs_per_node, gidx)
    if isinstance(topo, CLEXTopology):
        m, L = topo.m, topo.L
        dst = torch.zeros_like(src)
        for p in range(L):
            dst += digit(src, p, m) * m ** (L - 1 - p)
    elif isinstance(topo, TorusTopology) and topo.k1 == topo.k2 == topo.k3:
        x, y, z = topo.node_xyz(src)
        dst = y + topo.k1 * (z + topo.k2 * x)  # rotate (x,y,z) -> (y,z,x)
    else:
        dst = n - 1 - src  # index reversal: always a permutation
    return src, dst


def _same_copy_chunk(topo, msgs_per_node: int, seed: int, gidx: torch.Tensor,
                     fraction: float | None = None):
    """Same-copy adversarial: every node floods one level-(L-1) copy (for the
    torus: one equally-sized block of node ids).  The worst case for the
    un-randomized algorithm — the paper's Valiant argument exists for this."""
    n = topo.n
    if isinstance(topo, CLEXTopology):
        span = topo.m ** (topo.L - 1)  # copy 0 of the top level
    else:
        span = max(1, int(round(n * (fraction if fraction is not None else 1 / 8))))
    src = _perm_sources(msgs_per_node, gidx)
    dst = hash_randint(gidx, span, _tsalt(seed, "same_copy", "dst"))
    return src, dst


def _bursty_senders(topo, seed: int, device, burst_fraction: float = 1 / 8) -> torch.Tensor:
    """The burst set: a pseudorandom ``burst_fraction`` of the nodes, in
    ascending id order (O(n/8) state, recomputed per chunk)."""
    k = max(1, int(round(burst_fraction * topo.n)))
    return torch.sort(pseudo_permutation(torch.arange(k, dtype=torch.int64, device=device),
                                         topo.n, _tsalt(seed, "bursty", "senders"))).values


def _bursty_chunk(topo, msgs_per_node: int, seed: int, gidx: torch.Tensor,
                  burst_fraction: float = 1 / 8, burst_factor: int = 4):
    """Bursty traffic: a pseudorandom ``burst_fraction`` of nodes each fire
    ``burst_factor * msgs_per_node`` messages at uniform destinations; the
    remaining nodes are silent.  Messages arrive clustered by sender (the
    per-sender burst occupies a contiguous index range)."""
    senders = _bursty_senders(topo, seed, gidx.device, burst_fraction)
    src = senders[gidx // (burst_factor * msgs_per_node)]
    dst = hash_randint(gidx, topo.n, _tsalt(seed, "bursty", "dst"))
    return src, dst


def _bursty_count(topo, msgs_per_node: int,
                  burst_fraction: float = 1 / 8, burst_factor: int = 4) -> int:
    return max(1, int(round(burst_fraction * topo.n))) * burst_factor * msgs_per_node


SCENARIOS: dict[str, TrafficScenario] = {
    s.name: s
    for s in [
        TrafficScenario("uniform", "uniform permutation (the paper's Sec. III traffic)",
                        _uniform_chunk, valiant_level=None),
        TrafficScenario("hotspot", "incast: a 1/64 hot set draws half of all traffic",
                        _hotspot_chunk, valiant_level="global"),
        TrafficScenario("transpose", "digit/coordinate-reversal permutation",
                        _transpose_chunk, valiant_level="global"),
        TrafficScenario("same_copy", "all nodes flood one level-(L-1) copy",
                        _same_copy_chunk, valiant_level="global"),
        TrafficScenario("bursty", "1/8 of nodes burst at 4x rate, the rest silent",
                        _bursty_chunk, valiant_level="global", count=_bursty_count),
    ]
}


def _traffic_seed(rng: "np.random.Generator | int") -> int:
    """Accept either an int seed (preferred — the counter-hash generators
    are keyed on it directly) or a legacy ``np.random.Generator`` (one
    draw derives the int seed, deterministically in the generator state)."""
    if isinstance(rng, np.random.Generator):
        return int(rng.integers(0, np.iinfo(np.int64).max))
    return int(rng)


def make_traffic(topo, scenario: "TrafficScenario | str", msgs_per_node: int,
                 rng: "np.random.Generator | int" = 0, device=None):
    """Generate ``(src, dst)`` for a scenario (by object or registry name)
    on ``device``: the materialised form of the :func:`iter_traffic`
    stream (identical values, one chunk)."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    dev = resolve_device(device)
    seed = _traffic_seed(rng)
    total = scenario.count(topo, msgs_per_node)
    gidx = torch.arange(total, dtype=torch.int64, device=dev)
    return scenario.chunk(topo, msgs_per_node, seed, gidx)


def iter_traffic(topo, scenario: "TrafficScenario | str", msgs_per_node: int,
                 rng: "np.random.Generator | int" = 0, chunk_size: int = 1 << 20,
                 device=None) -> "Iterator[tuple[int, torch.Tensor, torch.Tensor]]":
    """Chunk-yielding traffic iterator: ``(start, src_chunk, dst_chunk)``
    per chunk, drawn lazily — peak memory is O(chunk_size), never
    O(n_messages).  Each chunk is a pure counter-hash function of
    ``(seed, scenario, global index)``, so the concatenated stream is
    bit-identical for every ``chunk_size`` (including a trailing partial
    chunk) and equals :func:`make_traffic` for the same seed.  The chunks
    are drawn on ``device``."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    dev = resolve_device(device)
    seed = _traffic_seed(rng)
    total = scenario.count(topo, msgs_per_node)
    for start in range(0, total, chunk_size):
        stop = min(start + chunk_size, total)
        gidx = torch.arange(start, stop, dtype=torch.int64, device=dev)
        src, dst = scenario.chunk(topo, msgs_per_node, seed, gidx)
        yield start, src, dst


def _resolve_valiant(topo: CLEXTopology, scenario: TrafficScenario,
                     valiant: "str | int | bool | None") -> "int | None":
    """Resolve the ``valiant=`` knob to a randomization level (or None).

    ``None``/``False`` disable; ``True``/``"global"`` mean whole-machine
    (level L); an *int* k forces level min(k, L).  The checks are
    isinstance-guarded because Python bools alias small ints (1 == True,
    0 == False): ``valiant=1`` must mean level 1, not global, and
    ``valiant=0`` must mean level 0, not disabled."""
    if isinstance(valiant, str) and valiant == "auto":
        valiant = scenario.valiant_level
    if valiant is None or (isinstance(valiant, bool) and not valiant):
        return None
    if valiant is True or (isinstance(valiant, str) and valiant == "global"):
        return topo.L
    return min(int(valiant), topo.L)


def _derive_seeds(seed: int) -> tuple[int, int]:
    """The one place the scenario seed splits: traffic endpoints are drawn
    with ``seed`` itself, the routing engine runs with ``seed + 1`` — so
    the two streams never collide, and golden and streaming engines (which
    share the traffic seed but use their RNGs differently) consume
    *identical* traffic for the same scenario seed."""
    seed = int(seed)
    return seed, seed + 1


def run_clex_scenario(
    topo: CLEXTopology,
    scenario: "TrafficScenario | str",
    msgs_per_node: int = 4,
    mode: str = "dense",
    seed: int = 0,
    valiant: "str | int | bool | None" = "auto",
    faults: FaultSet | None = None,
    audit: bool = False,
    engine="golden",
    device=None,
) -> SimulationResult:
    """Drive the CLEX simulator through a scenario.  ``valiant='auto'`` uses
    the scenario's recommended randomization; ``False`` disables it; an int
    or ``'global'`` forces a level.  ``engine`` picks the simulator engine
    ('golden', 'streaming', or a :class:`~.sim_engine.SimEngine`); traffic
    reaches the engine as an :func:`iter_traffic` chunk stream, so the
    streaming engine never materialises the full endpoint arrays.  A named
    engine runs on ``device``."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    traffic_seed, engine_seed = _derive_seeds(seed)
    eng = get_engine(engine, device)
    return eng.run_clex(
        topo, msgs_per_node, mode=mode, seed=engine_seed,
        traffic=iter_traffic(topo, scenario, msgs_per_node, traffic_seed, device=eng.device),
        valiant_level=_resolve_valiant(topo, scenario, valiant),
        faults=faults, audit=audit,
    )


def run_torus_scenario(
    topo: TorusTopology,
    scenario: "TrafficScenario | str",
    msgs_per_node: int = 4,
    seed: int = 0,
    max_rounds: int = 100000,
    engine="golden",
    device=None,
):
    """Drive the torus DOR baseline through the same scenario (same
    :func:`_derive_seeds` split as :func:`run_clex_scenario`).  The golden
    engine returns :class:`~.torus_sim.TorusSimResult` (realised queueing
    rounds); the streaming engine :class:`~.torus_sim.TorusStreamResult`
    (exact hops + link-load / completion lower bounds)."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    traffic_seed, engine_seed = _derive_seeds(seed)
    eng = get_engine(engine, device)
    return eng.run_torus(
        topo, msgs_per_node, seed=engine_seed,
        traffic=iter_traffic(topo, scenario, msgs_per_node, traffic_seed, device=eng.device),
        max_rounds=max_rounds,
    )


def scenario_matrix(
    clex: CLEXTopology,
    torus: TorusTopology,
    msgs_per_node: int = 4,
    mode: str = "dense",
    seed: int = 0,
    scenarios: "list[str] | None" = None,
    faults: FaultSet | None = None,
    engine="golden",
    device=None,
) -> list[dict]:
    """CLEX vs torus across scenarios: one row per scenario with the plain
    CLEX run, the Valiant-randomized run (where the scenario recommends
    one), and the torus DOR baseline.  With ``engine='streaming'`` the
    torus columns switch to the exact-hops / completion-lower-bound form
    (no realised queueing schedule at paper scale).  Every cell runs under
    a tracer span carrying the message count and a peak-RSS gauge."""
    obs = get_obs()
    rows = []
    for name in scenarios or list(SCENARIOS):
        sc = SCENARIOS[name]
        span = (obs.tracer.span("scenario", "sim", scenario=name,
                                topo=f"L{clex.L}/{clex.n}")
                if obs.enabled else NULL_SPAN)
        with span:
            plain = run_clex_scenario(clex, sc, msgs_per_node, mode, seed,
                                      valiant=False, faults=faults, engine=engine,
                                      device=device)
            row = {
                "scenario": name,
                "n_messages": plain.n_messages,
                "clex_sum_avg_rds": round(plain.sum_avg_rounds, 2),
                "clex_sum_avg_hops": round(plain.sum_avg_hops, 2),
                "clex_max_rds_l1": plain.levels[1].max_rounds,
                "clex_max_load_l1": round(plain.levels[1].max_avg_load, 2),
            }
            if sc.valiant_level is not None:
                val = run_clex_scenario(clex, sc, msgs_per_node, mode, seed,
                                        valiant="auto", faults=faults, engine=engine,
                                        device=device)
                row.update({
                    "clex_valiant_sum_avg_rds": round(val.sum_avg_rounds, 2),
                    "clex_valiant_max_rds_l1": val.levels[1].max_rounds,
                    "clex_valiant_max_load_l1": round(val.levels[1].max_avg_load, 2),
                })
            tor = run_torus_scenario(torus, sc, msgs_per_node, seed, engine=engine,
                                     device=device)
            if hasattr(tor, "avg_rounds"):  # golden TorusSimResult
                row.update({
                    "torus_avg_rds": round(tor.avg_rounds, 2),
                    "torus_max_rds": tor.max_rounds,
                    "torus_congestion": round(tor.congestion_overhead, 2),
                    "rounds_gain_vs_torus": round(
                        tor.avg_rounds / max(plain.sum_avg_rounds, 1e-9), 2),
                })
            else:
                row.update({
                    "torus_avg_hops": round(tor.avg_hops, 2),
                    "torus_max_link_load": tor.max_link_load,
                    "torus_rounds_lb": tor.completion_rounds_lb,
                    "rounds_gain_vs_torus_lb": round(
                        tor.completion_rounds_lb / max(plain.sum_avg_rounds, 1e-9), 2),
                })
            if faults is not None:
                row["dropped_dead_pairs"] = plain.n_dropped_dead
            span.set(n_messages=plain.n_messages)
            if obs.enabled:
                obs.registry.gauge("sim.matrix.peak_rss_mb").set(_peak_rss_mb())
        rows.append(row)
    return rows


# ---------------------------------------------------------------- all-to-all
@dataclasses.dataclass
class AllToAllResult:
    """Simulated Sec. II-C all-to-all flooding under a per-level bandwidth
    assignment, with the measured-vs-analytic comparison."""

    topo: CLEXTopology
    bandwidth: dict
    rounds_per_level: dict
    total_rounds: int
    max_edge_load_per_level: dict
    per_edge_load_bound: int
    uniform_load: "bool | None"  # None = unverified (faulty runs)
    max_hops: int
    avg_hops: float
    bound_rounds: int
    rounds_vs_bound: float
    n_messages: int
    n_dropped_dead: int = 0
    n_patched: int = 0  # broken flood paths rerouted via the p2p algorithm
    fault_summary: dict | None = None
    engine: str = "golden"
    method: str = "enumerated"  # "enumerated" pairs or "closed_form" (streaming, large n)

    def row(self) -> dict:
        return {
            "total_rounds": self.total_rounds,
            "bound_rounds": self.bound_rounds,
            "rounds_vs_bound": round(self.rounds_vs_bound, 3),
            "max_hops": self.max_hops,
            "avg_hops": round(self.avg_hops, 2),
            "uniform_load": self.uniform_load,
            "patched": self.n_patched,
        }


def asymmetric_bandwidth(topo: CLEXTopology) -> dict:
    """The paper's asymmetric assignment: short links are physically cheap,
    so level l gets ~m^{(L-l)/3} units per edge (capacity proportional to
    the inverse link length), longest links one unit."""
    growth = topo.level_length_ratio()
    return {
        level: max(1, int(round(growth ** (topo.L - level))))
        for level in range(1, topo.L + 1)
    }


def simulate_all_to_all(
    topo: CLEXTopology,
    bandwidth: dict | None = None,
    faults: FaultSet | None = None,
    seed: int = 0,
    max_nodes: int = 2048,
    engine="golden",
    device=None,
) -> AllToAllResult:
    """Simulate full all-to-all (one message per ordered node pair) under the
    Sec. II-C flooding schedule with asymmetric per-level bandwidth.

    Phase 1 sends every message over its clique edge, phase l (2..L) over
    its level-l bundle edge; a phase with per-edge capacity ``bandwidth[l]``
    takes ceil(max_edge_load / bandwidth[l]) synchronous rounds.  The
    schedule is deadlock-free by construction (phases are totally ordered
    and every message holds exactly one link per round) and its per-edge
    load is *exactly* n/m on every edge — which is what makes the measured
    rounds land on the analytic ``rounds_bound`` of
    :func:`analysis.all_to_all_comparison`.

    Under ``faults`` the deterministic flood path has no slack, so messages
    whose path touches a dead node/edge are rerouted by the fault-aware
    point-to-point algorithm instead (counted as ``n_patched``); live-pair
    delivery stays 100%.

    ``engine='golden'`` materialises all n^2 pairs (``max_nodes`` guard);
    ``engine='streaming'`` chunks the pair space with bincount
    accumulators and switches to the exact closed form at paper scale —
    see :func:`~.streaming.simulate_all_to_all_streaming`.
    """
    return get_engine(engine, device).run_all_to_all(
        topo, bandwidth=bandwidth, faults=faults, seed=seed, max_nodes=max_nodes,
    )


def _all_to_all_golden(
    topo: CLEXTopology,
    bandwidth: dict | None = None,
    faults: FaultSet | None = None,
    seed: int = 0,
    max_nodes: int = 2048,
    device=None,
) -> AllToAllResult:
    """The golden (explicit per-pair) all-to-all, on ``device``: the
    reference the streaming counterpart is pinned against at small n."""
    n, m, L = topo.n, topo.m, topo.L
    if n > max_nodes:
        raise ValueError(f"explicit all-to-all only for n <= {max_nodes} (got {n})")
    dev = resolve_device(device)
    bandwidth = dict(bandwidth or {})
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    src = ids.repeat_interleave(n)
    dst = ids.repeat(n)
    n_dropped = 0
    if faults is not None:
        live = faults.node_alive(src) & faults.node_alive(dst)
        n_dropped = int((~live).sum())
        src, dst = src[live], dst[live]
    pos = flood_route(topo, src, dst)

    # faults: a flood path is broken if any intermediate node is dead or the
    # used bundle edge is dead (clique links fail only via their endpoints).
    broken = torch.zeros(src.shape[0], dtype=torch.bool, device=dev)
    if faults is not None:
        for level in range(1, L):
            broken |= ~faults.node_alive(pos[level])
        for level in range(2, L + 1):
            edge = digit(dst, level - 2, m)
            broken |= ~faults.edge_alive(level, pos[level - 1], edge)
    ok = ~broken

    rounds_per_level: dict[int, int] = {}
    max_loads: dict[int, int] = {}
    # exact-n/m uniformity is only defined for the full fault-free traffic;
    # under faults it is unverified, reported as None
    uniform: "bool | None" = True if faults is None else None
    bound = n // m
    # phase 1: clique edges (messages whose clique hop is a no-op stay put)
    moved = (pos[1] != pos[0]) & ok
    if bool(moved.any()):
        _, counts = torch.unique(flood_edge_keys(topo, pos, dst, 1)[moved],
                                 return_counts=True)
        max_loads[1] = int(counts.max())
        if faults is None:
            uniform = uniform and bool((counts == bound).all())
    else:
        max_loads[1] = 0
    for level in range(2, L + 1):
        keys = flood_edge_keys(topo, pos, dst, level)[ok]
        _, counts = torch.unique(keys, return_counts=True)
        max_loads[level] = int(counts.max()) if counts.numel() else 0
        if faults is None:
            uniform = uniform and bool((counts == bound).all())
    for level in range(1, L + 1):
        cap = max(int(bandwidth.get(level, 1)), 1)
        rounds_per_level[level] = math.ceil(max_loads[level] / cap)
    total_rounds = sum(rounds_per_level.values())

    hops = (torch.diff(pos, dim=0) != 0).sum(dim=0)[ok]
    n_patched = int(broken.sum())
    if n_patched:
        patched = simulate_point_to_point(
            topo, 1, mode="light", seed=seed, src=src[broken], dst=dst[broken],
            faults=faults, device=dev,
        )
        assert patched.delivered_fraction == 1.0

    comp = all_to_all_comparison(topo, bandwidth)
    bound_rounds = comp["rounds_bound"]
    return AllToAllResult(
        topo=topo,
        bandwidth=bandwidth,
        rounds_per_level=rounds_per_level,
        total_rounds=total_rounds,
        max_edge_load_per_level=max_loads,
        per_edge_load_bound=bound,
        uniform_load=uniform,
        max_hops=int(hops.max()) if hops.numel() else 0,
        avg_hops=float(int(hops.sum())) / hops.numel() if hops.numel() else 0.0,
        bound_rounds=bound_rounds,
        rounds_vs_bound=total_rounds / max(bound_rounds, 1),
        n_messages=int(src.shape[0]),
        n_dropped_dead=n_dropped,
        n_patched=n_patched,
        fault_summary=faults.describe() if faults is not None else None,
        engine="golden",
        method="enumerated",
    )


# ------------------------------------------------------------- fault curves
def fault_degradation_curve(
    topo: CLEXTopology,
    rates=(0.0, 0.01, 0.02, 0.05),
    msgs_per_node: int = 4,
    mode: str = "dense",
    seed: int = 0,
    edge_rate: "float | None" = None,
    scenario: str = "uniform",
    engine="golden",
    device=None,
) -> list[dict]:
    """Delivery and degradation vs injected fault rate: the inherent-fault-
    tolerance demonstration.  Every row asserts 100% delivery of live-pair
    messages; degradation shows up as detours, extra hops, and slowdown of
    ``sum_avg_rounds`` relative to the fault-free run."""
    rows = []
    base_rounds = None
    for rate in rates:
        rng = np.random.default_rng(seed)
        faults = FaultSet.sample(
            topo, node_rate=rate,
            edge_rate=rate if edge_rate is None else edge_rate, rng=rng,
        )
        res = run_clex_scenario(
            topo, scenario, msgs_per_node, mode, seed, valiant=False, faults=faults,
            engine=engine, device=device,
        )
        if base_rounds is None:
            base_rounds = res.sum_avg_rounds
        rows.append({
            "node_rate": rate,
            "dead_nodes": faults.n_dead_nodes,
            "dead_edges": faults.n_dead_edges,
            "n_messages": res.n_messages,
            "dropped_dead_pairs": res.n_dropped_dead,
            "delivered_fraction": res.delivered_fraction,
            "detours": res.total_detours,
            "sum_avg_rds": round(res.sum_avg_rounds, 2),
            "sum_avg_hops": round(res.sum_avg_hops, 2),
            "slowdown_vs_fault_free": round(
                res.sum_avg_rounds / max(base_rounds, 1e-9), 3),
        })
    return rows
