"""Routing primitives for CLEX (paper Sec. II-C/II-D), on tensors.

The port's copy of the JAX package's ``core/routing.py``: digit arithmetic
on ``int64`` tensors, shared by the simulator and the tests:

* the recursive call schedule of A(l)  (A(l) = A(l-1), HOP_l, A(l-1));
* gateway sampling (Step 1 interim destinations);
* bundle-hop target computation (Step 2);
* the copy-count schedule k(i) of the clique load balancer A(1);
* log* and the all-to-all flooding schedule (Sec. II-C).

The functions that draw take the reference's numpy Generator and make
its calls in its order, with its sizes; the draws move to the device of
the messages (:func:`~.topology.from_host`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .topology import CLEXTopology, FaultSet, copy_index, digit, from_host

__all__ = [
    "log_star",
    "copy_schedule",
    "unrolled_schedule",
    "sample_gateways",
    "sample_gateways_faulty",
    "bundle_hop",
    "bundle_edge_targets",
    "bundle_rounds_from_counts",
    "all_to_all_tree_hops",
    "flood_route",
    "flood_edge_keys",
    "valiant_intermediate",
    "UnroutableError",
]


class UnroutableError(RuntimeError):
    """Raised when injected faults disconnect a message from its destination
    (no live gateway/edge exists after exhausting detours)."""


def log_star(x: float) -> int:
    """Inverse tower function: log* x = 1 for x <= 2, else 1 + log* log2 x."""
    if x <= 2:
        return 1
    return 1 + log_star(math.log2(x))


def copy_schedule(m: int, max_phases: int = 64) -> list[int]:
    """floor(k(i)) for phases i = 1, 2, ... of A(1) on a clique of m nodes:
    k(1) = 1;  k(i+1) = min(k(i) * e^{floor(k(i))/5}, sqrt(log2 m')).
    Phase 1 is the direct-send round, so its entry is 0 (no relay copies).
    """
    cap = max(2.0, math.sqrt(math.log2(max(m, 4))))
    ks = [0.0]  # phase 1: direct send, no copies
    k = 1.0
    for _ in range(max_phases - 1):
        ks.append(k)
        k = min(k * math.exp(math.floor(k) / 5.0), cap)
    return [int(math.floor(v)) for v in ks]


def unrolled_schedule(L: int) -> list[int]:
    """The iterative order of operations of A(L): 0 denotes an A(1) (clique
    load-balancing) call, l >= 2 a level-l bundle hop.
    seq(1) = [0];  seq(l) = seq(l-1) + [l] + seq(l-1)."""
    if L == 1:
        return [0]
    inner = unrolled_schedule(L - 1)
    return inner + [L] + inner


def _flat(mask: torch.Tensor) -> torch.Tensor:
    """np.flatnonzero of a boolean tensor."""
    return torch.nonzero(mask).flatten()


def sample_gateways(
    topo: CLEXTopology, cur: torch.Tensor, dest: torch.Tensor, level: int,
    rng: np.random.Generator,
) -> torch.Tensor:
    """Step 1 interim destinations of A(level) (paper Sec. II-D): a u.i.r.
    node of ``cur``'s level-(l-1) copy whose level-l bundle leads to the
    copy containing ``dest``."""
    m = topo.m
    base = copy_index(cur, level - 1, m) * m ** (level - 1)
    b = digit(dest, level - 1, m)
    low_span = m ** (level - 2)
    lows = (from_host(rng.integers(0, low_span, size=cur.shape[0], dtype=np.int64), cur.device)
            if low_span > 1 else 0)
    return base + b * low_span + lows


def _sorted_ranks(keys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Ranks 0..q-1 within each run of equal ``keys[order]`` (sorted), laid
    out in ``keys``' original order."""
    n = keys.shape[0]
    sorted_keys = keys[order]
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = sorted_keys[1:] != sorted_keys[:-1]
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    group_start = torch.cummax(torch.where(starts, idx, 0), 0).values
    ranks = torch.empty(n, dtype=torch.int64, device=keys.device)
    ranks[order] = idx - group_start
    return ranks


def _shuffled_order(keys: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """The permutation that sorts ``keys`` stably after a u.a.r. shuffle
    (the shuffle is the reference's ``rng.permutation`` draw)."""
    shuffle = from_host(rng.permutation(keys.shape[0]), keys.device)
    return shuffle[torch.sort(keys[shuffle], stable=True).indices]


def _per_key_ranks(keys: torch.Tensor, rng: np.random.Generator
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Random ranks 0..q-1 within each group of equal ``keys``.  Returns
    (ranks, order): ``keys[order]`` is sorted and the ranks are in the
    original layout."""
    order = _shuffled_order(keys, rng)
    return _sorted_ranks(keys, order), order


def _row_perms(noise: torch.Tensor) -> torch.Tensor:
    """Per-row argsort of uniform float64 noise.  The reference sorts with
    numpy's unstable argsort; its keys are 53-bit uniform draws, tie-free
    in practice, so any sort gives the reference's order."""
    return torch.argsort(noise, dim=1)


def bundle_hop(
    topo: CLEXTopology,
    cur: torch.Tensor,
    dest: torch.Tensor,
    level: int,
    rng: np.random.Generator,
    faults: FaultSet | None = None,
    audit: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 2 of A(level): every message crosses its gateway's level-l
    bundle, load-balanced over the bundle's (live) edges, surplus edges
    u.a.r. through a per-gateway random permutation.  Returns
    (new_positions, rounds); rounds[i] = rank // q + 1 for message i's
    random rank at its gateway over q live edges.  ``audit``, if given,
    receives a record of every traversed edge."""
    m = topo.m
    b = digit(dest, level - 1, m)
    ranks, _ = _per_key_ranks(cur, rng)
    gw_ids, gw_inv = torch.unique(cur, sorted=True, return_inverse=True)
    shape = (gw_ids.shape[0], m)
    if faults is None:
        # per-gateway random permutation of edge indices
        edge = _row_perms(from_host(rng.random(shape), cur.device))[gw_inv, ranks % m]
        rounds = ranks // m + 1
    else:
        allowed = faults.live_edge_mask(gw_ids, level)  # [G, m]
        counts = allowed.sum(dim=1)
        if bool((counts == 0).any()):
            raise UnroutableError(
                f"gateway with zero live level-{level} bundle edges selected"
            )
        # dead edges pushed past the end of each gateway's permutation
        noise = from_host(rng.random(shape), cur.device)
        perms = _row_perms(noise + (~allowed).to(torch.float64) * 2.0)
        q = counts[gw_inv]
        edge = perms[gw_inv, ranks % q]
        rounds = ranks // q + 1
    new = bundle_edge_targets(topo, cur, b, edge, level)
    if audit is not None:
        audit.append({"level": level, "node": cur.clone(), "edge": edge.clone(),
                      "round": rounds.clone(), "target": new.clone()})
    return new, rounds


def bundle_edge_targets(topo: CLEXTopology, cur: torch.Tensor, dest_copy, edge,
                        level: int) -> torch.Tensor:
    """Node reached by crossing ``cur``'s level-``level`` bundle on parallel
    edge ``edge`` toward sibling copy ``dest_copy``.  Pure digit
    arithmetic, so chunked inputs of any size give the same answer."""
    m = topo.m
    low_span = m ** (level - 2)
    upper = copy_index(cur, level, m)
    return upper * m**level + dest_copy * m ** (level - 1) + edge * low_span + cur % low_span


def bundle_rounds_from_counts(counts, live_edges) -> tuple[int, int]:
    """Exact aggregate of :func:`bundle_hop`'s round accounting from a
    per-gateway message-count histogram: ``c`` messages rank-balanced over
    ``q`` live edges cross in rounds r//q + 1 for ranks r = 0..c-1,
    totalling T(c, q) = q * k(k-1)/2 + rem * k + c (k = c // q, rem = c % q),
    with max round ceil(c / q).  Returns ``(rounds_total, max_rounds)``."""
    c = torch.as_tensor(counts, dtype=torch.int64)
    if c.numel() == 0:
        return 0, 0
    q = torch.as_tensor(live_edges, dtype=torch.int64, device=c.device).broadcast_to(c.shape)
    if bool((q <= 0).any()):
        raise UnroutableError("bundle with zero live edges carried messages")
    k = c // q
    rem = c - k * q
    total = int((q * (k * (k - 1) // 2) + rem * k + c).sum())
    max_rounds = int(((c + q - 1) // q).max())
    return total, max_rounds


def sample_gateways_faulty(
    topo: CLEXTopology,
    cur: torch.Tensor,
    target_copy: torch.Tensor,
    level: int,
    rng: np.random.Generator,
    faults: FaultSet,
    max_tries: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fault-aware Step 1: sample a live gateway of ``cur``'s level-(l-1)
    copy whose level-l bundle (digit l-2 == ``target_copy``) has >= 1 live
    edge.  Returns ``(gateways, stuck)``; ``stuck`` is exact: after
    ``max_tries`` rejection draws the stragglers are checked exhaustively."""
    m = topo.m
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
        lows = from_host(rng.integers(0, low_span, size=nmsg, dtype=np.int64), dev)
    else:
        lows = torch.zeros(nmsg, dtype=torch.int64, device=dev)
    gw = base + target_copy * low_span + lows
    good = ok(gw)
    tries = 1
    while not bool(good.all()) and tries < max_tries and low_span > 1:
        idx = _flat(~good)
        lows = from_host(rng.integers(0, low_span, size=idx.shape[0], dtype=np.int64), dev)
        cand = base[idx] + target_copy[idx] * low_span + lows
        fixed = ok(cand)
        gw[idx[fixed]] = cand[fixed]
        good[idx[fixed]] = True
        tries += 1
    if not bool(good.all()):
        # exhaustive check for the stragglers, per unique (copy-base, target)
        idx = _flat(~good)
        pair_keys = base[idx] * m + target_copy[idx]
        for key in torch.unique(pair_keys, sorted=True).tolist():
            sel = idx[pair_keys == key]
            pbase, ptgt = key // m, key % m
            cand = pbase + ptgt * low_span + torch.arange(low_span, dtype=torch.int64, device=dev)
            live = cand[ok(cand)]
            if live.numel():
                # rng.choice(live, size) draws its indices as rng.choice(len(live), size)
                pick = rng.choice(live.numel(), size=sel.shape[0], replace=True)
                gw[sel] = live[from_host(pick, dev)]
                good[sel] = True
    return gw, ~good


def all_to_all_tree_hops(topo: CLEXTopology) -> int:
    """All-to-all flooding (Sec. II-C): each message traverses at most one
    edge per level; returns the per-message hop bound (= L)."""
    return topo.L


def flood_route(topo: CLEXTopology, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Positions of the Sec. II-C flooding route, one edge per level.

    One clique hop plants ``dst``'s digit L-1 into digit 0; each level-l
    crossing moves it up one position while the free parallel-edge choice
    writes ``dst``'s digit l-2 into the freed position.  Returns positions
    of shape ``(L + 1, nmsg)``: row 0 is ``src``, row L equals ``dst``."""
    m, L = topo.m, topo.L
    src = torch.as_tensor(src, dtype=torch.int64)
    dst = torch.as_tensor(dst, dtype=torch.int64, device=src.device)
    pos = torch.empty((L + 1, src.shape[0]), dtype=torch.int64, device=src.device)
    pos[0] = src
    top = digit(dst, L - 1, m)
    pos[1] = src + (top - digit(src, 0, m))  # with_digit(src, 0, top)
    for level in range(2, L + 1):
        cur = pos[level - 1]
        low_span = m ** (level - 2)
        b = digit(cur, level - 2, m)  # the pipelined dst top digit
        edge = digit(dst, level - 2, m)
        upper = copy_index(cur, level, m)
        pos[level] = upper * m**level + b * m ** (level - 1) + edge * low_span + cur % low_span
    if not torch.equal(pos[L], dst):
        raise AssertionError("flood route failed to reach destinations")
    return pos


def flood_edge_keys(topo: CLEXTopology, pos: torch.Tensor, dst: torch.Tensor,
                    level: int) -> torch.Tensor:
    """Bincount key (``node * m + edge_index``, key space n*m) of the
    directed edge a flood-routed message uses at hop ``level``: the clique
    edge from ``pos[0]`` to ``pos[1]`` at level 1, else the bundle edge out
    of gateway ``pos[level-1]`` whose index is ``dst``'s digit level-2."""
    m = topo.m
    if level == 1:
        return pos[0] * m + digit(pos[1], 0, m)
    return pos[level - 1] * m + digit(dst, level - 2, m)


def valiant_intermediate(
    topo: CLEXTopology,
    sources: torch.Tensor,
    rng: np.random.Generator,
    within_level: int | None = None,
    faults: FaultSet | None = None,
) -> torch.Tensor:
    """Valiant's trick: u.i.r. intermediate destinations, inside the
    level-``within_level`` copy of each source where given (the paper's
    lightweight variant).  With ``faults``, dead intermediates are
    rejection-resampled."""
    dev = sources.device

    def draw(srcs: torch.Tensor) -> torch.Tensor:
        if within_level is None:
            return from_host(rng.integers(0, topo.n, size=srcs.shape[0], dtype=np.int64), dev)
        span = topo.m**within_level
        lows = from_host(rng.integers(0, span, size=srcs.shape[0], dtype=np.int64), dev)
        return (srcs // span) * span + lows

    mid = draw(sources)
    if faults is not None:
        for _ in range(64):
            bad = ~faults.node_alive(mid)
            if not bool(bad.any()):
                break
            mid[bad] = draw(sources[bad])
        if not bool(faults.node_alive(mid).all()):
            raise UnroutableError("no live Valiant intermediate found")
    return mid
