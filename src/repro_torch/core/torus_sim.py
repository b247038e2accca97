"""Dimension-ordered-routing simulator for the 3D torus baseline, on
tensors.

The port's copy of the JAX package's ``core/torus_sim.py``: synchronous
DOR (x then y then z, shortest ring direction) with unit-capacity links
and FIFO queues, vectorised over messages (golden), and its paper-scale
streaming counterpart, which computes exact hops and directed-link loads
from the traffic alone.  The traffic shuffle and the per-round winner
draws are the reference's numpy Generator calls, made on the host in its
order; everything else runs on the run's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .routing import _flat
from .simulator import uniform_permutation_traffic
from .streaming import _rechunk
from .topology import TorusTopology, as_long, from_host

__all__ = [
    "TorusSimResult",
    "TorusStreamResult",
    "simulate_torus_dor",
    "simulate_torus_dor_streaming",
]


@dataclasses.dataclass
class TorusSimResult:
    topo: TorusTopology
    msgs_per_node: int
    avg_hops: float
    avg_rounds: float  # delivery time including queueing
    max_rounds: int
    congestion_overhead: float  # avg_rounds / avg_hops (1.0 = no queueing)

    def row(self) -> dict:
        return {
            "avg_hops": round(self.avg_hops, 2),
            "avg_rounds": round(self.avg_rounds, 2),
            "max_rounds": int(self.max_rounds),
            "congestion_overhead": round(self.congestion_overhead, 2),
        }


def _ring_step(cur: torch.Tensor, dst: torch.Tensor, k: int) -> torch.Tensor:
    """Next coordinate along the shorter ring direction (0 if arrived)."""
    d = (dst - cur) % k
    return torch.where(d == 0, 0, torch.where(d <= k // 2, 1, -1))


def _mean(total: int, count: int) -> float:
    """numpy's mean of an int64 array whose sum ``total`` is below 2^53:
    its float64 partial sums are exact, so the mean is total / count."""
    return float(total) / count


def simulate_torus_dor(
    topo: TorusTopology,
    msgs_per_node: int,
    seed: int = 0,
    max_rounds: int = 100000,
    src=None,
    dst=None,
    device=None,
) -> TorusSimResult:
    """Synchronous DOR with unit-capacity links, on ``device`` (the card
    unless the caller passes ``"cpu"``): per round, each directed link
    forwards one message (u.a.r. among contenders); losers wait.
    ``src``/``dst`` override the default uniform-permutation traffic."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if src is None or dst is None:
        src, dst = uniform_permutation_traffic(topo, msgs_per_node, rng, dev)
    src, dst = as_long(src, dev), as_long(dst, dev)

    ks = (topo.k1, topo.k2, topo.k3)
    cur = list(topo.node_xyz(src))
    dest = list(topo.node_xyz(dst))

    nmsg = src.shape[0]
    hops = torch.zeros(nmsg, dtype=torch.int64, device=dev)
    done_round = torch.full((nmsg,), -1, dtype=torch.int64, device=dev)
    arrived = (cur[0] == dest[0]) & (cur[1] == dest[1]) & (cur[2] == dest[2])
    done_round[arrived] = 0

    for rnd in range(1, max_rounds + 1):
        active = done_round < 0
        if not bool(active.any()):
            break
        idx = _flat(active)
        # DOR: the dimension each active message moves in next
        dim = torch.zeros(idx.shape[0], dtype=torch.int64, device=dev)
        for d in range(3):
            not_done_d = cur[d][idx] != dest[d][idx]
            dim = torch.where((dim == d) & ~not_done_d, dim + 1, dim)
        dim = torch.clamp(dim, max=2)
        steps = torch.zeros(idx.shape[0], dtype=torch.int64, device=dev)
        for d in range(3):
            sel = dim == d
            steps[sel] = _ring_step(cur[d][idx[sel]], dest[d][idx[sel]], ks[d])
        # link id: (node, dim, direction); one winner per link per round
        node = cur[0][idx] + ks[0] * (cur[1][idx] + ks[1] * cur[2][idx])
        link = (node * 3 + dim) * 2 + (steps > 0)
        order = from_host(rng.permutation(idx.shape[0]), dev)
        fin = order[torch.sort(link[order], stable=True).indices]
        first = torch.ones(idx.shape[0], dtype=torch.bool, device=dev)
        first[1:] = link[fin][1:] != link[fin][:-1]
        winners_local = fin[first]
        win = idx[winners_local]
        d_arr = dim[winners_local]
        s_arr = steps[winners_local]
        for d in range(3):
            sel = d_arr == d
            w = win[sel]
            cur[d][w] = (cur[d][w] + s_arr[sel]) % ks[d]
        hops[win] += 1
        arrived_now = (
            (cur[0][win] == dest[0][win])
            & (cur[1][win] == dest[1][win])
            & (cur[2][win] == dest[2][win])
        )
        done_round[win[arrived_now]] = rnd
    else:
        raise RuntimeError("torus DOR did not converge")

    avg_hops = _mean(int(hops.sum()), nmsg)
    avg_rounds = _mean(int(done_round.sum()), nmsg)
    return TorusSimResult(
        topo=topo,
        msgs_per_node=msgs_per_node,
        avg_hops=avg_hops,
        avg_rounds=avg_rounds,
        max_rounds=int(done_round.max()),
        congestion_overhead=avg_rounds / max(avg_hops, 1e-9),
    )


@dataclasses.dataclass
class TorusStreamResult:
    """Paper-scale DOR statistics without hop-stepping to delivery: exact
    per-message hops and per-directed-link loads, and
    ``completion_rounds_lb = max(max_hops, max_link_load)``, a tight lower
    bound on the synchronous completion time."""

    topo: TorusTopology
    msgs_per_node: int
    n_messages: int
    avg_hops: float  # exactly simulate_torus_dor's avg_hops for equal traffic
    max_hops: int
    max_link_load: int
    mean_link_load: float  # over links that carry >= 1 message
    links_used: int
    completion_rounds_lb: int

    def row(self) -> dict:
        return {
            "avg_hops": round(self.avg_hops, 2),
            "max_hops": int(self.max_hops),
            "max_link_load": int(self.max_link_load),
            "mean_link_load": round(self.mean_link_load, 2),
            "completion_rounds_lb": int(self.completion_rounds_lb),
        }


def _ring_dist_dir(cur: torch.Tensor, dst: torch.Tensor, k: int):
    """(distance, direction) of the shorter ring way, matching `_ring_step`
    (ties at k/2 go the +1 way)."""
    d = (dst - cur) % k
    dist = torch.where(d <= k // 2, d, k - d)
    return dist, _ring_step(cur, dst, k)


def simulate_torus_dor_streaming(
    topo: TorusTopology,
    msgs_per_node: int,
    seed: int = 0,
    src=None,
    dst=None,
    chunk_size: int = 1 << 18,
    traffic=None,
    device=None,
) -> TorusStreamResult:
    """Streaming counterpart of :func:`simulate_torus_dor` for paper-scale
    n, on ``device``: per-dimension ring distances plus a directed-link
    load histogram (``torch.bincount`` over the expanded per-dimension path
    segments), in message chunks.  Traffic defaults to the same uniform
    permutation as the golden engine's; ``traffic=`` takes a ``(start,
    src, dst)`` chunk stream.  The statistics are additive, so any
    chunking gives identical results."""
    n = topo.n
    if traffic is not None and (src is not None or dst is not None):
        raise ValueError("pass either src/dst arrays or traffic=, not both")
    dev = resolve_device(device)
    if traffic is None:
        if src is None or dst is None:
            src, dst = uniform_permutation_traffic(
                topo, msgs_per_node, np.random.default_rng(seed), dev)
        traffic = ((0, src, dst),)
    ks = (topo.k1, topo.k2, topo.k3)

    loads = torch.zeros(n * 6, dtype=torch.int64, device=dev)
    hops_total = 0
    max_hops = 0
    nmsg = 0
    for s_chunk, d_chunk in _rechunk(traffic, chunk_size, dev):
        nmsg += s_chunk.shape[0]
        sx, sy, sz = topo.node_xyz(s_chunk)
        dx, dy, dz = topo.node_xyz(d_chunk)
        d0, s0 = _ring_dist_dir(sx, dx, ks[0])
        d1, s1 = _ring_dist_dir(sy, dy, ks[1])
        d2, s2 = _ring_dist_dir(sz, dz, ks[2])
        hops = d0 + d1 + d2
        hops_total += int(hops.sum())
        max_hops = max(max_hops, int(hops.max()) if hops.numel() else 0)
        # DOR visits: x varies first (y, z at source), then y (x at dest,
        # z at source), then z (x, y at dest).  For each dimension, expand
        # the path's start nodes (one per hop) and bincount the links.
        for dim, (base, step, coords) in enumerate((
            (d0, s0, (sx, sy, sz)),
            (d1, s1, (dx, sy, sz)),
            (d2, s2, (dx, dy, sz)),
        )):
            tot = int(base.sum())
            if tot == 0:
                continue
            rep = torch.arange(base.shape[0], dtype=torch.int64, device=dev).repeat_interleave(
                base, output_size=tot)
            t = (torch.arange(tot, dtype=torch.int64, device=dev)
                 - (torch.cumsum(base, 0) - base).repeat_interleave(base, output_size=tot))
            k = ks[dim]
            var = (coords[dim][rep] + t * step[rep]) % k
            fixed = [c[rep] for c in coords]
            fixed[dim] = var
            node = fixed[0] + ks[0] * (fixed[1] + ks[1] * fixed[2])
            link = (node * 3 + dim) * 2 + (step[rep] > 0)
            loads += torch.bincount(link, minlength=n * 6)
    used = loads > 0
    max_link_load = int(loads.max())
    links_used = int(used.sum())
    mean_link_load = _mean(int(loads[used].sum()), links_used) if links_used else 0.0
    avg_hops = hops_total / max(nmsg, 1)
    return TorusStreamResult(
        topo=topo,
        msgs_per_node=msgs_per_node,
        n_messages=nmsg,
        avg_hops=avg_hops,
        max_hops=max_hops,
        max_link_load=max_link_load,
        mean_link_load=mean_link_load,
        links_used=links_used,
        completion_rounds_lb=max(max_hops, max_link_load),
    )
