"""CLEX and torus topologies (Lenzen & Wattenhofer, "CLEX: Yet Another
Supercomputer Architecture?"), on tensors.

The port's copy of the JAX package's ``core/topology.py``.  C(s, L) is
defined recursively (paper Def. 2.3):

    C(s, 1)   = K_{n^s}                      (a clique of m := n^s nodes)
    C(s, l+1) = n^s copies of C(s, l) plus the inter-copy bundles E_{i,l+1}.

A node of C(s, L) (L = 1/s levels, n = m^L nodes) is an integer whose
base-m digits are the paper's label, digit 0 being the position inside
the level-1 clique.  The level-(l+1) bundle of node x (m parallel edges)
leads to the nodes y with

    y_i = x_i          for i in 0 .. l-2      (low digits preserved)
    y_{l-1}  free      (the m edges of the bundle)
    y_l = x_{l-1}      (destination copy index = source digit l-1)
    y_i = x_i          for i > l              (same enclosing copy)

so everything the simulator needs is digit arithmetic on ``int64``
tensors; the million-node graphs are never materialised.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "CLEXTopology",
    "FaultSet",
    "TorusTopology",
    "digit",
    "with_digit",
    "copy_index",
]


def digit(x, pos: int, m: int):
    """Base-m digit at position ``pos`` of node id ``x`` (int or tensor)."""
    return (x // m**pos) % m


def with_digit(x, pos: int, m: int, value):
    """Return node id equal to ``x`` but with digit ``pos`` replaced."""
    return x + (value - digit(x, pos, m)) * m**pos


def copy_index(x, level: int, m: int):
    """Index of the level-``level`` copy containing ``x`` (digits >= level)."""
    return x // m**level


def as_long(x, device=None) -> torch.Tensor:
    """Node ids or message endpoints (a list, numpy array or tensor) as an
    ``int64`` tensor, moved to ``device`` where one is given."""
    x = torch.as_tensor(x, dtype=torch.int64)
    return x if device is None else x.to(device)


def from_host(draw: np.ndarray, device) -> torch.Tensor:
    """A numpy Generator's draw, moved to ``device``.  The simulator's
    random draws stay numpy calls made in the reference's order (no torch
    generator reproduces those streams); only their outputs move."""
    return torch.from_numpy(np.ascontiguousarray(draw)).to(device)


@dataclasses.dataclass(frozen=True)
class CLEXTopology:
    """C(s, L) with clique size m = n^s and L = 1/s levels (n = m**L)."""

    m: int  # clique size n^s
    L: int  # number of levels 1/s

    def __post_init__(self):
        if self.m < 2 or self.L < 1:
            raise ValueError(f"invalid CLEX parameters m={self.m} L={self.L}")

    # ---- basic quantities (paper Sec. II-B) ------------------------------
    @property
    def n(self) -> int:
        return self.m**self.L

    @property
    def s(self) -> float:
        return 1.0 / self.L

    @property
    def degree(self) -> int:
        """Uniform out-degree of C(s, 1/s):  n^s / s - 1  (paper)."""
        return self.m * self.L - 1

    @property
    def fat_link_degree(self) -> int:
        """Degree when each level bundle is one fat link: n^s + 1/s - 2."""
        return self.m + self.L - 2

    @property
    def diameter_bound(self) -> int:
        """D(C(s, 1/s)) <= 2^{1/s} - 1 (paper)."""
        return 2**self.L - 1

    def num_directed_bundle_edges(self, level: int) -> int:
        """Directed edges on ``level`` (2..L): one m-edge bundle per node."""
        if not 2 <= level <= self.L:
            raise ValueError(f"level must be in 2..{self.L}")
        return self.n * self.m

    # ---- physical embedding (hierarchical cubes, paper Sec. II-B/III) ---
    def side_length(self, level: int, d_min: float = 1.0) -> float:
        """Edge length of the cube holding one level-``level`` copy."""
        return d_min * (self.m**level) ** (1.0 / 3.0)

    def max_link_length(self, level: int, d_min: float = 1.0) -> float:
        """Maximal physical length of a level-``level`` link:
        sqrt(3) * n^{l s / 3} / 2 (paper Sec. II-C)."""
        return math.sqrt(3.0) * self.side_length(level, d_min) / 2.0

    def level_length_ratio(self) -> float:
        """Per-level growth of link lengths: m^{1/3} (3.2 for m=32, 4 for 64)."""
        return self.m ** (1.0 / 3.0)

    def propagation_optimum(self, d_min: float = 1.0) -> float:
        """(1+o(1)) sqrt(3) n^{1/3} / 2: the physical lower bound any
        architecture must pay (paper Sec. II-C)."""
        return math.sqrt(3.0) * (self.n ** (1.0 / 3.0)) * d_min / 2.0

    def all_to_all_propagation(self, d_min: float = 1.0) -> float:
        """Sum over levels of the max link length."""
        return sum(self.max_link_length(l, d_min) for l in range(1, self.L + 1))

    # ---- routing helpers (digit arithmetic used by the simulator) -------
    def bundle_target_copy(self, x, level: int):
        """Copy of C(s, level-1) reached by x's level-``level`` bundle
        (digit position level-2 of x)."""
        return digit(x, level - 2, self.m)

    def gateway_digit_pos(self, level: int) -> int:
        """Digit position that must equal the destination copy for a node to
        own level-``level`` edges toward it."""
        return level - 2

    # ---- explicit construction for small instances ----------------------
    def build_out_edges(self, device=None) -> torch.Tensor:
        """Directed out-edge count matrix (self-loops included, as the paper
        allows) for small n: an ``int32`` tensor on ``device``."""
        n, m = self.n, self.m
        if n > 4096:
            raise ValueError("explicit adjacency only for small instances")
        dev = resolve_device(device)
        ids = torch.arange(n, device=dev)
        same_clique = (ids[:, None] // m) == (ids[None, :] // m)
        adj = (same_clique & (ids[:, None] != ids[None, :])).to(torch.int32)
        j = torch.arange(m, device=dev)
        for level in range(2, self.L + 1):
            lows = ids % m ** max(level - 2, 0)
            base = (copy_index(ids, level, m) * m**level
                    + digit(ids, level - 2, m) * m ** (level - 1))
            y = base[:, None] + j[None, :] * m ** (level - 2) + lows[:, None]
            adj.view(-1).index_add_(0, (ids[:, None] * n + y).flatten(),
                                    torch.ones(n * m, dtype=torch.int32, device=dev))
        return adj

    def build_adjacency(self, device=None) -> torch.Tensor:
        """Symmetrised boolean adjacency without self-loops."""
        counts = self.build_out_edges(device)
        adj = (counts + counts.T) > 0
        adj.fill_diagonal_(False)
        return adj

    def build_networkx(self):
        import networkx as nx

        return nx.from_numpy_array(self.build_adjacency("cpu").numpy())


class FaultSet:
    """Injected faults on a :class:`CLEXTopology`: dead nodes and dead
    directed bundle edges (levels >= 2).

    * ``dead_nodes``: sorted unique node ids (a numpy array, as the
      reference keeps it) that neither originate, relay, nor receive;
    * ``dead_edges[level]``: sorted unique keys ``node * m + edge_index``
      of dead directed level-``level`` bundle edges.

    The lists stay on the host, where :meth:`sample` draws them with a
    numpy Generator.  The liveness queries take ``int64`` tensors and
    answer on their device from dense masks (n flags for the nodes, n * m
    for each level's edges), built once per device.
    """

    def __init__(
        self,
        topo: CLEXTopology,
        dead_nodes=(),
        dead_edges: "dict[int, np.ndarray] | None" = None,
    ):
        self.topo = topo
        self.dead_nodes = np.unique(np.asarray(list(dead_nodes), dtype=np.int64))
        if (self.dead_nodes < 0).any() or (self.dead_nodes >= topo.n).any():
            raise ValueError("dead node id out of range")
        self.dead_edges = {}
        for level, keys in (dead_edges or {}).items():
            if not 2 <= level <= topo.L:
                raise ValueError(f"bundle level must be in 2..{topo.L}")
            keys = np.unique(np.asarray(keys, dtype=np.int64))
            if keys.size:
                if (keys < 0).any() or (keys >= topo.n * topo.m).any():
                    raise ValueError("dead edge key out of range")
                self.dead_edges[level] = keys
        self._masks: dict[torch.device, tuple] = {}

    @classmethod
    def sample(
        cls,
        topo: CLEXTopology,
        node_rate: float = 0.0,
        edge_rate: float = 0.0,
        rng: "np.random.Generator | None" = None,
        protect=(),
    ) -> "FaultSet":
        """Sample u.a.r. faults with the numpy Generator ``rng``, drawing
        exactly as the reference does: ``node_rate`` of nodes die,
        ``edge_rate`` of each level's directed bundle edges die;
        ``protect`` nodes never die."""
        rng = rng or np.random.default_rng(0)
        n, m = topo.n, topo.m
        protect = np.asarray(list(protect), dtype=np.int64)
        n_dead = int(round(node_rate * n))
        candidates = np.setdiff1d(np.arange(n, dtype=np.int64), protect)
        n_dead = min(n_dead, candidates.shape[0])
        dead_nodes = rng.choice(candidates, size=n_dead, replace=False) if n_dead else ()
        dead_edges = {}
        for level in range(2, topo.L + 1):
            k = int(round(edge_rate * n * m))
            if k:
                dead_edges[level] = rng.choice(n * m, size=k, replace=False).astype(np.int64)
        return cls(topo, dead_nodes, dead_edges)

    @property
    def n_dead_nodes(self) -> int:
        return int(self.dead_nodes.shape[0])

    @property
    def n_dead_edges(self) -> int:
        return int(sum(v.shape[0] for v in self.dead_edges.values()))

    def describe(self) -> dict:
        return {
            "dead_nodes": self.n_dead_nodes,
            "dead_edges": self.n_dead_edges,
            "node_rate": round(self.n_dead_nodes / self.topo.n, 4),
        }

    def _dead(self, device: torch.device) -> tuple:
        """(dead-node flags [n], {level: dead-edge flags [n * m]}) on ``device``."""
        masks = self._masks.get(device)
        if masks is None:
            n, m = self.topo.n, self.topo.m
            nodes = torch.zeros(n, dtype=torch.bool, device=device)
            nodes[torch.from_numpy(self.dead_nodes).to(device)] = True
            edges = {}
            for level, keys in self.dead_edges.items():
                edges[level] = torch.zeros(n * m, dtype=torch.bool, device=device)
                edges[level][torch.from_numpy(keys).to(device)] = True
            masks = self._masks[device] = (nodes, edges)
        return masks

    def node_alive(self, x) -> torch.Tensor:
        """Boolean liveness of node ids ``x`` (any shape)."""
        x = as_long(x)
        return ~self._dead(x.device)[0][x]

    def live_nodes(self, device=None) -> torch.Tensor:
        dev = resolve_device(device)
        return torch.nonzero(~self._dead(dev)[0]).flatten()

    def edge_alive(self, level: int, node, edge_index) -> torch.Tensor:
        """Liveness of the directed level-``level`` bundle edge(s)
        ``(node, edge_index)``: the edge itself, not its endpoints."""
        node = as_long(node)
        key = node * self.topo.m + as_long(edge_index, node.device)
        dead = self._dead(key.device)[1].get(level)
        if dead is None:
            return torch.ones_like(key, dtype=torch.bool)
        return ~dead[key]

    def bundle_targets(self, nodes, level: int) -> torch.Tensor:
        """[k, m] node ids reached by each node's level-``level`` bundle
        (edge j lands on the node whose digit ``level-2`` is set by j)."""
        m = self.topo.m
        nodes = as_long(nodes)
        low_span = m ** (level - 2)
        lows = nodes % low_span
        b = digit(nodes, level - 2, m)
        base = copy_index(nodes, level, m) * m**level + b * m ** (level - 1)
        j = torch.arange(m, dtype=torch.int64, device=nodes.device)
        return base[:, None] + j[None, :] * low_span + lows[:, None]

    def live_edge_mask(self, nodes, level: int) -> torch.Tensor:
        """[k, m] mask of usable bundle edges: the directed edge is alive AND
        its target node is alive."""
        nodes = as_long(nodes)
        alive = self.node_alive(self.bundle_targets(nodes, level))
        dead = self._dead(nodes.device)[1].get(level)
        if dead is not None:
            j = torch.arange(self.topo.m, dtype=torch.int64, device=nodes.device)
            alive &= ~dead[nodes[:, None] * self.topo.m + j[None, :]]
        return alive


@dataclasses.dataclass(frozen=True)
class TorusTopology:
    """3D torus of k1*k2*k3 nodes: the Blue Gene / Cray XMT baseline."""

    k1: int
    k2: int
    k3: int

    @classmethod
    def cube(cls, k: int) -> "TorusTopology":
        return cls(k, k, k)

    @property
    def n(self) -> int:
        return self.k1 * self.k2 * self.k3

    @property
    def degree(self) -> int:
        return 6

    def bisection_edges(self) -> int:
        """Minimum bisection: 2 k^2 for the symmetric torus (paper Sec. I)."""
        k = min(self.k1, self.k2, self.k3)
        pairs = {self.k1: self.k2 * self.k3, self.k2: self.k1 * self.k3, self.k3: self.k1 * self.k2}
        return 2 * min(pairs[self.k1], pairs[self.k2], pairs[self.k3]) if k else 0

    def all_to_all_avg_hops(self) -> float:
        """Dimension-ordered flooding: (k1 + k2 + k3)/2 >= 3 n^{1/3}/2."""
        return (self.k1 + self.k2 + self.k3) / 2.0

    def effective_p2p_bandwidth_fraction(self) -> float:
        """Upper bound on per-node effective bandwidth under u.i.r. traffic,
        as a fraction of node bandwidth B: 2 B / (3 n^{1/3}) (paper Sec. III-A)."""
        return 2.0 / (3.0 * self.n ** (1.0 / 3.0))

    def node_xyz(self, ids):
        x = ids % self.k1
        y = (ids // self.k1) % self.k2
        z = ids // (self.k1 * self.k2)
        return x, y, z

    def hop_distance(self, a, b):
        ax, ay, az = self.node_xyz(as_long(a))
        bx, by, bz = self.node_xyz(as_long(b))

        def ring(d, k):
            d = torch.abs(d)
            return torch.minimum(d, k - d)

        return ring(ax - bx, self.k1) + ring(ay - by, self.k2) + ring(az - bz, self.k3)
