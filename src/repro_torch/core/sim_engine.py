"""The simulator engine seam: one interface, two engines.

The port's copy of the JAX package's ``core/sim_engine.py``:

* :class:`GoldenEngine`: the per-message machine of :mod:`.simulator` /
  :mod:`.torus_sim`; exact reference semantics, audit traces, small n.
* :class:`StreamingEngine`: the paper-scale chunked machine of
  :mod:`.streaming`; hashed per-message draws (bit-identical across
  chunk sizes and devices) and count-histogram statistics.

Each engine runs on its ``device`` (the card unless the caller passes
``"cpu"``).  ``get_engine("golden"|"streaming", device)`` resolves the
knob; an engine instance passes through as it is.
"""

from __future__ import annotations

import abc

import torch

from ..device import resolve_device
from .simulator import SimulationResult, simulate_point_to_point
from .streaming import (
    DEFAULT_CHUNK,
    DEFAULT_MAX_PAIRS,
    simulate_all_to_all_streaming,
    simulate_point_to_point_streaming,
)
from .topology import CLEXTopology, FaultSet, TorusTopology, as_long
from .torus_sim import (
    TorusSimResult,
    TorusStreamResult,
    simulate_torus_dor,
    simulate_torus_dor_streaming,
)

__all__ = ["SimEngine", "GoldenEngine", "StreamingEngine", "get_engine"]


def _materialize(traffic, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate a ``(start, src, dst)`` chunk stream into full endpoint
    tensors, as the (per-message) golden engine consumes it."""
    device = resolve_device(device)
    parts = [(as_long(s, device), as_long(d, device)) for _, s, d in traffic]
    if not parts:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, empty
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


class SimEngine(abc.ABC):
    """Routing/statistics contract: run a whole scenario, return the
    Tables I-IV statistics object.  Traffic enters as ``src``/``dst``
    arrays or as ``traffic=``, an iterable of ``(start, src_chunk,
    dst_chunk)`` pieces (:func:`~.scenarios.iter_traffic`)."""

    name: str = "abstract"

    def __init__(self, device=None):
        self.device = device

    @abc.abstractmethod
    def run_clex(
        self,
        topo: CLEXTopology,
        msgs_per_node: int,
        mode: str = "dense",
        seed: int = 0,
        src=None,
        dst=None,
        valiant_level: int | None = None,
        faults: FaultSet | None = None,
        audit: bool = False,
        traffic=None,
    ) -> SimulationResult:
        """Route point-to-point traffic through A(L) on ``topo``."""

    @abc.abstractmethod
    def run_torus(
        self,
        topo: TorusTopology,
        msgs_per_node: int,
        seed: int = 0,
        src=None,
        dst=None,
        max_rounds: int = 100000,
        traffic=None,
    ) -> TorusSimResult | TorusStreamResult:
        """Route the same traffic through the DOR torus baseline."""

    @abc.abstractmethod
    def run_all_to_all(
        self,
        topo: CLEXTopology,
        bandwidth: dict | None = None,
        faults: FaultSet | None = None,
        seed: int = 0,
        max_nodes: int = 2048,
        max_pairs: int | None = None,
    ):
        """Run the Sec. II-C all-to-all flooding schedule on ``topo``
        (``max_nodes`` guards the golden engine's n^2 pairs, ``max_pairs``
        is the streaming engine's enumeration budget)."""


class GoldenEngine(SimEngine):
    """The per-message reference machine (exact semantics, small n)."""

    name = "golden"

    def run_clex(self, topo, msgs_per_node, mode="dense", seed=0, src=None, dst=None,
                 valiant_level=None, faults=None, audit=False, traffic=None):
        if traffic is not None:
            if src is not None or dst is not None:
                raise ValueError("pass either src/dst arrays or traffic=, not both")
            src, dst = _materialize(traffic, self.device)
        return simulate_point_to_point(
            topo, msgs_per_node, mode=mode, seed=seed, src=src, dst=dst,
            valiant_level=valiant_level, faults=faults, audit=audit, device=self.device,
        )

    def run_torus(self, topo, msgs_per_node, seed=0, src=None, dst=None,
                  max_rounds=100000, traffic=None):
        if traffic is not None:
            if src is not None or dst is not None:
                raise ValueError("pass either src/dst arrays or traffic=, not both")
            src, dst = _materialize(traffic, self.device)
        return simulate_torus_dor(
            topo, msgs_per_node, seed=seed, max_rounds=max_rounds, src=src, dst=dst,
            device=self.device,
        )

    def run_all_to_all(self, topo, bandwidth=None, faults=None, seed=0,
                       max_nodes=2048, max_pairs=None):
        from .scenarios import _all_to_all_golden  # deferred: scenarios imports us

        return _all_to_all_golden(
            topo, bandwidth=bandwidth, faults=faults, seed=seed, max_nodes=max_nodes,
            device=self.device,
        )


class StreamingEngine(SimEngine):
    """The paper-scale chunked machine (see :mod:`.streaming`)."""

    name = "streaming"

    def __init__(self, chunk_size: int = DEFAULT_CHUNK, device=None):
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        super().__init__(device)
        self.chunk_size = chunk_size

    def run_clex(self, topo, msgs_per_node, mode="dense", seed=0, src=None, dst=None,
                 valiant_level=None, faults=None, audit=False, traffic=None):
        return simulate_point_to_point_streaming(
            topo, msgs_per_node, mode=mode, seed=seed, src=src, dst=dst,
            valiant_level=valiant_level, faults=faults, audit=audit,
            chunk_size=self.chunk_size, traffic=traffic, device=self.device,
        )

    def run_torus(self, topo, msgs_per_node, seed=0, src=None, dst=None,
                  max_rounds=100000, traffic=None):
        return simulate_torus_dor_streaming(
            topo, msgs_per_node, seed=seed, src=src, dst=dst,
            chunk_size=max(1, min(self.chunk_size, 1 << 18)), traffic=traffic,
            device=self.device,
        )

    def run_all_to_all(self, topo, bandwidth=None, faults=None, seed=0,
                       max_nodes=2048, max_pairs=None):
        return simulate_all_to_all_streaming(
            topo, bandwidth=bandwidth, faults=faults, seed=seed,
            chunk_size=self.chunk_size,
            max_pairs=DEFAULT_MAX_PAIRS if max_pairs is None else max_pairs,
            device=self.device,
        )


_ENGINES: dict[str, type[SimEngine]] = {
    "golden": GoldenEngine,
    "streaming": StreamingEngine,
}


def get_engine(engine: str | SimEngine, device=None) -> SimEngine:
    """Resolve the ``engine=`` knob: a name from {'golden', 'streaming'}
    (built on ``device``) or a ready :class:`SimEngine` instance (passed
    through, on its own device)."""
    if isinstance(engine, SimEngine):
        return engine
    try:
        cls = _ENGINES[engine]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown engine {engine!r}: expected one of {sorted(_ENGINES)} "
            "or a SimEngine instance"
        ) from None
    return cls(device=device)
