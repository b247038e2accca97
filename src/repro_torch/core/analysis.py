"""Derived performance comparisons of paper Sec. III.

The port's copy of the JAX package's ``core/analysis.py`` (pure Python
over a result's statistics; nothing here touches a device).

All formulas follow the paper exactly:

* torus theoretical optimum under u.i.r. traffic: effective per-node
  bandwidth 2B/(3 n^{1/3}); average hops 3 n^{1/3} / 2;
* CLEX propagation competitive ratio: per-level average rounds weighted by
  relative link length m^{(l-L)/3} (lengths grow by m^{1/3} per level);
* hop-delay reduction factor: (3 n^{1/3} / 2) / sum_l avg_rounds_l;
* effective-bandwidth gain: (3 n^{1/3} / 2) / sum_l avg_hops_l with the
  asymmetric per-level bandwidth assignment proportional to per-level hops.
"""

from __future__ import annotations

import dataclasses
import math

from .simulator import SimulationResult
from .topology import CLEXTopology

__all__ = ["DerivedComparison", "derive_comparison", "all_to_all_comparison"]


@dataclasses.dataclass(frozen=True)
class DerivedComparison:
    torus_avg_hops: float
    clex_sum_avg_rounds: float
    clex_sum_avg_hops: float
    propagation_competitive_ratio: float  # vs physically shortest paths (<= ~2.5)
    hop_delay_reduction: float  # vs torus (paper: 7.3 / 9.7 dense, 9.5 / 13.1 light)
    bandwidth_gain: float  # vs torus theoretical optimum (paper: 8.6 / 11.5)
    torus_effective_bandwidth_fraction: float
    clex_effective_bandwidth_fraction: float

    def row(self) -> dict:
        return {
            "propagation_ratio": round(self.propagation_competitive_ratio, 2),
            "hop_delay_reduction": round(self.hop_delay_reduction, 1),
            "bandwidth_gain": round(self.bandwidth_gain, 1),
        }


def derive_comparison(result: SimulationResult) -> DerivedComparison:
    topo: CLEXTopology = result.topo
    k = topo.n ** (1.0 / 3.0)  # equivalent symmetric torus side
    torus_hops = 1.5 * k
    growth = topo.level_length_ratio()  # m^{1/3}: 3.2 for m=32, 4 for m=64

    sum_rounds = result.sum_avg_rounds
    sum_hops = result.sum_avg_hops

    # propagation: rounds on level l ride links of relative length growth^(l-L)
    prop = sum(
        result.levels[l].avg_rounds * growth ** (l - topo.L) for l in sorted(result.levels)
    )

    # bandwidth: assign per-node bandwidth to levels proportionally to the
    # measured per-level hops; each message consumes one unit per hop.
    # Effective per-node bandwidth fraction = B / sum_hops per message vs the
    # torus bound 2B/(3 n^{1/3}).
    clex_fraction = 1.0 / max(sum_hops, 1e-12)
    torus_fraction = 2.0 / (3.0 * k)
    return DerivedComparison(
        torus_avg_hops=torus_hops,
        clex_sum_avg_rounds=sum_rounds,
        clex_sum_avg_hops=sum_hops,
        propagation_competitive_ratio=prop,
        hop_delay_reduction=torus_hops / max(sum_rounds, 1e-12),
        bandwidth_gain=clex_fraction / torus_fraction,
        torus_effective_bandwidth_fraction=torus_fraction,
        clex_effective_bandwidth_fraction=clex_fraction,
    )


def all_to_all_comparison(topo: CLEXTopology, bandwidth: dict | None = None) -> dict:
    """Sec. II-C: all-to-all on CLEX vs torus.

    CLEX: every message traverses at most one edge per level; propagation is
    a geometric series summing to (1+o(1)) of the physical optimum.  Torus:
    dimension-ordered flooding, (k1+k2+k3)/2 hops on average.

    The absolute bounds come from the flooding schedule's perfect balance:
    full all-to-all (one message per ordered pair) puts *exactly* n/m
    messages on every directed clique and bundle edge, so a level that gives
    each of its edges capacity ``bandwidth[level]`` messages/round finishes
    in ceil((n/m)/bandwidth[level]) rounds.  ``bandwidth`` maps phase level
    (1 = clique, 2..L = bundles) to per-edge capacity — the paper's
    *asymmetric* assignment gives cheap short links more capacity.  Default:
    unit capacity everywhere.  ``simulate_all_to_all`` is validated against
    ``rounds_bound`` (within 1.2x on test instances).
    """
    k = topo.n ** (1.0 / 3.0)
    torus_hops = 1.5 * k
    clex_hops = topo.L
    prop_optimum = topo.propagation_optimum()
    clex_prop = topo.all_to_all_propagation()
    per_edge_load = topo.n // topo.m
    bandwidth = bandwidth or {}
    rounds_per_level = {
        level: math.ceil(per_edge_load / max(int(bandwidth.get(level, 1)), 1))
        for level in range(1, topo.L + 1)
    }
    return {
        "clex_max_hops": clex_hops,
        "torus_avg_hops": torus_hops,
        "hop_reduction": torus_hops / clex_hops,
        "clex_propagation_over_optimum": clex_prop / prop_optimum,
        "diameter_bound": topo.diameter_bound,
        "per_edge_load_bound": per_edge_load,
        "rounds_bound_per_level": rounds_per_level,
        "rounds_bound": sum(rounds_per_level.values()),
    }
