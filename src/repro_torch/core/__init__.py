"""CLEX core of the port: topology, routing, the golden and streaming
simulators on tensors, the scenario engine, fault injection and analysis
(the JAX package's ``core`` names), and the cost model the serving
scheduler prices admission with."""

from .analysis import DerivedComparison, all_to_all_comparison, derive_comparison
from .cost_model import CollectiveCostModel
from .hashrng import hash_randint, hash_u01, pseudo_permutation
from .routing import (
    UnroutableError,
    all_to_all_tree_hops,
    bundle_hop,
    copy_schedule,
    flood_edge_keys,
    flood_route,
    log_star,
    sample_gateways,
    sample_gateways_faulty,
    unrolled_schedule,
    valiant_intermediate,
)
from .scenarios import (
    SCENARIOS,
    AllToAllResult,
    TrafficScenario,
    fault_degradation_curve,
    iter_traffic,
    make_traffic,
    run_clex_scenario,
    run_torus_scenario,
    scenario_matrix,
    simulate_all_to_all,
)
from .sim_engine import GoldenEngine, SimEngine, StreamingEngine, get_engine
from .simulator import (
    ClexMachine,
    LevelStats,
    SimulationResult,
    simulate_point_to_point,
    uniform_permutation_traffic,
)
from .streaming import simulate_all_to_all_streaming, simulate_point_to_point_streaming
from .torus_sim import (
    TorusSimResult,
    TorusStreamResult,
    simulate_torus_dor,
    simulate_torus_dor_streaming,
)
from .topology import CLEXTopology, FaultSet, TorusTopology, copy_index, digit, with_digit

__all__ = [
    "AllToAllResult",
    "CLEXTopology",
    "ClexMachine",
    "CollectiveCostModel",
    "DerivedComparison",
    "FaultSet",
    "GoldenEngine",
    "LevelStats",
    "SCENARIOS",
    "SimEngine",
    "SimulationResult",
    "StreamingEngine",
    "TorusSimResult",
    "TorusStreamResult",
    "TorusTopology",
    "TrafficScenario",
    "UnroutableError",
    "all_to_all_comparison",
    "all_to_all_tree_hops",
    "bundle_hop",
    "copy_index",
    "copy_schedule",
    "derive_comparison",
    "digit",
    "fault_degradation_curve",
    "flood_edge_keys",
    "flood_route",
    "get_engine",
    "hash_randint",
    "hash_u01",
    "iter_traffic",
    "log_star",
    "make_traffic",
    "pseudo_permutation",
    "run_clex_scenario",
    "run_torus_scenario",
    "sample_gateways",
    "sample_gateways_faulty",
    "scenario_matrix",
    "simulate_all_to_all",
    "simulate_all_to_all_streaming",
    "simulate_point_to_point",
    "simulate_point_to_point_streaming",
    "simulate_torus_dor",
    "simulate_torus_dor_streaming",
    "uniform_permutation_traffic",
    "unrolled_schedule",
    "valiant_intermediate",
    "with_digit",
]
