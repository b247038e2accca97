"""The port's scenario layer (``repro_torch.core``: traffic generators,
scenario runs, ``scenario_matrix``, ``fault_degradation_curve``, the
all-to-all engines, the derived comparisons and the paper's settings)
against the JAX package's numpy ``repro.core`` on the CPU, field for field.

Seeds are fixed parameters (no hypothesis draws)."""

import dataclasses

import numpy as np
import pytest
from test_torch_sim_core import assert_same_result, same

import repro.configs.clex_paper as R_paper
import repro.core as R
import repro.core.scenarios as R_sc
import repro_torch.configs.clex_paper as P_paper
import repro_torch.core as P
import repro_torch.core.scenarios as P_sc
from repro_torch.obs import Obs, get_obs, set_obs

CPU = "cpu"
TOPOS = [((4, 3), None), ((8, 2), None), (None, (4, 4, 4)), (None, (3, 4, 5))]


def _topos(clex, torus):
    if clex:
        return P.CLEXTopology(*clex), R.CLEXTopology(*clex)
    return P.TorusTopology(*torus), R.TorusTopology(*torus)


@pytest.mark.parametrize("name", sorted(R.SCENARIOS))
@pytest.mark.parametrize("topos", TOPOS, ids=["clex43", "clex82", "torus4", "torus345"])
def test_traffic_equals_reference(name, topos):
    tp, tr = _topos(*topos)
    for seed in (0, np.random.default_rng(5)):
        src, dst = P.make_traffic(tp, name, 3, seed if isinstance(seed, int)
                                  else np.random.default_rng(5), device=CPU)
        ref_src, ref_dst = R.make_traffic(tr, name, 3, seed)
        assert same(src, ref_src) and same(dst, ref_dst)
    pieces = list(P.iter_traffic(tp, name, 3, 7, chunk_size=37, device=CPU))
    ref = list(R.iter_traffic(tr, name, 3, 7, chunk_size=37))
    assert [p[0] for p in pieces] == [r[0] for r in ref]
    for (_, s, d), (_, rs, rd) in zip(pieces, ref):
        assert same(s, rs) and same(d, rd)
    assert P.SCENARIOS[name].valiant_level == R.SCENARIOS[name].valiant_level


@pytest.mark.parametrize("engine", ["golden", "streaming"])
@pytest.mark.parametrize("name,valiant", [("hotspot", "auto"), ("transpose", False),
                                          ("same_copy", 2), ("bursty", True)])
def test_clex_scenario_equals_reference(engine, name, valiant):
    tp, tr = P.CLEXTopology(4, 3), R.CLEXTopology(4, 3)
    assert_same_result(
        P.run_clex_scenario(tp, name, 2, "light", 3, valiant=valiant, engine=engine, device=CPU),
        R.run_clex_scenario(tr, name, 2, "light", 3, valiant=valiant, engine=engine))


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("engine", ["golden", "streaming"])
def test_scenario_matrix_equals_reference(engine, faulty):
    cp, cr = P.CLEXTopology(4, 2), R.CLEXTopology(4, 2)
    fp = fr = None
    if faulty:
        fp = P.FaultSet.sample(cp, node_rate=0.1, rng=np.random.default_rng(1))
        fr = R.FaultSet.sample(cr, node_rate=0.1, rng=np.random.default_rng(1))
    rows = P.scenario_matrix(cp, P.TorusTopology.cube(4), msgs_per_node=2, seed=0,
                             faults=fp, engine=engine, device=CPU)
    ref = R.scenario_matrix(cr, R.TorusTopology.cube(4), msgs_per_node=2, seed=0,
                            faults=fr, engine=engine)
    assert rows == ref and len(rows) == len(R.SCENARIOS)


@pytest.mark.parametrize("engine", ["golden", "streaming"])
def test_fault_degradation_curve_equals_reference(engine):
    kw = dict(rates=(0.0, 0.05, 0.1), msgs_per_node=2, seed=0, engine=engine)
    rows = P.fault_degradation_curve(P.CLEXTopology(4, 3), device=CPU, **kw)
    assert rows == R.fault_degradation_curve(R.CLEXTopology(4, 3), **kw)
    assert rows[-1]["detours"] > 0


@pytest.mark.parametrize("engine", ["golden", "streaming"])
def test_torus_scenario_equals_reference(engine):
    assert_same_result(
        P.run_torus_scenario(P.TorusTopology.cube(4), "hotspot", 2, 1, engine=engine, device=CPU),
        R.run_torus_scenario(R.TorusTopology.cube(4), "hotspot", 2, 1, engine=engine))


# -------------------------------------------------------------- all-to-all
@pytest.mark.parametrize("m,L", [(4, 2), (8, 2), (4, 3)])
def test_all_to_all_engines_equal_reference(m, L):
    tp, tr = P.CLEXTopology(m, L), R.CLEXTopology(m, L)
    bw = P_sc.asymmetric_bandwidth(tp)
    assert bw == R_sc.asymmetric_bandwidth(tr)
    for engine in ("golden", "streaming"):
        port = P.simulate_all_to_all(tp, bandwidth=bw, engine=engine, device=CPU)
        assert_same_result(port, R.simulate_all_to_all(tr, bandwidth=bw, engine=engine))
    # the closed form, forced by a pair budget of 1, is bit-identical
    closed = P.StreamingEngine(device=CPU).run_all_to_all(tp, bandwidth=bw, max_pairs=1)
    assert_same_result(closed, R.StreamingEngine().run_all_to_all(tr, bandwidth=bw, max_pairs=1))
    assert closed.method == "closed_form" and closed.avg_hops == port.avg_hops
    for chunk in (1, 7):
        res = P.StreamingEngine(chunk_size=chunk, device=CPU).run_all_to_all(tp, bandwidth=bw)
        assert_same_result(res, port)


@pytest.mark.parametrize("engine", ["golden", "streaming"])
def test_all_to_all_under_faults_equals_reference(engine):
    tp, tr = P.CLEXTopology(4, 3), R.CLEXTopology(4, 3)
    fp = P.FaultSet.sample(tp, 0.05, 0.05, rng=np.random.default_rng(3))
    fr = R.FaultSet.sample(tr, 0.05, 0.05, rng=np.random.default_rng(3))
    port = P.simulate_all_to_all(tp, faults=fp, seed=3, engine=engine, device=CPU)
    assert_same_result(port, R.simulate_all_to_all(tr, faults=fr, seed=3, engine=engine))
    assert port.n_patched > 0 and port.uniform_load is None
    with pytest.raises(ValueError, match="fault"):
        P.StreamingEngine(device=CPU).run_all_to_all(tp, faults=fp, max_pairs=1)


# ---------------------------------------------------- analysis and settings
def test_derived_comparisons_equal_reference():
    tp, tr = P.CLEXTopology(8, 3), R.CLEXTopology(8, 3)
    port = P.simulate_point_to_point_streaming(tp, 4, seed=2, device=CPU)
    ref = R.simulate_point_to_point_streaming(tr, 4, seed=2)
    assert dataclasses.asdict(P.derive_comparison(port)) == \
        dataclasses.asdict(R.derive_comparison(ref))
    assert P.derive_comparison(port).row() == R.derive_comparison(ref).row()
    assert P.all_to_all_comparison(tp, {1: 3}) == R.all_to_all_comparison(tr, {1: 3})


def test_paper_settings_equal_reference():
    assert {k: (v.m, v.L) for k, v in P_paper.PAPER_TOPOLOGIES.items()} == \
        {k: (v.m, v.L) for k, v in R_paper.PAPER_TOPOLOGIES.items()}
    assert all(isinstance(v, P.CLEXTopology) for v in P_paper.PAPER_TOPOLOGIES.values())
    assert P_paper.PAPER_TRAFFIC == R_paper.PAPER_TRAFFIC
    assert P_paper.PAPER_TABLES == R_paper.PAPER_TABLES
    assert P_paper.PAPER_DERIVED == R_paper.PAPER_DERIVED


def test_obs_hooks_trace_the_streaming_run():
    """The streaming engine's chunk instants and gauges and the matrix's
    scenario spans go through the port's obs copy."""
    prev = get_obs()
    ob = Obs()
    set_obs(ob)
    try:
        P.simulate_point_to_point_streaming(P.CLEXTopology(4, 2), 2, chunk_size=8, device=CPU)
        P.scenario_matrix(P.CLEXTopology(4, 2), P.TorusTopology.cube(3), 1,
                          scenarios=["uniform"], engine="streaming", device=CPU)
    finally:
        set_obs(prev)
    names = [e["name"] for e in ob.tracer.events]
    assert names.count("sim_chunk") == 4 + 1 and "scenario" in names  # 32 / 8, then 16 in one
    assert ob.registry.gauge("sim.stream.msgs_per_s").value > 0
