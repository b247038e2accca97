"""The port's two simulator engines (``repro_torch.core``: the golden
per-message machine and the paper-scale streaming machine, both on tensors)
against the JAX package's numpy engines on the CPU: every field of every
result equal with ``==``, walls aside; the frozen tables of
``tests/test_golden_tables.py``; chunk-size invariance; the engine seam's
contract as ``tests/test_engines.py`` states it; and the reference's
``UnroutableError`` reproduced where the reference raises it.

Seeds are fixed parameters (no hypothesis draws)."""

import numpy as np
import pytest
import torch
from test_golden_tables import GOLDEN, GOLDEN_STREAMING
from test_torch_sim_core import assert_same_result, same, t

import repro.core as R
import repro_torch.core as P

CPU = "cpu"
KEY_IDS = lambda k: f"m{k[0]}L{k[1]}{k[2]}s{k[3]}"  # noqa: E731


def _faults(M, topo, seed, node_rate, edge_rate):
    return M.FaultSet.sample(topo, node_rate=node_rate, edge_rate=edge_rate,
                             rng=np.random.default_rng(seed))


def _pair(run, m, L, *args, faults=None, **kw):
    """Run ``run`` (a function name of both packages) on the port (CPU) and
    on the reference with the same arguments; faults sampled alike."""
    tp, tr = P.CLEXTopology(m, L), R.CLEXTopology(m, L)
    fp = fr = None
    if faults is not None:
        fp, fr = _faults(P, tp, *faults), _faults(R, tr, *faults)
    port = getattr(P, run)(tp, *args, faults=fp, device=CPU, **kw)
    ref = getattr(R, run)(tr, *args, faults=fr, **kw)
    assert_same_result(port, ref)
    return port, ref


# ------------------------------------------------------------ frozen tables
@pytest.mark.parametrize("key", sorted(GOLDEN), ids=KEY_IDS)
def test_golden_tables(key):
    m, L, mode, seed, msgs = key
    port, _ = _pair("simulate_point_to_point", m, L, msgs, mode=mode, seed=seed)
    assert port.table() == GOLDEN[key]


@pytest.mark.parametrize("key", sorted(GOLDEN_STREAMING), ids=KEY_IDS)
def test_streaming_tables(key):
    m, L, mode, seed, msgs = key
    port, _ = _pair("simulate_point_to_point_streaming", m, L, msgs, mode=mode, seed=seed)
    assert port.table() == GOLDEN_STREAMING[key]
    assert port.engine == "streaming"


# ------------------------------------------------- both engines, every field
ENGINES = ("simulate_point_to_point", "simulate_point_to_point_streaming")
CASES = [  # m, L, msgs, mode, seed, faults (seed, node rate, edge rate), valiant level
    (8, 3, 2, "dense", 11, None, None),
    (8, 3, 2, "light", 12, None, None),
    (4, 4, 3, "dense", 13, None, None),
    (8, 3, 2, "dense", 14, (14, 0.08, 0.04), None),
    (8, 3, 2, "light", 15, (15, 0.08, 0.04), None),
    (8, 2, 3, "dense", 16, (16, 0.2, 0.1), None),
    (4, 3, 2, "light", 17, None, 3),
    (4, 3, 2, "dense", 18, (18, 0.05, 0.05), 3),
    (8, 3, 2, "light", 19, None, 2),
]


@pytest.mark.parametrize("run", ENGINES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"m{c[0]}L{c[1]}{c[3]}s{c[4]}"
                         + ("f" if c[5] else "") + (f"v{c[6]}" if c[6] else ""))
def test_engine_equals_reference(run, case):
    m, L, msgs, mode, seed, faults, valiant = case
    port, ref = _pair(run, m, L, msgs, mode=mode, seed=seed, faults=faults,
                      valiant_level=valiant)
    if faults is not None:
        assert port.n_dropped_dead > 0


def test_golden_audit_equals_reference():
    """The traversal trace of a faulted run: every bundle crossing and
    every relay, element for element."""
    port, ref = _pair("simulate_point_to_point", 8, 2, 2, mode="dense", seed=3,
                      faults=(3, 0.1, 0.1), audit=True)
    assert len(port.audit["bundle"]) == len(ref.audit["bundle"]) > 0
    for a, b in zip(port.audit["bundle"], ref.audit["bundle"]):
        assert a["level"] == b["level"]
        for key in ("node", "edge", "round", "target"):
            assert same(a[key], b[key])
    assert len(port.audit["relay"]) == len(ref.audit["relay"]) > 0
    for a, b in zip(port.audit["relay"] + port.audit["positions"],
                    ref.audit["relay"] + ref.audit["positions"]):
        assert same(a, b)


@pytest.mark.parametrize("run", ENGINES)
@pytest.mark.parametrize("mode", ["dense", "light"])
def test_unroutable_seed_raises_as_reference(run, mode):
    """Seed 163 of ``tests/test_faults.py::test_synchronous_schedule_is_
    deadlock_free`` makes the reference's golden engine raise; the port
    raises the same error with the same message in both modes, and its
    streaming engine agrees with the reference's streaming engine."""
    seed = 163
    tp, tr = P.CLEXTopology(4, 3), R.CLEXTopology(4, 3)
    fp, fr = _faults(P, tp, seed, 0.08, 0.08), _faults(R, tr, seed, 0.08, 0.08)
    kw = {"audit": True} if run == "simulate_point_to_point" else {}
    try:
        ref = getattr(R, run)(tr, 2, mode=mode, seed=seed, faults=fr, **kw)
    except R.UnroutableError as err:
        with pytest.raises(P.UnroutableError) as port:
            getattr(P, run)(tp, 2, mode=mode, seed=seed, faults=fp, device=CPU, **kw)
        assert str(port.value) == str(err)
        assert str(err) == "level-2 crossings did not converge in 16 detour iterations"
    else:
        assert run != "simulate_point_to_point"
        assert_same_result(getattr(P, run)(tp, 2, mode=mode, seed=seed, faults=fp,
                                           device=CPU, **kw), ref)


def test_unroutable_disconnected_clique_raises_as_reference():
    tp, tr = P.CLEXTopology(2, 2), R.CLEXTopology(2, 2)
    kw = dict(dead_nodes=[1], dead_edges={2: [0, 1]})
    src, dst = np.array([0]), np.array([2])
    with pytest.raises(R.UnroutableError) as ref:
        R.simulate_point_to_point(tr, 1, seed=0, src=src, dst=dst, faults=R.FaultSet(tr, **kw))
    with pytest.raises(P.UnroutableError) as port:
        P.simulate_point_to_point(tp, 1, seed=0, src=src, dst=dst, faults=P.FaultSet(tp, **kw),
                                  device=CPU)
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------ chunk-size invariance
@pytest.mark.parametrize("faults", [None, (3, 0.1, 0.05)], ids=["clean", "faulted"])
@pytest.mark.parametrize("mode", ["dense", "light"])
def test_streaming_chunk_size_invariance(faults, mode):
    tp = P.CLEXTopology(8, 2)
    fp = _faults(P, tp, *faults) if faults else None
    runs = [P.simulate_point_to_point_streaming(tp, 3, mode=mode, seed=5, faults=fp,
                                                chunk_size=c, device=CPU)
            for c in (7, 37, 10**6)]
    ref = R.simulate_point_to_point_streaming(
        R.CLEXTopology(8, 2), 3, mode=mode, seed=5, chunk_size=64,
        faults=_faults(R, R.CLEXTopology(8, 2), *faults) if faults else None)
    for r in runs:
        r.chunk_size = ref.chunk_size
        assert_same_result(r, ref)


def test_streaming_traffic_stream_equals_arrays():
    """A ``(start, src, dst)`` chunk stream gives the array form's result."""
    tp = P.CLEXTopology(4, 3)
    src, dst = P.uniform_permutation_traffic(tp, 2, np.random.default_rng(0), device=CPU)
    whole = P.simulate_point_to_point_streaming(tp, 2, src=src, dst=dst, chunk_size=50,
                                                device=CPU)
    pieces = [(s, src[s:s + 13], dst[s:s + 13]) for s in range(0, src.shape[0], 13)]
    streamed = P.simulate_point_to_point_streaming(tp, 2, traffic=pieces, chunk_size=50,
                                                   device=CPU)
    assert_same_result(streamed, whole)


# ------------------------------------------ golden vs streaming (engine seam)
@pytest.mark.parametrize("seed,mode,faulty", [(0, "dense", False), (1, "light", True),
                                              (2, "dense", True), (3, "light", False)])
def test_engines_agree_as_the_reference_requires(seed, mode, faulty):
    """The contract of ``tests/test_engines.py``, held on the port: equal
    message accounting, exact fault-free hop totals and loads at levels
    >= 2, and randomized aggregates within that file's tolerances."""
    topo = P.CLEXTopology(8, 3)
    faults = _faults(P, topo, seed, 0.08, 0.04) if faulty else None
    g = P.simulate_point_to_point(topo, 2, mode=mode, seed=seed, faults=faults, device=CPU)
    s = P.simulate_point_to_point_streaming(topo, 2, mode=mode, seed=seed, faults=faults,
                                            chunk_size=97, device=CPU)
    assert g.n_messages == s.n_messages and g.n_dropped_dead == s.n_dropped_dead
    assert g.delivered_fraction == s.delivered_fraction == 1.0
    if not faulty:
        for lvl in range(2, topo.L + 1):
            assert g.levels[lvl].hops_total == s.levels[lvl].hops_total
            assert g.levels[lvl].row()["max_avg_load"] == s.levels[lvl].row()["max_avg_load"]
    assert s.sum_avg_rounds == pytest.approx(g.sum_avg_rounds, rel=0.35)
    assert s.sum_avg_hops == pytest.approx(g.sum_avg_hops, rel=0.30)


def test_engine_registry():
    assert P.get_engine("golden").name == "golden"
    assert P.get_engine("streaming", CPU).device == CPU
    eng = P.StreamingEngine(chunk_size=123, device=CPU)
    assert P.get_engine(eng) is eng
    with pytest.raises(ValueError, match="golden"):
        P.get_engine("warp-speed")
    with pytest.raises(ValueError):
        P.StreamingEngine(chunk_size=0)
    with pytest.raises(ValueError, match="audit"):
        P.simulate_point_to_point_streaming(P.CLEXTopology(4, 2), 1, audit=True, device=CPU)


@pytest.mark.parametrize("engine", ["golden", "streaming"])
def test_all_dead_faultset_as_reference(engine):
    tp, tr = P.CLEXTopology(4, 2), R.CLEXTopology(4, 2)
    port = P.get_engine(engine, CPU).run_clex(
        tp, 2, seed=0, faults=P.FaultSet(tp, dead_nodes=np.arange(tp.n)))
    ref = R.get_engine(engine).run_clex(tr, 2, seed=0,
                                        faults=R.FaultSet(tr, dead_nodes=np.arange(tr.n)))
    assert_same_result(port, ref)
    assert port.n_messages == 0 and port.delivered_fraction == 1.0


# -------------------------------------------------------------------- torus
@pytest.mark.parametrize("k,msgs,seed", [(4, 3, 0), (6, 2, 4), (5, 1, 9)])
def test_torus_engines_equal_reference(k, msgs, seed):
    tp, tr = P.TorusTopology.cube(k), R.TorusTopology.cube(k)
    assert_same_result(P.simulate_torus_dor(tp, msgs, seed=seed, device=CPU),
                       R.simulate_torus_dor(tr, msgs, seed=seed))
    s = P.simulate_torus_dor_streaming(tp, msgs, seed=seed, chunk_size=53, device=CPU)
    assert_same_result(s, R.simulate_torus_dor_streaming(tr, msgs, seed=seed, chunk_size=53))
    assert_same_result(P.simulate_torus_dor_streaming(tp, msgs, seed=seed, chunk_size=10**6,
                                                      device=CPU), s)


def test_torus_on_given_traffic_equals_reference():
    tp, tr = P.TorusTopology(3, 4, 5), R.TorusTopology(3, 4, 5)
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, tr.n, 200), rng.integers(0, tr.n, 200)
    assert_same_result(P.simulate_torus_dor(tp, 0, seed=1, src=t(src), dst=t(dst), device=CPU),
                       R.simulate_torus_dor(tr, 0, seed=1, src=src, dst=dst))
    assert_same_result(
        P.simulate_torus_dor_streaming(tp, 0, src=t(src), dst=t(dst), device=CPU),
        R.simulate_torus_dor_streaming(tr, 0, src=src, dst=dst))


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = P.CLEXTopology(4, 2)
    for call in (lambda: P.simulate_point_to_point(topo, 1),
                 lambda: P.simulate_point_to_point_streaming(topo, 1),
                 lambda: P.simulate_all_to_all_streaming(topo),
                 lambda: P.simulate_torus_dor(P.TorusTopology.cube(3), 1),
                 lambda: P.simulate_torus_dor_streaming(P.TorusTopology.cube(3), 1),
                 lambda: P.get_engine("streaming").run_clex(topo, 1),
                 lambda: P.simulate_point_to_point(topo, 1, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert P.simulate_point_to_point(topo, 1, device=CPU).n_messages == topo.n
