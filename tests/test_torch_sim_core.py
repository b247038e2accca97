"""The port's simulator primitives (``repro_torch.core``: the hash RNG, the
topologies, the fault set and the routing primitives) against the JAX
package's numpy ``repro.core`` on the same inputs and the same seeded numpy
Generators, on the CPU: equal bits, equal draws consumed.

Seeds are fixed parameters (no hypothesis draws)."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.routing as R_routing
import repro.core.simulator as R_sim
import repro_torch.core as P
import repro_torch.core.routing as P_routing
import repro_torch.core.simulator as P_sim
from repro.core import hashrng as R_hash
from repro_torch.core import hashrng as P_hash

torch.set_num_threads(2)
CPU = "cpu"


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def same(port, ref) -> bool:
    """A port tensor equals a reference array: values, shape and kind."""
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return port.shape == ref.shape and np.array_equal(port, ref)


def assert_same_result(port, ref):
    """Every field of a port result equals the reference's, walls aside
    (the topology compared by its dataclass fields, the per-level stats
    with ``==`` on every float, the histogram element by element)."""
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name in ("wall_seconds", "audit"):
            continue
        if f.name == "topo":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif f.name == "levels":
            assert sorted(a) == sorted(b)
            for lvl in b:
                assert dataclasses.asdict(a[lvl]) == dataclasses.asdict(b[lvl]), lvl
        elif isinstance(b, np.ndarray):
            assert same(a, b), f.name
        else:
            assert a == b, (f.name, a, b)
    if hasattr(ref, "table"):
        assert port.table() == ref.table()
    if hasattr(ref, "row"):
        assert port.row() == ref.row()


# ------------------------------------------------------------------ hashes
TOP_BIT = np.uint64(1) << np.uint64(63)


@pytest.mark.parametrize("seed", [0, 7])
def test_mix64_bits_equal_numpy_with_top_bits(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**63, size=4096, dtype=np.int64).astype(np.uint64)
    x[::2] |= TOP_BIT
    x[:4] = [0, 1, TOP_BIT, np.uint64(2**64 - 1)]
    got = P_hash.mix64(t(x.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, R_hash.mix64(x))


@pytest.mark.parametrize("parts", [(0,), (1, "r", "edge"), (2**40, "traffic", "uniform", "perm"),
                                   (3, "rb", "gwf", 5)])
def test_salt_for_equals_reference(parts):
    assert P_hash.salt_for(*parts) == int(R_hash.salt_for(*parts))


def _top_bit_salts():
    """Salts whose top bit is set (the signed-word edge of the port)."""
    out = []
    for i in range(64):
        s = R_hash.salt_for(i, "x")
        if int(s) >> 63:
            out.append(s)
    return out[:3]


@pytest.mark.parametrize("salt", _top_bit_salts() + [R_hash.salt_for(5, "low")])
def test_hash_u01_and_randint_bits_equal_numpy(salt):
    g = np.concatenate([np.arange(5000, dtype=np.int64),
                        np.array([2**62, 2**63 - 1, 2**40 + 3], dtype=np.int64)])
    assert same(P_hash.hash_u01(t(g), int(salt)), R_hash.hash_u01(g, salt))
    for bound in (1, 2, 31, 10**6, 2**52):
        assert same(P_hash.hash_randint(t(g), bound, int(salt)),
                    R_hash.hash_randint(g, bound, salt))
    bounds = np.random.default_rng(1).integers(1, 10**9, size=g.size)
    assert same(P_hash.hash_randint(t(g), t(bounds), int(salt)),
                R_hash.hash_randint(g, bounds, salt))


@pytest.mark.parametrize("domain", [1, 2, 3, 17, 1000, 4096, 29360128])
def test_pseudo_permutation_equals_reference(domain):
    salt = _top_bit_salts()[0]
    idx = np.arange(min(domain, 20000), dtype=np.int64)
    got = P_hash.pseudo_permutation(t(idx), domain, int(salt))
    assert same(got, R_hash.pseudo_permutation(idx, domain, salt))
    if domain <= 4096:
        assert sorted(got.tolist()) == list(range(domain))  # a bijection
    if domain > 1:
        with pytest.raises(ValueError, match="indices"):
            P_hash.pseudo_permutation(torch.tensor([domain]), domain, int(salt))


# ---------------------------------------------------------------- topology
def test_digit_arithmetic_on_tensors():
    x = np.arange(0, 4**5, 7, dtype=np.int64)
    for pos in range(5):
        assert same(P.digit(t(x), pos, 4), R.digit(x, pos, 4))
        assert same(P.copy_index(t(x), pos, 4), R.copy_index(x, pos, 4))
        assert same(P.with_digit(t(x), pos, 4, 3), R.with_digit(x, pos, 4, 3))


@pytest.mark.parametrize("m,L", [(2, 1), (3, 3), (4, 2), (8, 2)])
def test_clex_topology_matches_reference(m, L):
    a, b = P.CLEXTopology(m, L), R.CLEXTopology(m, L)
    for name in ("n", "s", "degree", "fat_link_degree", "diameter_bound"):
        assert getattr(a, name) == getattr(b, name)
    assert a.level_length_ratio() == b.level_length_ratio()
    assert a.propagation_optimum() == b.propagation_optimum()
    assert a.all_to_all_propagation() == b.all_to_all_propagation()
    assert same(a.build_out_edges(CPU), b.build_out_edges())
    assert same(a.build_adjacency(CPU), b.build_adjacency())
    with pytest.raises(ValueError):
        P.CLEXTopology(1, 2)


@pytest.mark.parametrize("seed", [0, 3])
def test_faultset_matches_reference(seed):
    topo_p, topo_r = P.CLEXTopology(8, 3), R.CLEXTopology(8, 3)
    fp = P.FaultSet.sample(topo_p, 0.1, 0.05, rng=np.random.default_rng(seed), protect=[0, 5])
    fr = R.FaultSet.sample(topo_r, 0.1, 0.05, rng=np.random.default_rng(seed), protect=[0, 5])
    assert np.array_equal(fp.dead_nodes, fr.dead_nodes)
    assert sorted(fp.dead_edges) == sorted(fr.dead_edges)
    for lvl in fr.dead_edges:
        assert np.array_equal(fp.dead_edges[lvl], fr.dead_edges[lvl])
    assert fp.describe() == fr.describe()
    nodes = np.arange(topo_r.n, dtype=np.int64)
    assert same(fp.node_alive(t(nodes)), fr.node_alive(nodes))
    assert same(fp.live_nodes(CPU), fr.live_nodes())
    for lvl in (2, 3):
        assert same(fp.bundle_targets(t(nodes), lvl), fr.bundle_targets(nodes, lvl))
        assert same(fp.live_edge_mask(t(nodes), lvl), fr.live_edge_mask(nodes, lvl))
        edges = nodes % topo_r.m
        assert same(fp.edge_alive(lvl, t(nodes), t(edges)), fr.edge_alive(lvl, nodes, edges))
    with pytest.raises(ValueError):
        P.FaultSet(topo_p, dead_nodes=[topo_p.n])


def test_torus_topology_matches_reference():
    a, b = P.TorusTopology(4, 5, 6), R.TorusTopology(4, 5, 6)
    assert (a.n, a.degree, a.bisection_edges(), a.all_to_all_avg_hops(),
            a.effective_p2p_bandwidth_fraction()) == (
        b.n, b.degree, b.bisection_edges(), b.all_to_all_avg_hops(),
        b.effective_p2p_bandwidth_fraction())
    x = np.arange(b.n, dtype=np.int64)
    y = x[::-1].copy()
    assert same(a.hop_distance(t(x), t(y)), b.hop_distance(x, y))


# ----------------------------------------------------------------- routing
def test_schedules_equal_reference():
    for m in (2, 4, 32, 64):
        assert P.copy_schedule(m) == R.copy_schedule(m)
    for L in (1, 2, 4):
        assert P.unrolled_schedule(L) == R.unrolled_schedule(L)
    for x in (1, 2, 16, 65536, 1e30):
        assert P.log_star(x) == R.log_star(x)


def _traffic(topo, seed, k=300):
    rng = np.random.default_rng(seed)
    return rng.integers(0, topo.n, size=k), rng.integers(0, topo.n, size=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_gateways_and_bundle_hop_equal_reference(seed):
    tp, tr = P.CLEXTopology(4, 3), R.CLEXTopology(4, 3)
    cur, dest = _traffic(tr, seed)
    rp, rr = np.random.default_rng(seed), np.random.default_rng(seed)
    for level in (2, 3):
        assert same(P.sample_gateways(tp, t(cur), t(dest), level, rp),
                    R.sample_gateways(tr, cur, dest, level, rr))
        audit_p, audit_r = [], []
        new_p, rounds_p = P.bundle_hop(tp, t(cur), t(dest), level, rp, audit=audit_p)
        new_r, rounds_r = R.bundle_hop(tr, cur, dest, level, rr, audit=audit_r)
        assert same(new_p, new_r) and same(rounds_p, rounds_r)
        for key in ("node", "edge", "round", "target"):
            assert same(audit_p[0][key], audit_r[0][key])
    # same draws consumed, in the same order
    assert rp.random() == rr.random()


@pytest.mark.parametrize("seed,rate", [(2, 0.2), (5, 0.6), (2, 0.7)])
def test_faulty_routing_primitives_equal_reference(seed, rate):
    """At rates 0.6 and 0.7 some messages outlast the rejection draws: the
    exhaustive pass draws their gateways, and some stay stuck."""
    tp, tr = P.CLEXTopology(8, 3), R.CLEXTopology(8, 3)
    fp = P.FaultSet.sample(tp, rate, rate, rng=np.random.default_rng(seed))
    fr = R.FaultSet.sample(tr, rate, rate, rng=np.random.default_rng(seed))
    rp, rr = np.random.default_rng(seed), np.random.default_rng(seed)
    cur = fr.live_nodes()[np.random.default_rng(seed).integers(0, fr.live_nodes().size, 200)]
    tgt = np.random.default_rng(seed + 1).integers(0, tr.m, size=200)
    gw_p, stuck_p = P.sample_gateways_faulty(tp, t(cur), t(tgt), 3, rp, fp)
    gw_r, stuck_r = R.sample_gateways_faulty(tr, cur, tgt, 3, rr, fr)
    assert same(gw_p, gw_r) and same(stuck_p, stuck_r)
    assert stuck_r.any() == (rate > 0.5)
    ok = ~stuck_r
    new_p, rounds_p = P.bundle_hop(tp, t(gw_r[ok]), t(tgt[ok] * tr.m**2), 3, rp, faults=fp)
    new_r, rounds_r = R.bundle_hop(tr, gw_r[ok], tgt[ok] * tr.m**2, 3, rr, faults=fr)
    assert same(new_p, new_r) and same(rounds_p, rounds_r)
    mid_p = P.valiant_intermediate(tp, t(cur), rp, within_level=2, faults=fp)
    mid_r = R.valiant_intermediate(tr, cur, rr, within_level=2, faults=fr)
    assert same(mid_p, mid_r)
    assert rp.random() == rr.random()


def test_bundle_with_no_live_edge_raises_as_reference():
    tp, tr = P.CLEXTopology(4, 2), R.CLEXTopology(4, 2)
    dead = {2: [0, 1, 2, 3]}
    cur, dest = np.array([0]), np.array([8])
    with pytest.raises(R.UnroutableError) as ref:
        R.bundle_hop(tr, cur, dest, 2, np.random.default_rng(0), faults=R.FaultSet(tr, [], dead))
    with pytest.raises(P.UnroutableError) as port:
        P.bundle_hop(tp, t(cur), t(dest), 2, np.random.default_rng(0),
                     faults=P.FaultSet(tp, [], dead))
    assert str(port.value) == str(ref.value)


def test_bundle_rounds_from_counts_equals_reference():
    c = np.random.default_rng(0).integers(0, 100, size=500)
    q = np.random.default_rng(1).integers(1, 33, size=500)
    assert P.routing.bundle_rounds_from_counts(t(c), t(q)) == \
        R_routing.bundle_rounds_from_counts(c, q)
    assert P.routing.bundle_rounds_from_counts(t(c), 32) == \
        R_routing.bundle_rounds_from_counts(c, 32)
    assert P.routing.bundle_rounds_from_counts(torch.zeros(0, dtype=torch.int64), 4) == (0, 0)


@pytest.mark.parametrize("m,L", [(4, 2), (4, 3), (3, 4)])
def test_flood_route_and_edge_keys_equal_reference(m, L):
    tp, tr = P.CLEXTopology(m, L), R.CLEXTopology(m, L)
    src, dst = _traffic(tr, 0, 1000)
    pos_p, pos_r = P.flood_route(tp, t(src), t(dst)), R.flood_route(tr, src, dst)
    assert same(pos_p, pos_r)
    for level in range(1, L + 1):
        assert same(P.flood_edge_keys(tp, pos_p, t(dst), level),
                    R.flood_edge_keys(tr, pos_r, dst, level))
    assert P.all_to_all_tree_hops(tp) == R.all_to_all_tree_hops(tr)


@pytest.mark.parametrize("seed", [0, 4])
def test_group_draws_equal_reference(seed):
    keys = np.random.default_rng(seed).integers(0, 13, size=400)
    rp, rr = np.random.default_rng(seed), np.random.default_rng(seed)
    assert same(P_sim._group_first(t(keys), rp), R_sim._group_first(keys, rr))
    assert same(P_sim._ranks_within(t(keys), rp), R_sim._ranks_within(keys, rr))
    ranks_p, order_p = P_routing._per_key_ranks(t(keys), rp)
    ranks_r, order_r = R_routing._per_key_ranks(keys, rr)
    assert same(ranks_p, ranks_r) and same(order_p, order_r)
