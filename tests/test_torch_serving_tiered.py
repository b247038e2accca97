"""The port's tiered KV pool and multi-turn sessions against the JAX
package's (``tests/test_serving_tiered.py`` pins the reference): the tier
cost hooks, the wakeup-first scheduler, session resume with no prefill, the
cold resume of a dropped session, the guard rails, LRU spill, refill and
drop, the ledger checks, and the batched wire format.

Against JAX: greedy fp32 token streams and ledgers (each session's tier,
the pool's counters, ``modeled_tier_s``, row bytes) of the two engines on
``REDUCED`` internlm2 (2 layers) on the same weights, and the port's rows
mapped through ``bridge.to_jax_caches`` against the reference's rows of the
same slots (fp32, 2e-5).  Within the port: sampled resumed streams against
a never-demoted run of the port (the two frameworks sample differently),
and the hybrid's (``REDUCED`` jamba) SSM state, conv and attention rows
through the hierarchy, bit for bit."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core.collectives import CollectiveCostModel as JaxCostModel
from repro.models import build_model as jax_build_model
from repro.runtime import serving as jax_serving
from repro_torch.bridge import from_jax_params, to_jax_caches
from repro_torch.configs.base import get_config
from repro_torch.core import CollectiveCostModel
from repro_torch.models import build_model
from repro_torch.runtime.serving import (
    ContinuousBatchingEngine,
    KVPool,
    Request,
    Scheduler,
    SchedulerConfig,
    SessionRecord,
    TierConfig,
    TieredKVPool,
)

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)

FP32_TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model, JAX params, port model, port params): REDUCED internlm2,
    2 layers, fp32, the same weights.  Cached: no test modifies them."""
    over = dict(compute_dtype="float32", remat=False, n_layers=2)
    cfg_j = dataclasses.replace(jax_get_config("internlm2-1.8b", reduced=True), **over)
    cfg_t = dataclasses.replace(get_config("internlm2-1.8b", reduced=True), **over)
    mj = jax_build_model(cfg_j)
    pj = mj.init(jax.random.PRNGKey(0))
    mt = build_model(cfg_t, device="cpu")
    return mj, pj, mt, mt.load(from_jax_params(cfg_t, jax.tree.map(np.asarray, pj)))


@pytest.fixture(scope="module")
def tiny():
    return _pair()[2:]


def _engine(model, params, n_slots=2, max_len=48, seed=0,
            tiers=TierConfig(host_sessions=4, pooled_sessions=4), audit=False):
    return ContinuousBatchingEngine(model, params, n_slots=n_slots, max_len=max_len, seed=seed,
                                    tiers=tiers, audit=audit)


def _prompt(vocab, seed, n=6):
    return np.random.default_rng(seed).integers(1, vocab, (n,)).astype(np.int32)


# ------------------------------------------------------------ cost hooks
def test_tier_transfer_cost_hooks():
    cm, ref = CollectiveCostModel(), JaxCostModel()
    mb = float(1 << 20)
    for nbytes in (0.0, mb, 3.5 * mb):
        for src in ("hbm", "host", "pooled"):
            for dst in ("hbm", "host", "pooled"):
                assert cm.tier_transfer_cost(nbytes, src, dst) == \
                    ref.tier_transfer_cost(nbytes, src, dst)
        for tier in ("host", "pooled"):
            assert cm.wakeup_cost(nbytes, tier) == ref.wakeup_cost(nbytes, tier)
    to_host = cm.tier_transfer_cost(mb, "hbm", "host")
    to_pooled = cm.tier_transfer_cost(mb, "host", "pooled")
    assert to_host > 0 and to_pooled > to_host  # the far tier is the slow hop
    assert cm.tier_transfer_cost(mb, "hbm", "pooled") == pytest.approx(to_host + to_pooled)
    assert cm.tier_transfer_cost(mb, "host", "hbm") == pytest.approx(to_host)
    assert cm.tier_transfer_cost(mb, "host", "host") == 0.0
    assert cm.tier_transfer_cost(0.0, "hbm", "host") == cm.hbm_host_latency
    with pytest.raises(ValueError, match="unknown tier"):
        cm.tier_transfer_cost(mb, "hbm", "disk")
    assert cm.wakeup_cost(mb, "host") < cm.wakeup_cost(mb, "pooled")
    assert cm.wakeup_cost(mb, "host") < cm.cold_prefill_cost(64)
    assert cm.cold_prefill_cost(8) < cm.wakeup_cost(float(8 << 20), "pooled")


def test_scheduler_prefers_waking_resident_session():
    """The port's picks equal the reference scheduler's on the same
    candidates: a host wakeup beats a cold prefill, arrival order holds when
    nothing can be woken, a big pooled row loses to a short prompt."""
    def req(cls, rid, plen, tier=None, nbytes=0):
        r = cls(rid=rid, prompt=np.ones((plen,), np.int32), max_new_tokens=4)
        r.resume_tier, r.resume_bytes = tier, nbytes
        return r

    rounds = [
        ([(0, 64), (1, 64, "host", 1 << 20)], 1, [1]),
        ([(0, 64), (1, 8)], 2, [0, 1]),
        ([(3, 64, "pooled", 8 << 20), (2, 8)], 1, [2]),
        ([(0, 16), (1, 64, "pooled", 1 << 20), (2, 64, "host", 1 << 20), (3, 4)], 3, [3, 2, 0]),
    ]
    port = Scheduler(SchedulerConfig(policy="cost_aware"), CollectiveCostModel())
    ref = jax_serving.Scheduler(jax_serving.SchedulerConfig(policy="cost_aware"), JaxCostModel())
    for cands, n_free, want in rounds:
        got = [r.rid for r in port.select([req(Request, *c) for c in cands], n_free)]
        ref_got = [r.rid for r in ref.select([req(jax_serving.Request, *c) for c in cands],
                                            n_free)]
        assert got == ref_got == want
        for c in cands:
            assert port.admission_cost(req(Request, *c)) == \
                ref.admission_cost(req(jax_serving.Request, *c))


# ------------------------------------------------- the port against the JAX engine
def _two_turns(engine, vocab, n_sessions=5):
    """Two turns of ``n_sessions`` sessions on ``engine``: every first turn
    submitted together and run, then every history resumed together.
    Returns (each session's two streams, the ledger after each turn)."""
    lens, g1, g2 = [5, 9, 4, 7, 6], [3, 4, 2, 5, 3], [3, 2, 4, 2, 3]
    prompts = [_prompt(vocab, 40 + i, lens[i]) for i in range(n_sessions)]
    rids = [engine.submit(prompts[i], g1[i], session_id=i) for i in range(n_sessions)]
    out = engine.run()
    first = [out[r] for r in rids]
    ledgers = [_ledger(engine, n_sessions)]
    rids = [engine.submit(np.concatenate([prompts[i], first[i]]), g2[i], session_id=i)
            for i in range(n_sessions)]
    out = engine.run()
    ledgers.append(_ledger(engine, n_sessions))
    return [(first[i], out[r]) for i, r in enumerate(rids)], ledgers


def _ledger(engine, n_sessions):
    pool, m = engine.pool, engine.metrics
    pool.check()
    return {
        "tiers": [pool.session_tier(s) for s in range(n_sessions)],
        "host": list(pool.host), "pooled": list(pool.pooled), "dropped": sorted(pool.dropped),
        "counts": (pool.n_demote, pool.n_promote, pool.n_spill, pool.n_refill, pool.n_drop,
                   m.wakeups, m.cold_resumes, m.demotions, m.prefills, m.decode_steps),
        "nbytes": sorted({rec.nbytes for rec in list(pool.host.values())
                          + list(pool.pooled.values())}),
        "modeled_tier_s": pool.modeled_tier_s,
    }


@pytest.mark.parametrize("host,pooled", [(8, 8), (2, 2), (0, 0)],
                         ids=["host", "spill", "dropped"])
def test_tiered_engine_matches_reference_greedy(host, pooled):
    """Greedy fp32 streams and ledgers of both engines: every session woken
    from host; host, pooled and dropped sessions at once; every session
    dropped and re-prefilled cold."""
    mj, pj, mt, pt = _pair()
    ref = jax_serving.ContinuousBatchingEngine(
        mj, pj, n_slots=2, max_len=48, seed=0,
        tiers=jax_serving.TierConfig(host_sessions=host, pooled_sessions=pooled))
    want, want_ledgers = _two_turns(ref, mt.cfg.vocab)
    got, ledgers = _two_turns(_engine(mt, pt, tiers=TierConfig(host, pooled)), mt.cfg.vocab)
    for (w1, w2), (g1, g2) in zip(want, got):
        np.testing.assert_array_equal(g1, w1)
        np.testing.assert_array_equal(g2, w2)
    for led, want_led in zip(ledgers, want_ledgers):
        assert led["modeled_tier_s"] == pytest.approx(want_led["modeled_tier_s"], rel=1e-9)
        assert {k: v for k, v in led.items() if k != "modeled_tier_s"} == \
            {k: v for k, v in want_led.items() if k != "modeled_tier_s"}
    turn2 = ledgers[1]["counts"]
    assert turn2[5] + turn2[6] == 5  # every resume woken or re-prefilled
    assert {"host": (5, 0), "spill": (4, 1), "dropped": (0, 5)}[
        {8: "host", 2: "spill", 0: "dropped"}[host]] == (turn2[5], turn2[6])


def test_lru_spill_refill_and_drop_ordering():
    """Sessions demote in completion order; host overflow spills the least
    recently demoted row to pooled, pooled overflow drops the oldest row to
    its metadata; a refill pays the extra pooled hop.  The port's ledgers
    equal the reference engine's at every step."""
    mj, pj, mt, pt = _pair()
    vocab = mt.cfg.vocab
    engines = {
        "ref": jax_serving.ContinuousBatchingEngine(
            mj, pj, n_slots=2, max_len=48, seed=0,
            tiers=jax_serving.TierConfig(host_sessions=2, pooled_sessions=2)),
        "port": _engine(mt, pt, tiers=TierConfig(host_sessions=2, pooled_sessions=2)),
    }
    seen = {}
    for name, eng in engines.items():
        prompts, outs = {}, {}
        for sid in range(5):
            prompts[sid] = _prompt(vocab, 10 + sid, 4)
            r = eng.submit(prompts[sid], 3, session_id=sid)
            outs[sid] = eng.run()[r]
        pool = eng.pool
        assert sorted(pool.host) == [3, 4] and sorted(pool.pooled) == [1, 2]
        assert sorted(pool.dropped) == [0]
        assert pool.n_demote == 5 and pool.n_spill == 3 and pool.n_drop == 1
        assert pool.resident_sessions == 4 and pool.demoted_sessions == 4
        assert pool.modeled_tier_s > 0
        pool.check()
        history = np.concatenate([prompts[1], outs[1]])
        r = eng.submit(history, 2, session_id=1)
        woke = eng.run()[r]
        assert len(woke) == 2 and pool.n_refill == 1 and pool.n_promote == 1
        assert eng.metrics.wakeups == 1
        # a request with no session on a tiered engine evicts to the void
        evict0 = pool.n_evict
        eng.submit(_prompt(vocab, 99, 4), 2)
        eng.run()
        assert pool.n_evict == evict0 + 1 and pool.demoted_sessions == 4
        pool.check()
        seen[name] = (outs, woke, pool.modeled_tier_s, pool.n_spill, pool.n_refill)
    # a rebuilt pool adopts the ledgers and their counters (the migration path)
    old = engines["port"].pool
    new = TieredKVPool(mt, n_slots=3, capacity=48, tiers=old.tiers)
    new.adopt(old)
    assert (new.host, new.pooled, new.dropped) == (old.host, old.pooled, old.dropped)
    assert (new.n_demote, new.n_promote, new.n_spill, new.n_refill, new.n_drop,
            new.modeled_tier_s) == (old.n_demote, old.n_promote, old.n_spill, old.n_refill,
                                    old.n_drop, old.modeled_tier_s)
    assert new.n_alloc == 0 and new.n_free == 3
    new.check()
    (outs_r, woke_r, s_r, *n_r), (outs_p, woke_p, s_p, *n_p) = seen["ref"], seen["port"]
    for sid in range(5):
        np.testing.assert_array_equal(outs_p[sid], outs_r[sid])
    np.testing.assert_array_equal(woke_p, woke_r)
    assert s_p == pytest.approx(s_r, rel=1e-9) and n_p == n_r


# ------------------------------------------------------- within the port
@pytest.mark.parametrize("tiers", [TierConfig(host_sessions=4, pooled_sessions=4),
                                   TierConfig(host_sessions=0, pooled_sessions=0),
                                   TierConfig(host_sessions=0, pooled_sessions=4)],
                         ids=["host", "dropped", "pooled"])
def test_session_resume_matches_never_demoted_sampled_run(tiny, tiers):
    """A sampled session served in two turns (demoted between them) streams
    exactly as one never-demoted request; a resident row is woken with no
    prefill (host, or pooled through a refill), a dropped one re-prefilled
    cold on the same sampling stream; the resumed stream's audit indices are
    gap-free."""
    model, params = tiny
    prompt = _prompt(model.cfg.vocab, seed=1, n=6)
    g1, g2 = 5, 4
    ref = _engine(model, params, tiers=None)
    rid = ref.submit(prompt, g1 + g2, temperature=0.7)
    full = ref.run()[rid]

    eng = _engine(model, params, tiers=tiers, audit=True)
    r1 = eng.submit(prompt, g1, temperature=0.7, session_id=7)
    turn1 = eng.run()[r1]
    np.testing.assert_array_equal(turn1, full[:g1])
    tier = "host" if tiers.host_sessions else "pooled" if tiers.pooled_sessions else "dropped"
    assert eng.pool.session_tier(7) == tier
    assert eng.pool.n_used == 0 and eng.metrics.demotions == 1
    assert eng.pool.resident_sessions == (0 if tier == "dropped" else 1)

    prefills = eng.metrics.prefills
    r2 = eng.submit(np.concatenate([prompt, turn1]), g2, temperature=0.7, session_id=7)
    turn2 = eng.run()[r2]
    np.testing.assert_array_equal(turn2, full[g1:])
    cold = tier == "dropped"
    assert eng.metrics.prefills == prefills + cold
    assert (eng.metrics.wakeups, eng.metrics.cold_resumes) == ((0, 1) if cold else (1, 0))
    assert eng.pool.n_refill == (tier == "pooled")
    assert eng.requests[r2].t_first is not None
    assert [i for r, i in eng.audit if r == r2] == list(range(g2))
    eng.pool.check()


def test_session_contract_guard_rails(tiny):
    model, params = tiny
    eng = _engine(model, params)
    prompt = _prompt(model.cfg.vocab, seed=3, n=4)
    eng.submit(prompt, 3, session_id=1)
    with pytest.raises(ValueError, match="in flight"):
        eng.submit(prompt, 3, session_id=1)  # one request per session
    eng.run()
    with pytest.raises(ValueError, match="full token history"):
        eng.submit(prompt, 2, session_id=1)  # a resume carries prompt + tokens
    # the reference refuses the same calls with the same words
    mj, pj, _, _ = _pair()
    ref = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=2, max_len=48,
                                               tiers=jax_serving.TierConfig(4, 4))
    ref.submit(prompt, 3, session_id=1)
    with pytest.raises(ValueError, match="in flight"):
        ref.submit(prompt, 3, session_id=1)
    ref.run()
    with pytest.raises(ValueError, match="full token history"):
        ref.submit(prompt, 2, session_id=1)


def test_tiered_check_catches_ledger_corruption(tiny):
    model, _ = tiny
    pool = TieredKVPool(model, n_slots=2, capacity=16,
                        tiers=TierConfig(host_sessions=1, pooled_sessions=1))
    rec = SessionRecord(sid=0, pos=3, last_token=1, sample_rid=0, idx_base=4,
                        row={"k": np.zeros((1, 2))}, nbytes=16)
    pool.host[0] = rec
    pool.check()  # well formed
    pool.pooled[0] = rec  # one session in two tiers
    with pytest.raises(AssertionError, match="two tiers"):
        pool.check()
    del pool.pooled[0]
    rec.row = None  # a resident tier lost its row
    with pytest.raises(AssertionError, match="lost its row"):
        pool.check()
    rec.row = {"k": np.zeros((1, 2))}
    rec.tier = "pooled"  # in the host ledger, tagged pooled
    with pytest.raises(AssertionError, match="tagged"):
        pool.check()
    rec.tier = "host"
    pool.dropped[5] = SessionRecord(sid=5, pos=1, last_token=0, sample_rid=5, idx_base=1,
                                    tier="dropped", row={"k": np.zeros((1, 2))})
    with pytest.raises(AssertionError, match="still holds a row"):
        pool.check()
    pool.dropped[5].row = None
    pool.host[1] = SessionRecord(sid=1, pos=1, last_token=0, sample_rid=1, idx_base=1,
                                 row={"k": np.zeros((1, 2))})
    with pytest.raises(AssertionError, match="over capacity"):
        pool.check()
    with pytest.raises(ValueError, match=">= 0"):
        TierConfig(host_sessions=-1)


# --------------------------------------------- the batched wire format
def test_extract_all_insert_all_match_per_slot_path_and_reference():
    """The batched path equals per-slot extract/insert bit for bit; the
    port's rows, mapped to the JAX layout, equal the reference's rows of the
    same slots (fp32, 2e-5; positions exactly) with the same byte counts."""
    mj, pj, model, params = _pair()
    eng = ContinuousBatchingEngine(model, params, n_slots=3, max_len=24)
    ref = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=3, max_len=24)
    for e in (eng, ref):
        for i in range(3):
            e.submit(_prompt(model.cfg.vocab, seed=20 + i, n=4 + i), 8)
        for _ in range(3):  # ragged positions
            e.step(0.0)
    pool = eng.pool
    slots = pool.active_slots()
    assert slots == ref.pool.active_slots() and len(slots) == 3
    batched = pool.extract_all(slots)
    for s, row in zip(slots, batched):
        one = pool.extract(s)
        assert one.keys() == row.keys() == pool.caches.keys()
        for name in row:
            assert row[name].dtype == one[name].dtype
            assert row[name].shape == (pool.caches[name].shape[0], 1) + \
                tuple(pool.caches[name].shape[2:])
            np.testing.assert_array_equal(row[name], one[name])
        want = jax.tree.leaves(ref.pool.extract(s))
        got = jax.tree.leaves(to_jax_caches(model.cfg, row))
        assert [a.shape for a in got] == [a.shape for a in want]
        assert sum(a.nbytes for a in row.values()) == sum(a.nbytes for a in want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            if a.dtype.kind == "i":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=FP32_TOL, atol=FP32_TOL)
    dst = KVPool(model, n_slots=3, capacity=24)
    dslots = [dst.allocate(i) for i in range(3)]
    dst.insert_all(dslots[::-1], batched)
    for d, row in zip(dslots[::-1], batched):
        for name, leaf in dst.extract(d).items():
            np.testing.assert_array_equal(leaf, row[name])
    assert pool.extract_all([]) == []
    with pytest.raises(ValueError, match="slots but"):
        dst.insert_all(dslots[:2], batched)
    dst.free(dslots[0])
    with pytest.raises(ValueError, match="not allocated"):
        dst.insert_all([dslots[0]], batched[:1])
    with pytest.raises(ValueError, match="not allocated"):
        dst.extract(dslots[0])


# --------------------------------------------- the hybrid (SSM state rows)
@functools.lru_cache(maxsize=None)
def _hybrid(compute_dtype="float32"):
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", reduced=True),
                              compute_dtype=compute_dtype)
    model = build_model(cfg, device="cpu")
    return model, model.load(model.init(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_rows_round_trip_bit_exact(dtype):
    """Every leaf of a jamba row (the attention ring and positions, the
    Mamba-2 conv rows and SSM state) through extract and insert, alone and
    batched, into other slots: bit for bit; bf16 leaves cross as uint16."""
    model, _ = _hybrid(dtype)
    pool = KVPool(model, n_slots=3, capacity=16)
    gen = torch.Generator().manual_seed(1)
    for t in pool.caches.values():
        t.copy_(torch.randint(-1000, 1000, t.shape, generator=gen).to(t.dtype)
                if t.dtype == torch.int32 else torch.randn(t.shape, generator=gen).to(t.dtype))
    assert {"k", "v", "pos", "conv_x", "conv_b", "conv_c", "h"} == set(pool.caches)
    slots = [pool.allocate(r) for r in range(3)]
    rows = pool.extract_all(slots)
    want = {n: t.clone() for n, t in pool.caches.items()}
    assert rows[0]["h"].dtype == np.float32
    assert rows[0]["conv_x"].dtype == (np.uint16 if dtype == "bfloat16" else np.float32)
    pool.insert(slots[0], pool.extract(slots[2]))
    pool.insert_all(slots[1:], [rows[0], rows[1]])
    for n, t in pool.caches.items():
        assert torch.equal(t[:, 0], want[n][:, 2]) and torch.equal(t[:, 1], want[n][:, 0])
        assert torch.equal(t[:, 2], want[n][:, 1])
    # a row whose leaf has other words than the pool's is refused, not cast
    bad = {**rows[0], "h": rows[0]["h"].astype(np.float64)}
    for call in (lambda: pool.insert(slots[0], bad), lambda: pool.insert_all(slots[:1], [bad])):
        with pytest.raises(ValueError, match="row leaf of float64"):
            call()


@pytest.mark.parametrize("tiers", [TierConfig(host_sessions=1, pooled_sessions=1),
                                   TierConfig(host_sessions=0, pooled_sessions=0)],
                         ids=["host+pooled", "dropped"])
def test_hybrid_sessions_match_never_demoted_run(tiers):
    """REDUCED jamba (7 Mamba-2 layers and one attention layer, MoE FFNs)
    on one slot, so that no two rows share an expert's capacity: two
    sampled sessions over two turns stream exactly as never-demoted
    requests, woken from host and refilled from pooled with no prefill, or
    re-prefilled cold at their exact length once dropped."""
    model, params = _hybrid()
    vocab = model.cfg.vocab
    prompts = [_prompt(vocab, 60 + i, n) for i, n in enumerate((9, 6))]
    g1, g2 = 3, 4
    ref = _engine(model, params, n_slots=1, max_len=32, tiers=None)
    rids = [ref.submit(p, g1 + g2, temperature=0.7) for p in prompts]
    out = ref.run()
    full = [out[r] for r in rids]

    eng = _engine(model, params, n_slots=1, max_len=32, tiers=tiers)
    rids = [eng.submit(p, g1, temperature=0.7, session_id=i) for i, p in enumerate(prompts)]
    out = eng.run()
    first = [out[r] for r in rids]
    cold = tiers.host_sessions == 0
    if not cold:
        assert eng.pool.session_tier(0) == "pooled" and eng.pool.session_tier(1) == "host"
        assert {n for n in eng.pool.host[1].row} == set(eng.pool.caches)
    prefills = eng.metrics.prefills
    rids = [eng.submit(np.concatenate([p, f]), g2, temperature=0.7, session_id=i)
            for i, (p, f) in enumerate(zip(prompts, first))]
    out = eng.run()
    for i, r in enumerate(rids):
        np.testing.assert_array_equal(np.concatenate([first[i], out[r]]), full[i])
    assert eng.metrics.prefills == prefills + (2 if cold else 0)
    assert (eng.metrics.wakeups, eng.metrics.cold_resumes) == ((0, 2) if cold else (2, 0))
    assert eng.pool.n_refill == (0 if cold else 1)
    eng.pool.check()
