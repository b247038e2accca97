"""The port's serving runtime: queue, KV pool, scheduler and cost hooks behave
as ``tests/test_serving.py`` pins for the JAX package, and greedy fp32 token
streams of the port's engines equal the JAX engines' on the same weights
(internlm2, granite-moe and mamba2 REDUCED, 2 layers, mixed prompt lengths;
the MoE streams at the same ``n_slots``, since expert capacity couples the
rows of a step; mamba2's prompts below its chunk of 256, which the JAX
package's SSD paths require of a prompt prefilled at its exact length)."""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.model import Model as JaxModel
from repro.runtime import serving as jax_serving
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.core import CollectiveCostModel
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.obs import Obs
from repro_torch.runtime.serving import (
    SHED,
    ContinuousBatchingEngine,
    KVPool,
    Request,
    RequestQueue,
    Scheduler,
    SchedulerConfig,
    ServingEngine,
    SessionRecord,
    TierConfig,
    TieredKVPool,
)


def _make_pair(arch):
    """(JAX model, JAX params, port model, port params): same fp32 weights."""
    over = dict(compute_dtype="float32", remat=False, n_layers=2)
    cfg_j = dataclasses.replace(jax_get_config(arch, reduced=True), **over)
    cfg_t = dataclasses.replace(get_config(arch, reduced=True), **over)
    mj = jax_build_model(cfg_j)
    pj = mj.init(jax.random.PRNGKey(0))
    mt = build_model(cfg_t, device="cpu")
    return mj, pj, mt, from_jax_params(cfg_t, jax.tree.map(np.asarray, pj))


@pytest.fixture(scope="module")
def pair():
    return _make_pair("internlm2-1.8b")


@pytest.fixture(scope="module")
def moe_pair():
    return _make_pair("granite-moe-1b-a400m")


@pytest.fixture(scope="module")
def ssm_pair():
    return _make_pair("mamba2-1.3b")


@pytest.fixture(scope="module")
def tiny(pair):
    return pair[2], pair[3]


def _prompts(rng, vocab, lens):
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------- queue
def test_request_queue_arrival_order_and_lazy_removal():
    def mk(i, at=None):
        return Request(rid=i, prompt=np.ones((4,), np.int32), max_new_tokens=1, arrival_time=at)

    q = RequestQueue()
    a, b, c, d = mk(0), mk(1, at=5.0), mk(2), mk(3, at=2.0)
    for r in (a, b, c, d):
        q.push(r)
    assert len(q) == 4
    assert [r.rid for r in q.arrived(0.0)] == [0, 2]
    assert q.next_arrival() == 2.0
    assert [r.rid for r in q.arrived(2.0)] == [0, 2, 3]
    assert [r.rid for r in q.arrived(None)] == [0, 1, 2, 3]
    assert q.next_arrival() == 5.0
    q.remove([a, d])
    assert len(q) == 2
    assert [r.rid for r in q.arrived(10.0)] == [1, 2]
    e = mk(4, at=20.0)
    q.push(e)
    assert q.next_arrival() == 20.0
    q.remove([e])
    assert q.next_arrival() is None
    assert len(q) == 2
    q.remove([b, c])
    assert len(q) == 0 and q.arrived(100.0) == []


def test_request_queue_compaction_preserves_order():
    q = RequestQueue()
    reqs = [Request(rid=i, prompt=np.ones((2,), np.int32), max_new_tokens=1) for i in range(200)]
    for r in reqs:
        q.push(r)
    q.remove([reqs[i] for i in range(0, 200, 2)])
    assert len(q) == 100
    assert [r.rid for r in q.arrived(0.0)] == list(range(1, 200, 2))
    assert len(q) == 100


# ---------------------------------------------------------------- KV pool
def test_kvpool_slot_eviction_and_reuse(tiny):
    model, _ = tiny
    pool = KVPool(model, n_slots=3, capacity=16)
    assert [pool.allocate(rid) for rid in range(3)] == [0, 1, 2]
    assert pool.allocate(99) is None
    pool.free(1)
    assert pool.n_free == 1
    assert pool.allocate(100) == 1
    with pytest.raises(ValueError):
        pool.free(0) or pool.free(0)
    assert pool.n_alloc == 4 and pool.n_evict == 2 and pool.high_water == 3
    pool.check()


def test_kvpool_write_isolates_slots(tiny):
    model, params = tiny
    pool = KVPool(model, n_slots=3, capacity=16)
    _, caches = model.prefill(params, torch.ones((1, 8), dtype=torch.long))
    one = model.prepare_decode_caches(caches, capacity=16)
    before = {n: t.clone() for n, t in pool.caches.items()}
    pool.write([1], one)
    changed = {row for n in before for row in range(3)
               if not torch.equal(before[n][:, row], pool.caches[n][:, row])}
    assert changed == {1}
    assert torch.equal(pool.caches["k"][:, 1], one["k"][:, 0])


# ---------------------------------------------------------------- scheduler
def _req(rid, heavy=False, deferred=0):
    r = Request(rid=rid, prompt=np.ones((4,), np.int32), max_new_tokens=4,
                dispatch_weight=1e4 if heavy else 0.0)
    r.deferred = deferred
    return r


def test_scheduler_fcfs_is_arrival_order():
    s = Scheduler(SchedulerConfig(policy="fcfs"))
    assert [r.rid for r in s.select([_req(i) for i in range(5)], n_free=3)] == [0, 1, 2]


def test_scheduler_cost_aware_coschedules_moe_heavy():
    s = Scheduler(SchedulerConfig(policy="cost_aware", min_coschedule=2), CollectiveCostModel(),
                  d_model=512, top_k=4, n_moe_layers=2)
    lone_heavy = [_req(0, heavy=True), _req(1), _req(2)]
    assert [r.rid for r in s.select(lone_heavy, n_free=2)] == [1, 2]
    assert lone_heavy[0].deferred == 1
    group = [_req(0, heavy=True), _req(1, heavy=True), _req(2)]
    assert [r.rid for r in s.select(group, n_free=2)] == [0, 1]
    assert s.last_step_cost > 0


def test_scheduler_aging_prevents_starvation():
    cfg = SchedulerConfig(policy="cost_aware", min_coschedule=4, max_defer_steps=3)
    s = Scheduler(cfg, CollectiveCostModel(), d_model=512, top_k=4, n_moe_layers=2)
    assert s.select([_req(0, heavy=True, deferred=3), _req(1)], n_free=2)[0].rid == 0


def test_scheduler_aged_heavy_overrides_budget_in_mixed_traffic():
    cfg = SchedulerConfig(policy="cost_aware", a2a_budget_s=1e-12, min_coschedule=1,
                          max_defer_steps=3, work_conserving=False)
    s = Scheduler(cfg, CollectiveCostModel(), d_model=4096, top_k=8, n_moe_layers=8)
    picks = s.select([_req(0, heavy=True, deferred=3), _req(1)], n_free=2)
    assert [r.rid for r in picks] == [0, 1]


def test_scheduler_slot_exhaustion_still_ages_heavy():
    s = Scheduler(SchedulerConfig(policy="cost_aware", min_coschedule=1), CollectiveCostModel(),
                  d_model=64, top_k=2, n_moe_layers=1)
    reqs = [_req(i, heavy=True) for i in range(3)]
    picks = s.select(reqs, n_free=1)
    assert len(picks) == 1
    assert all(r.deferred == 1 for r in reqs if r not in picks)


def test_scheduler_budget_caps_heavy_admission():
    tight = SchedulerConfig(policy="cost_aware", a2a_budget_s=1e-12, min_coschedule=1,
                            work_conserving=False)
    s = Scheduler(tight, CollectiveCostModel(), d_model=4096, top_k=8, n_moe_layers=8)
    reqs = [_req(i, heavy=True) for i in range(4)]
    assert s.select(reqs, n_free=4) == []
    assert all(r.deferred == 1 for r in reqs)
    s2 = Scheduler(dataclasses.replace(tight, work_conserving=True), CollectiveCostModel(),
                   d_model=4096, top_k=8, n_moe_layers=8)
    assert len(s2.select(reqs, n_free=4)) >= 1


def test_cost_model_serving_hooks_match_reference():
    from repro.core.collectives import CollectiveCostModel as JaxCostModel

    cm, ref = CollectiveCostModel(), JaxCostModel()
    kw = dict(d_model=2048, top_k=2, n_low=8, n_pods=4)
    for tokens in (1, 8):
        for hier in (True, False):
            assert cm.moe_dispatch_cost(tokens, hierarchical=hier, **kw) == \
                ref.moe_dispatch_cost(tokens, hierarchical=hier, **kw)
    assert cm.moe_dispatch_cost(1, **kw) < cm.moe_dispatch_cost(8, **kw)
    assert cm.moe_dispatch_cost(8, **kw) < cm.moe_dispatch_cost(8, hierarchical=False, **kw)
    assert cm.decode_step_a2a_cost(0, 2048, 2, 4, 8, 4) == 0.0
    assert cm.decode_step_a2a_cost(4, 2048, 2, 4, 8, 4) == ref.decode_step_a2a_cost(
        4, 2048, 2, 4, 8, 4)
    assert cm.coschedule_gain(8, 2048, 2, 4, 8, 4) == ref.coschedule_gain(8, 2048, 2, 4, 8, 4) > 0
    assert cm.coschedule_gain(1, 2048, 2, 4, 8, 4) == 0.0
    assert cm.cold_prefill_cost(300) == ref.cold_prefill_cost(300)


# ---------------------------------------------------------------- engines vs JAX
def test_continuous_engine_matches_reference_greedy_streams(pair):
    mj, pj, mt, pt = pair
    rng = np.random.default_rng(4)
    prompts = _prompts(rng, mt.cfg.vocab, [5, 9, 13, 3, 17])
    budgets = [6, 4, 5, 7, 3]
    ref = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=3, max_len=48, seed=0)
    want = ref.generate(prompts, budgets)
    eng = ContinuousBatchingEngine(mt, pt, n_slots=3, max_len=48, seed=0)
    got = eng.generate(prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    eng.pool.check()
    assert eng.pool.n_alloc == eng.pool.n_evict == 5 and eng.pool.n_free == 3


def test_one_shot_engine_matches_reference_greedy_streams(pair):
    mj, pj, mt, pt = pair
    rng = np.random.default_rng(3)
    static = np.stack(_prompts(rng, mt.cfg.vocab, [8, 8, 8]))
    want = jax_serving.ServingEngine(mj, pj, max_len=48).generate(static, 6)
    got = ServingEngine(mt, pt, max_len=48).generate(static, 6)
    np.testing.assert_array_equal(got, want)


def _default(value):
    """A default as the test compares it: a dataclass instance (the pools'
    ``TierConfig()``) by its class name and fields."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value).__name__, dataclasses.asdict(value)
    return value


def _params_of(fn):
    """(name, default) of every parameter after ``self``."""
    return [(p.name, _default(p.default))
            for p in list(inspect.signature(fn).parameters.values())[1:]]


_ENGINE, _JAX_ENGINE = ContinuousBatchingEngine, jax_serving.ContinuousBatchingEngine
_SIGNATURES = {
    "engine": (_ENGINE.__init__, _JAX_ENGINE.__init__),
    "submit": (_ENGINE.submit, _JAX_ENGINE.submit),
    "prefill": (Model.prefill, JaxModel.prefill),
    "decode_step": (Model.decode_step, JaxModel.decode_step),
    "train_loss": (Model.train_loss, JaxModel.train_loss),
    "init_cache": (Model.init_cache, JaxModel.init_cache),
    "mask_prompt_cache": (Model.mask_prompt_cache, JaxModel.mask_prompt_cache),
    "prepare_decode_caches": (Model.prepare_decode_caches, JaxModel.prepare_decode_caches),
    "ServingEngine.generate": (ServingEngine.generate, jax_serving.ServingEngine.generate),
    "shed_queue": (_ENGINE.shed_queue, _JAX_ENGINE.shed_queue),
    "absorb_pool_metrics": (_ENGINE.absorb_pool_metrics, _JAX_ENGINE.absorb_pool_metrics),
    "run": (_ENGINE.run, _JAX_ENGINE.run),
    "admission_cost": (Scheduler.admission_cost, jax_serving.Scheduler.admission_cost),
}
for _name in ("__init__", "write", "extract", "insert", "extract_all", "insert_all",
              "allocate", "free", "active_slots", "check"):
    _SIGNATURES[f"KVPool.{_name}"] = (getattr(KVPool, _name), getattr(jax_serving.KVPool, _name))
for _name in ("__init__", "demote", "promote", "claim_dropped", "adopt", "session_tier",
              "lookup"):
    _SIGNATURES[f"TieredKVPool.{_name}"] = (getattr(TieredKVPool, _name),
                                            getattr(jax_serving.TieredKVPool, _name))


@pytest.mark.parametrize("port,ref", list(_SIGNATURES.values()), ids=list(_SIGNATURES))
def test_entry_points_take_the_reference_signature(port, ref):
    """The reference's parameters, in its order, with its defaults."""
    assert _params_of(port) == _params_of(ref)


@pytest.mark.parametrize("port,ref", [(Request, jax_serving.Request),
                                      (TierConfig, jax_serving.TierConfig),
                                      (SessionRecord, jax_serving.SessionRecord)],
                         ids=["Request", "TierConfig", "SessionRecord"])
def test_records_take_the_reference_fields(port, ref):
    """The dataclasses' fields in the reference's order with its defaults,
    so that a positional construction means the same (C3: ``session_id``
    is ``Request``'s eighth field, ``deadline`` its ninth)."""
    def fields(cls):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert fields(port) == fields(ref)
    assert public_properties(port) == public_properties(ref)
    if port is Request:
        args = (3, np.ones((4,), np.int32), 5, 0.5, 2, 1.0, 7.0, 11, 9.0)
        a, b = port(*args), ref(*args)
        assert (a.session_id, a.deadline) == (b.session_id, b.deadline) == (11, 9.0)
        assert a.sample_rid is None and a.idx_base == 0 and a.resume_bytes == 0


def public_properties(cls):
    return sorted(k for k, v in vars(cls).items() if isinstance(v, property))


def test_engines_take_the_reference_parameter_order(pair):
    """The engines and the model's entry points called positionally, as a
    caller of the JAX package would: (model, params, n_slots, max_len,
    mesh, ..., min_prompt_bucket, audit, tiers, max_queue_depth, obs) and
    (model, params, max_len, mesh); generate (prompts, max_new_tokens,
    pad_id, temperature, seed) and (prompts, max_new_tokens, temperature,
    eos_id); submit (..., now, session_id, deadline); prefill (params,
    batch, impl, mesh, last_pos); decode_step (params, caches, tokens, pos,
    impl, mesh, ragged).  audit, tiers, obs and a session id are taken in
    their places; what is not ported raises: a mesh, an impl that is
    neither "xla" nor "pallas"."""
    mj, pj, mt, pt = pair
    rng = np.random.default_rng(8)
    prompts = _prompts(rng, mt.cfg.vocab, [5, 9, 13, 3])
    budgets = [4, 6, 3, 5]
    want = jax_serving.ContinuousBatchingEngine(mj, pj, 3, 48, None).generate(
        prompts, budgets, 0.0, None)
    got = ContinuousBatchingEngine(mt, pt, 3, 48, None).generate(prompts, budgets, 0.0, None)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    static = np.stack(_prompts(rng, mt.cfg.vocab, [8, 8, 8]))
    want = jax_serving.ServingEngine(mj, pj, 48, None).generate(static, 6, 0, 0.0, 0)
    got = ServingEngine(mt, pt, 48, None).generate(static, 6, 0, 0.0, 0)
    np.testing.assert_array_equal(got, want)
    for make in (lambda: ContinuousBatchingEngine(mt, pt, 3, 48, object()),
                 lambda: ServingEngine(mt, pt, 48, object())):
        with pytest.raises(NotImplementedError, match="mesh"):
            make()

    # the constructor's tail: max_queue_depth is 14th, after audit and tiers
    eng = ContinuousBatchingEngine(mt, pt, 3, 48, None, None, None, "fcfs", 0, 0, 8, False,
                                   None, 1, None)
    assert eng.max_queue_depth == 1 and eng.min_prompt_bucket == 8
    assert not eng.audit_enabled and not eng.pool.tiered and eng.tiers is None
    # audit (12th), tiers (13th) and obs (15th) in their places, and taken
    ob = Obs()
    for i, value, took in (
            (11, True, lambda e: e.audit_enabled and e.audit == []),
            (12, TierConfig(2, 3), lambda e: e.pool.tiered and e.pool.tiers == TierConfig(2, 3)),
            (14, ob, lambda e: e.metrics.registry is ob.registry)):
        args = [mt, pt, 3, 48, None, None, None, "fcfs", 0, 0, 8, False, None, None, None]
        args[i] = value
        assert took(ContinuousBatchingEngine(*args))
    # submit's tail: (..., now, session_id, deadline)
    rid = eng.submit(prompts[0], 4, 0.0, None, None, None, 1.0, None, 2.5)
    assert eng.requests[rid].deadline == 2.5 and eng.requests[rid].t_submit == 1.0
    tiered = ContinuousBatchingEngine(mt, pt, 3, 48, tiers=TierConfig())
    rid = tiered.submit(prompts[0], 4, 0.0, None, None, None, 1.0, 7)
    assert tiered.requests[rid].session_id == 7 and tiered.requests[rid].deadline is None
    tiered.run()
    assert tiered.pool.session_tier(7) == "host"

    # prefill and decode_step: impl and mesh before last_pos and ragged
    toks = torch.as_tensor(np.stack([np.pad(p, (0, 13 - len(p))) for p in prompts]))
    last = torch.as_tensor([len(p) - 1 for p in prompts])
    with torch.no_grad():
        want_logits, want_caches = mt.prefill(pt, toks, last_pos=last)
        for impl in ("xla", "pallas"):
            logits, caches = mt.prefill(pt, {"tokens": toks}, impl, None, last)
            torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
        caches = mt.prepare_decode_caches(want_caches, 32)
        tok, pos = want_logits[:, 0].argmax(-1)[:, None], last + 1
        want_step, _ = mt.decode_step(pt, {k: v.clone() for k, v in caches.items()}, tok, pos,
                                      ragged=True)
        step, _ = mt.decode_step(pt, caches, tok, pos, "pallas", None, True)
        torch.testing.assert_close(step, want_step, rtol=0, atol=0)
        for call in (lambda: mt.prefill(pt, toks, "triton"),
                     lambda: mt.prefill(pt, toks, "xla", object()),
                     lambda: mt.decode_step(pt, caches, tok, pos, "xla", object(), True),
                     lambda: mt.decode_step(pt, caches, tok, pos, True)):
            with pytest.raises(NotImplementedError):
                call()


def test_moe_continuous_engine_matches_reference_greedy_streams(moe_pair):
    """MoE: prefill groups of several buckets and sizes, ragged decode with
    idle slots (their stale tokens route and take expert capacity in both)."""
    mj, pj, mt, pt = moe_pair
    rng = np.random.default_rng(6)
    prompts = _prompts(rng, mt.cfg.vocab, [5, 9, 13, 3, 17, 30, 8])
    budgets = [6, 4, 5, 7, 3, 5, 6]
    ref = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=3, max_len=48, seed=0)
    want = ref.generate(prompts, budgets)
    eng = ContinuousBatchingEngine(mt, pt, n_slots=3, max_len=48, seed=0)
    got = eng.generate(prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    eng.pool.check()
    assert eng.metrics.prefills > 1 and eng.pool.n_free == 3


def test_moe_one_shot_engine_matches_reference_greedy_streams(moe_pair):
    mj, pj, mt, pt = moe_pair
    rng = np.random.default_rng(7)
    static = np.stack(_prompts(rng, mt.cfg.vocab, [12, 12, 12, 12]))
    want = jax_serving.ServingEngine(mj, pj, max_len=48).generate(static, 8)
    got = ServingEngine(mt, pt, max_len=48).generate(static, 8)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- engine behaviour
def test_continuous_matches_one_shot(tiny):
    model, params = tiny
    rng = np.random.default_rng(5)
    static = np.stack(_prompts(rng, model.cfg.vocab, [8, 8, 8]))
    one = ServingEngine(model, params, max_len=48).generate(static, 6)
    cont = ContinuousBatchingEngine(model, params, n_slots=3, max_len=48).generate(static, 6)
    np.testing.assert_array_equal(one, np.stack(cont))
    # ragged: each request alone at its exact length equals its pooled run
    prompts = _prompts(rng, model.cfg.vocab, [5, 9, 13])
    cont = ContinuousBatchingEngine(model, params, n_slots=2, max_len=48).generate(prompts, 5)
    solo = ServingEngine(model, params, max_len=48)
    for p, got in zip(prompts, cont):
        np.testing.assert_array_equal(solo.generate(p[None], 5)[0], got)


def test_ragged_admission_and_slot_reuse(tiny):
    model, params = tiny
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=48, policy="fcfs")
    rng = np.random.default_rng(1)
    budgets = [4, 2, 6, 3, 5]
    rids = [eng.submit(p, b) for p, b in
            zip(_prompts(rng, model.cfg.vocab, [5, 9, 3, 12, 7]), budgets)]
    out = eng.run()
    assert [len(out[r]) for r in rids] == budgets
    assert eng.pool.n_alloc == 5 and eng.pool.n_evict == 5 and eng.pool.high_water <= 2
    admits = [eng.requests[r].t_admit for r in rids]
    assert admits == sorted(admits)
    m = eng.metrics
    assert m.decode_steps == len(m.decode_walls) and m.prefills == len(m.prefill_walls)
    assert 0.5 < m.slot_utilization <= 1.0
    eng.pool.check()


def test_eos_stops_the_stream(tiny):
    """EOS is a token whose first occurrence in the reference stream is at
    index k: the stream then stops after k + 1 tokens."""
    model, params = tiny
    rng = np.random.default_rng(5)
    for prompt in _prompts(rng, model.cfg.vocab, [8] * 8):  # random weights: some
        ref = ContinuousBatchingEngine(  # greedy streams repeat one token throughout
            model, params, n_slots=1, max_len=64).generate([prompt], 12)[0]
        firsts = [i for i in range(1, len(ref) - 1) if ref[i] not in ref[:i]]
        if firsts:
            break
    k = firsts[0]
    out = ContinuousBatchingEngine(model, params, n_slots=1, max_len=64).generate(
        [prompt], 12, eos_id=int(ref[k]))[0]
    np.testing.assert_array_equal(out, ref[: k + 1])


def test_temperature_sampling_does_not_depend_on_slots(tiny):
    model, params = tiny
    rng = np.random.default_rng(2)
    prompts = _prompts(rng, model.cfg.vocab, [6, 11, 4, 8])
    budgets = [5, 3, 6, 4]

    def serve_with(n_slots, seed):
        eng = ContinuousBatchingEngine(model, params, n_slots=n_slots, max_len=48, seed=seed)
        return eng.generate(prompts, budgets, temperature=0.8)

    a, b, c, d = serve_with(2, 7), serve_with(2, 7), serve_with(3, 7), serve_with(2, 8)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert any(not np.array_equal(x, y) for x, y in zip(a, d))


def test_submit_rejects_over_capacity_and_sheds(tiny):
    model, params = tiny
    eng = ContinuousBatchingEngine(model, params, n_slots=1, max_len=16, policy="fcfs",
                                   max_queue_depth=2)
    with pytest.raises(ValueError):
        eng.submit(np.ones((10,), np.int32), 10)
    with pytest.raises(ValueError):
        eng.submit(np.ones((0,), np.int32), 4)
    rids = [eng.submit(np.full((4,), i + 1, np.int32), 3) for i in range(4)]
    assert [eng.requests[r].state for r in rids] == ["queued"] * 2 + [SHED] * 2
    assert eng.pool.n_alloc == 0 and eng.metrics.rejected == 2 and eng.metrics.shed_tokens == 6
    out = eng.run()
    assert set(out) == set(rids[:2]) and eng.pool.n_alloc == eng.pool.n_evict == 2


def test_deadline_drop_and_virtual_clock(tiny):
    model, params = tiny
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32, policy="fcfs")
    r_live = eng.submit(np.ones((4,), np.int32), 3)
    r_dead = eng.submit(np.ones((4,), np.int32), 3, deadline=1.0)
    r_late = eng.submit(np.ones((4,), np.int32), 2, arrival_time=50.0)
    out = eng.run(clock=lambda: 5.0)  # frozen virtual clock: jumps to the arrival
    assert eng.requests[r_dead].state == SHED and eng.metrics.deadline_drops == 1
    assert set(out) == {r_live, r_late} and len(out[r_late]) == 2
    assert len(eng.queue) == 0


def test_admission_groups_are_single_bucket_pow2(tiny):
    model, params = tiny
    eng = ContinuousBatchingEngine(model, params, n_slots=8, max_len=256)
    lens = [4, 100, 4, 4, 5, 6, 7, 8]
    picks = [Request(rid=i, prompt=np.ones((n,), np.int32), max_new_tokens=1)
             for i, n in enumerate(lens)]
    groups = eng._admission_groups(picks)
    assert sorted(r.rid for g in groups for r in g) == list(range(8))
    padded = 0
    for g in groups:
        assert len({eng._bucket(r.prompt_len) for r in g}) == 1
        assert len(g) & (len(g) - 1) == 0
        padded += len(g) * eng._bucket(g[0].prompt_len)
    assert padded == 184


def test_launcher_runs_on_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                "--prompt-len", "12", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 ragged requests" in out and "on cpu" in out
    serve.main(["--reduced", "--device", "cpu", "--one-shot", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3"])
    assert "generated 6 tokens" in capsys.readouterr().out
    # a deadline that passes before the first step: every request dropped
    serve.main(["--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                "--prompt-len", "12", "--new-tokens", "4", "--deadline-s", "1e-9"])
    out = capsys.readouterr().out
    assert "served 3 ragged requests / 0 tokens" in out and "prefills=0" in out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_launcher_serves_moe_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--prompt-len", "12", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 ragged requests" in out and f"{arch}: 4 layers" in out


# ---------------------------------------------------------------- SSM (mamba2)
def test_ssm_continuous_engine_matches_reference_greedy_streams(ssm_pair):
    """An SSM stack is not bucketed: each request is prefilled alone at its
    exact length, in the port as in the reference."""
    mj, pj, mt, pt = ssm_pair
    rng = np.random.default_rng(9)
    lens = [5, 9, 13, 3, 9]
    prompts = _prompts(rng, mt.cfg.vocab, lens)
    budgets = [6, 4, 5, 7, 3]
    ref = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=3, max_len=48, seed=0)
    want = ref.generate(prompts, budgets)
    eng = ContinuousBatchingEngine(mt, pt, n_slots=3, max_len=48, seed=0)
    got = eng.generate(prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert [(g, b) for g, b, _ in eng.metrics.prefill_walls] == [(1, n) for n in lens]
    assert eng._admission_groups([eng.requests[r] for r in range(3)]) == [
        [eng.requests[0]], [eng.requests[1]], [eng.requests[2]]]
    eng.pool.check()
    assert eng.pool.n_alloc == eng.pool.n_evict == 5 and eng.pool.n_free == 3


def test_ssm_one_shot_engine_matches_reference_greedy_streams(ssm_pair):
    mj, pj, mt, pt = ssm_pair
    rng = np.random.default_rng(10)
    static = np.stack(_prompts(rng, mt.cfg.vocab, [12, 12, 12]))
    want = jax_serving.ServingEngine(mj, pj, max_len=48).generate(static, 6)
    got = ServingEngine(mt, pt, max_len=48).generate(static, 6)
    np.testing.assert_array_equal(got, want)


def test_ssm_idle_slots_are_overwritten_at_admission(ssm_pair):
    """An idle slot's SSM state advances on stale tokens in every decode
    step; admission writes every leaf of the slot, so a request admitted
    into it streams as it would alone."""
    _, _, model, params = ssm_pair
    rng = np.random.default_rng(11)
    long, short, late = _prompts(rng, model.cfg.vocab, [7, 4, 10])
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=48, seed=0)
    r_long, r_short = eng.submit(long, 12), eng.submit(short, 2)
    for _ in range(4):  # the short request finishes in the first; its slot then idles
        eng.step()
    (free,) = [s for s, rid in enumerate(eng.pool.slot_rid) if rid is None]
    idle = {n: t[:, free].clone() for n, t in eng.pool.caches.items()}
    eng.step()
    assert not torch.equal(idle["h"], eng.pool.caches["h"][:, free])  # advanced on garbage

    _, caches = model.prefill(eng.params, torch.as_tensor(late[None], dtype=torch.long))
    fresh = model.prepare_decode_caches(caches, capacity=48)
    assert set(fresh) == set(eng.pool.caches)
    r_late = eng.submit(late, 6)
    eng.step()  # admits into the dirty slot, then decodes once
    assert eng.requests[r_late].slot == free
    out = eng.run()
    solo = ContinuousBatchingEngine(model, params, n_slots=1, max_len=48, seed=0)
    rid = solo.submit(late, 6)
    np.testing.assert_array_equal(out[r_late], solo.run()[rid])
    assert len(out[r_long]) == 12 and len(out[r_short]) == 2


def test_launcher_serves_mamba2_on_cpu(capsys):
    serve.main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--prompt-len", "12", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 ragged requests" in out and "prefills=3" in out
    assert "mamba2-1.3b: 4 layers" in out


# ---------------------------------------------------------------- serving control
def _control_scenario(name, engine_cls, model, params, vocab):
    """One of the reference's shedding scenarios (``tests/test_serving.py``)
    on ``engine_cls``; returns what the test compares."""
    rng = np.random.default_rng(9)
    if name == "deadline":
        eng = engine_cls(model, params, n_slots=2, max_len=32, policy="fcfs", seed=0)
        p_live, p_dead = _prompts(rng, vocab, [4, 4])
        r_live = eng.submit(p_live, 3)
        r_dead = eng.submit(p_dead, 3, deadline=1.0)
        out = eng.run(clock=lambda: 5.0)  # virtual now is past the deadline
        rids = [r_live, r_dead]
    elif name == "shed_queue":
        eng = engine_cls(model, params, n_slots=1, max_len=32, policy="fcfs", seed=0)
        rids = [eng.submit(p, 2) for p in _prompts(rng, vocab, [4] * 5)]
        shed = (eng.shed_queue(keep_depth=2), eng.shed_queue(keep_depth=2))
        assert shed == (3, 0)  # the newest three, then nothing at the floor
        out = eng.run()
    else:  # a rejected tiered submit reserves no session
        tiers = (TierConfig() if engine_cls is ContinuousBatchingEngine
                 else jax_serving.TierConfig())
        eng = engine_cls(model, params, n_slots=1, max_len=32, seed=0, tiers=tiers,
                         max_queue_depth=1)
        p = np.ones((4,), np.int32)
        rids = [eng.submit(p, 2, session_id=0), eng.submit(p, 2, session_id=1)]
        eng.run()
        rids.append(eng.submit(p, 2, session_id=1))  # legal: never reserved
        out = eng.run()
    m = eng.metrics
    return ([eng.requests[r].state for r in rids], {r: out[r].tolist() for r in out},
            (m.rejected, m.deadline_drops, m.shed_tokens, eng.pool.n_alloc, eng.pool.n_evict,
             len(eng.queue)))


@pytest.mark.parametrize("name", ["deadline", "shed_queue", "rejected_session"])
def test_shedding_matches_reference(pair, name):
    """Deadline drops, ``shed_queue`` turning the newest arrivals away, and
    a rejected submit that reserves no session: the states, streams and
    counters of the port's engine equal the reference engine's."""
    mj, pj, mt, pt = pair
    want = _control_scenario(name, jax_serving.ContinuousBatchingEngine, mj, pj, mt.cfg.vocab)
    got = _control_scenario(name, ContinuousBatchingEngine, mt, pt, mt.cfg.vocab)
    assert got == want
    if name == "shed_queue":
        assert got[0] == ["finished"] * 2 + [SHED] * 3 and got[2][0] == 3


def test_pause_and_resume_admission(tiny):
    """Paused, the engine admits nothing: ``run`` returns with nothing
    active and the queue intact; requests already decoding go on to their
    end.  Resumed, the queue drains."""
    model, params = tiny
    rng = np.random.default_rng(12)
    prompts = _prompts(rng, model.cfg.vocab, [5, 7, 6])
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32, policy="fcfs")
    first = eng.submit(prompts[0], 4)
    eng.step()
    assert [r.rid for r in eng.active_requests()] == [first]
    eng.pause_admission()
    queued = [eng.submit(p, 3) for p in prompts[1:]]
    out = eng.run()
    assert set(out) == {first} and len(out[first]) == 4
    assert eng.active_requests() == [] and len(eng.queue) == 2
    assert all(eng.requests[r].state == "queued" for r in queued)
    assert eng.pool.n_alloc == 1
    eng.resume_admission()
    out = eng.run()
    assert set(out) == {first, *queued} and len(eng.queue) == 0
    eng.pool.check()


def test_absorb_pool_metrics_updates_in_place(tiny):
    """``serve.pool.*`` counters from the live pool, in the engine's
    registry (or a given one); absorbing again overwrites, never adds."""
    model, params = tiny
    ob = Obs()
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   tiers=TierConfig(host_sessions=1, pooled_sessions=1), obs=ob)
    p = np.arange(1, 6, dtype=np.int32)
    eng.submit(p, 2, session_id=0)
    eng.submit(p + 1, 2, session_id=1)
    eng.run()
    eng.absorb_pool_metrics()
    reg = ob.registry
    pool = eng.pool
    assert eng.metrics.registry is reg and reg["serve.engine.demotions"].value == 2
    for name in ("n_slots", "n_alloc", "n_evict", "high_water", "n_demote", "n_promote",
                 "n_spill", "n_refill", "n_drop", "modeled_tier_s", "resident_sessions",
                 "demoted_sessions"):
        assert reg[f"serve.pool.{name}"].value == getattr(pool, name)
    assert reg["serve.pool.n_spill"].value == 1
    eng.absorb_pool_metrics()
    assert reg["serve.pool.n_demote"].value == 2
    eng.submit(p + 2, 2)
    eng.run()
    eng.absorb_pool_metrics()
    assert reg["serve.pool.n_alloc"].value == 3 and reg["serve.pool.n_demote"].value == 2
    plain = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32)
    other = Obs().registry
    plain.absorb_pool_metrics(other)
    assert "serve.pool.n_demote" not in other and other["serve.pool.n_slots"].value == 2
