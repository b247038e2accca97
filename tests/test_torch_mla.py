"""The port's multi-head latent attention (MLA) against the JAX package's, on
``minicpm3-4b`` ``REDUCED`` (4 layers, d_model 128, 4 heads; q_lora 48,
kv_lora 32, qk nope/rope 16/8, v 16): the config, the MLA layer in prefill
(the expanded form, q/k head dim 24 against v head dim 16), lockstep decode
and ragged decode (the absorbed form over the compressed cache), the weight
and cache bridges, the model's prefill and decode, the reference's
decode-versus-teacher-forcing check on the port, the greedy streams of both
engines, tiered sessions and their row bytes, and the ``train_loss``
gradients.

Weights are made by the JAX package and cross the bridge; inputs come from
seeded numpy generators.  Tolerances: the layer in fp32 2e-5; the model's
fp32 logits and caches 1e-4 (``tests/test_torch_model.py``: the two
frameworks sum the same products in other orders through 4 layers);
gradients each leaf within 1e-4 of its largest value."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import minicpm3_4b as jax_minicpm3
from repro.configs.base import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.runtime import serving as jax_serving
from repro_torch.bridge import from_jax_caches, from_jax_params, to_jax_caches, to_jax_params
from repro_torch.configs import base
from repro_torch.configs import minicpm3_4b as minicpm3
from repro_torch.configs.base import get_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.runtime.serving import ContinuousBatchingEngine, ServingEngine, TierConfig
from repro_torch.tree import tree_leaves

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)

ARCH = "minicpm3-4b"
LAYER_TOL, FP32_TOL, GRAD_TOL = 2e-5, 1e-4, 1e-4
LENS, SEQ, CAPACITY, STEPS = (21, 14), 24, 40, 4


@functools.lru_cache(maxsize=None)
def _pair(n_layers=None):
    """(JAX model, JAX params with numpy leaves, port model, port params
    loaded on the CPU): the same fp32 weights.  Cached: no test modifies
    them."""
    over = dict(compute_dtype="float32")
    if n_layers:
        over["n_layers"] = n_layers
    cfg_j = dataclasses.replace(jax_get_config(ARCH, reduced=True), **over)
    cfg_t = dataclasses.replace(get_config(ARCH, reduced=True), **over)
    mj = jax_build_model(cfg_j)
    pj = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0)))
    mt = build_model(cfg_t, device="cpu")
    return mj, pj, mt, mt.load(from_jax_params(cfg_t, pj))


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _prompts(vocab, lens=LENS, seq=SEQ, seed=0):
    """Right-padded prompts [B, seq] of the given true lengths."""
    toks = np.random.default_rng(seed).integers(1, vocab, (len(lens), seq)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    return toks


# ---------------------------------------------------------------- config, bridge
def test_config_matches_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced)) == dataclasses.asdict(
            jax_get_config(ARCH, reduced))
    assert dataclasses.asdict(minicpm3.CONFIG) == dataclasses.asdict(jax_minicpm3.CONFIG)
    for name in ("MLAConfig", "FrontendConfig", "ModelConfig"):
        fields = lambda mod: [(f.name, f.default) for f in  # noqa: E731
                              dataclasses.fields(getattr(mod, name))]
        assert fields(base) == fields(jax_base), name
    for arch in jax_base.ARCH_IDS:
        want = jax_get_config(arch)
        assert get_config(arch).head_dim == want.head_dim
        assert (get_config(arch).n_encoder_layers, get_config(arch).enc_dec) == (
            want.n_encoder_layers, want.enc_dec)
    assert base.ARCH_IDS == jax_base.ARCH_IDS
    cfg = get_config(ARCH)
    assert build_model(cfg, device="cpu").cfg.mla.kv_lora_rank == 256  # full width builds


def test_bridge_round_trip_params_and_caches():
    mj, pj, mt, _ = _pair()
    cfg = mt.cfg
    pt = from_jax_params(cfg, pj)
    assert len(pt["layers"]) == cfg.n_layers
    assert set(pt["layers"][0]["mixer"]) == {"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm",
                                             "w_uk", "w_uv", "w_o"}
    back = to_jax_params(cfg, pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(1)
    caches = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                          if a.dtype != np.int32 else rng.integers(-1, 9, a.shape, np.int32),
                          jax.tree.map(np.asarray, mj.init_cache(2, 12)))
    flat = from_jax_caches(cfg, caches)
    assert {n: t.shape for n, t in flat.items()} == {
        n: tuple(t.shape) for n, t in mt.init_cache(2, 12).items()}
    assert set(flat) == {"ckv", "k_rope", "pos"}
    back = to_jax_caches(cfg, {n: torch.from_numpy(a) for n, a in flat.items()})
    assert jax.tree.structure(back) == jax.tree.structure(caches)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(caches)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the MLA layer
def _layer():
    """Layer 0's MLA weights in both packages, and its config."""
    mj, pj, mt, pt = _pair()
    return (jax.tree.map(lambda a: a[0], pj["decoder"][0]["mixer"]), mj.cfg,
            pt["layers"][0]["mixer"], mt.cfg)


def test_mla_prefill_matches_reference():
    """The expanded form: q/k head dim qk_nope + qk_rope, v head dim v_head_dim."""
    wj, cfg_j, wt, cfg_t = _layer()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 19, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19), (2, 19))
    want, wc = jax_attn.mla_apply(wj, jnp.asarray(x), cfg_j, positions=jnp.asarray(pos),
                                  update_cache=True)
    got, gc = attn.mla_apply(wt, torch.from_numpy(x), cfg_t, positions=torch.from_numpy(pos.copy()),
                             update_cache=True)
    _close(got, want, LAYER_TOL)
    assert set(gc) == set(wc) == {"ckv", "k_rope", "pos"}
    for name in gc:
        _close(gc[name], wc[name], LAYER_TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["lockstep", "ragged"])
def test_mla_decode_matches_reference(ragged):
    """The absorbed form over a compressed cache with empty slots, one step
    per row at the rows' own positions (ragged) or at one shared one."""
    wj, cfg_j, wt, cfg_t = _layer()
    m, rng = cfg_t.mla, np.random.default_rng(3)
    b, length = 3, 16
    cache = {"ckv": rng.normal(size=(b, length, m.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.normal(size=(b, length, m.qk_rope_head_dim)).astype(np.float32)}
    filled = np.array([11, 7, 14]) if ragged else np.full(b, 9)
    cache["pos"] = np.where(np.arange(length)[None] < filled[:, None], np.arange(length)[None],
                            -1).astype(np.int32)
    x = rng.normal(size=(b, 1, cfg_t.d_model)).astype(np.float32)
    pos = filled[:, None].astype(np.int32)
    want, wc = jax_attn.mla_apply(wj, jnp.asarray(x), cfg_j, positions=jnp.asarray(pos),
                                  cache=jax.tree.map(jnp.asarray, cache), ragged=ragged)
    mine = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got, gc = attn.mla_apply(wt, torch.from_numpy(x), cfg_t, positions=torch.from_numpy(pos),
                             cache=mine, ragged=ragged)
    assert gc is mine  # written in place
    _close(got, want, LAYER_TOL)
    for name in ("ckv", "k_rope"):
        _close(gc[name], wc[name], LAYER_TOL)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def reference():
    """The JAX model on right-padded prompts: prefill at each row's last
    real token, the cache masked and re-laid with headroom, then STEPS
    ragged greedy decode steps."""
    mj, pj, mt, _ = _pair()
    toks = _prompts(mt.cfg.vocab)
    last = np.array(LENS, np.int32) - 1
    logits, caches = jax.jit(lambda p, t, lp: mj.prefill(p, {"tokens": t}, last_pos=lp))(
        pj, toks, last)
    out = dict(toks=toks, logits=np.asarray(logits), prefill=jax.tree.map(np.asarray, caches),
               steps=[], feeds=[])
    caches = mj.prepare_decode_caches(mj.mask_prompt_cache(caches, jnp.asarray(LENS)), CAPACITY)
    step = jax.jit(lambda p, c, t, pos: mj.decode_step(p, c, t, pos, ragged=True))
    tok, pos = np.asarray(logits)[:, 0].argmax(-1).astype(np.int32), np.array(LENS, np.int32)
    for _ in range(STEPS):
        out["feeds"].append(tok)
        lg, caches = step(pj, caches, tok[:, None], pos)
        out["steps"].append(np.asarray(lg))
        tok, pos = np.asarray(lg)[:, 0].argmax(-1).astype(np.int32), pos + 1
    out["final"] = jax.tree.map(np.asarray, caches)
    return out


def test_prefill_and_decode_match_reference(reference):
    _, _, mt, pt = _pair()
    cfg = mt.cfg
    with torch.no_grad():
        logits, caches = mt.prefill(pt, {"tokens": torch.from_numpy(reference["toks"])},
                                    last_pos=torch.tensor(LENS) - 1)
        _close(logits, reference["logits"], FP32_TOL)
        want = from_jax_caches(cfg, reference["prefill"])
        assert set(caches) == set(want) == {"ckv", "k_rope", "pos"}
        for name, w in want.items():
            _close(caches[name], w, FP32_TOL)
        caches = mt.prepare_decode_caches(mt.mask_prompt_cache(caches, torch.tensor(LENS)),
                                          CAPACITY)
        assert caches["ckv"].shape[2] == CAPACITY
        pos = torch.tensor(LENS)
        for feed, want_lg in zip(reference["feeds"], reference["steps"]):
            logits, caches = mt.decode_step(pt, caches, torch.from_numpy(feed)[:, None].long(),
                                            pos, ragged=True)
            _close(logits, want_lg, FP32_TOL)
            pos = pos + 1
    for name, w in from_jax_caches(cfg, reference["final"]).items():
        _close(caches[name], w, FP32_TOL)


def test_decode_matches_teacher_forcing():
    """``tests/test_archs.py``'s check on the port: a decode step after a
    prefill of S - 1 tokens gives the logits of a prefill of all S (lockstep,
    as the reference's check runs it)."""
    _, _, mt, pt = _pair()
    b, s = 2, 32
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, mt.cfg.vocab, (b, s)))
    with torch.no_grad():
        _, caches = mt.prefill(pt, {"tokens": toks[:, : s - 1]})
        caches = mt.prepare_decode_caches(caches, capacity=s + 8)
        step, _ = mt.decode_step(pt, caches, toks[:, s - 1:], torch.full((b,), s - 1))
        full, _ = mt.prefill(pt, {"tokens": toks})
    rel = (step - full).abs().max().item() / (full.abs().max().item() + 1e-9)
    assert rel < 1e-4


# ---------------------------------------------------------------- engines
def _ragged(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def test_engines_match_reference_greedy_streams():
    """Both engines, fp32, on the same weights: the continuous engine on 3
    slots (prefill groups of several buckets, ragged decode over the
    compressed cache) and the one-shot engine in lockstep."""
    mj, pj, mt, pt = _pair(n_layers=2)
    prompts, budgets = _ragged(mt.cfg.vocab, [5, 9, 13, 3, 17], 4), [6, 4, 5, 7, 3]
    want = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=3, max_len=48,
                                                seed=0).generate(prompts, budgets)
    eng = ContinuousBatchingEngine(mt, pt, n_slots=3, max_len=48, seed=0)
    assert set(eng.pool.caches) == {"ckv", "k_rope", "pos"}
    got = eng.generate(prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    eng.pool.check()
    static = np.stack(_ragged(mt.cfg.vocab, [8, 8, 8], 3))
    np.testing.assert_array_equal(ServingEngine(mt, pt, max_len=48).generate(static, 6),
                                  jax_serving.ServingEngine(mj, pj, max_len=48).generate(static, 6))


def _two_turns(engine, vocab):
    """Three sessions over two turns; returns each one's streams and the
    row bytes of every resident session after turn 1."""
    prompts = _ragged(vocab, [5, 9, 7], 40)
    rids = [engine.submit(p, 3, session_id=i) for i, p in enumerate(prompts)]
    out = engine.run()
    first = [out[r] for r in rids]
    pool = engine.pool
    nbytes = sorted(rec.nbytes for rec in list(pool.host.values()) + list(pool.pooled.values()))
    rids = [engine.submit(np.concatenate([p, f]), 4, session_id=i)
            for i, (p, f) in enumerate(zip(prompts, first))]
    out = engine.run()
    return [np.concatenate([f, out[r]]) for f, r in zip(first, rids)], nbytes, prompts


def test_tiered_sessions_match_reference_and_resume_bit_for_bit():
    """Sessions through the tiered pool (one woken from host, one refilled
    from pooled, one dropped and re-prefilled): the same streams and row
    bytes as the JAX engine's, and the same streams as never-demoted
    requests of the port."""
    mj, pj, mt, pt = _pair(n_layers=2)
    tiers = dict(host_sessions=1, pooled_sessions=1)
    want, want_bytes, _ = _two_turns(jax_serving.ContinuousBatchingEngine(
        mj, pj, n_slots=2, max_len=48, seed=0, tiers=jax_serving.TierConfig(**tiers)),
        mt.cfg.vocab)
    eng = ContinuousBatchingEngine(mt, pt, n_slots=2, max_len=48, seed=0,
                                   tiers=TierConfig(**tiers))
    got, nbytes, prompts = _two_turns(eng, mt.cfg.vocab)
    assert nbytes == want_bytes and len(nbytes) == 2
    m = mt.cfg.mla
    assert nbytes[0] == 2 * 48 * ((m.kv_lora_rank + m.qk_rope_head_dim) * 4 + 4)
    assert (eng.metrics.wakeups, eng.metrics.cold_resumes, eng.pool.n_refill) == (2, 1, 1)
    straight = ContinuousBatchingEngine(mt, pt, n_slots=2, max_len=48, seed=0)
    full = straight.generate(prompts, [7, 7, 7])
    for w, g, f in zip(want, got, full):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)
    eng.pool.check()


# ---------------------------------------------------------------- training
def test_train_loss_gradients_match_reference():
    mj, pj, mt, _ = _pair()
    cfg = mt.cfg
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    (want_loss, _), want = jax.value_and_grad(mj.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, pj), jax.tree.map(jnp.asarray, batch))
    params = from_jax_params(cfg, pj)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    loss, _ = mt.train_loss(params, batch)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = to_jax_params(cfg, _grads(params))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


def _grads(params):
    """The ``.grad`` of every leaf of a port param tree, in its layout."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_grads(v) for v in params]
    return params.grad
