"""The port's frontend path against the JAX package's, on
``phi-3-vision-4.2b`` ``REDUCED`` (4 dense GQA layers, d_model 128, 4
heads over 4 KV heads; a vision frontend of 16 patch rows of width 64
projected by ``frontend_proj``): the config, the weight and cache
bridges, prefill with ``frontend_embeds`` (its first positions replaced by
the projected rows) and the decode steps after it, the reference's
decode-versus-teacher-forcing check on the port, ``train_loss`` with the
frontend positions masked out of the loss and its gradients,
``frontend_proj``'s among them, and the engines serving text.

Weights are made by the JAX package and cross the bridge; inputs come from
seeded numpy generators.  Tolerances: fp32 logits and caches 1e-4
(``tests/test_torch_model.py``); gradients each leaf within 1e-4 of its
largest value."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import phi_3_vision_4_2b as jax_phi3v
from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime import serving as jax_serving
from repro_torch.bridge import from_jax_caches, from_jax_params, to_jax_caches, to_jax_params
from repro_torch.configs import phi_3_vision_4_2b as phi3v
from repro_torch.configs.base import get_config
from repro_torch.models import build_model
from repro_torch.runtime.serving import ContinuousBatchingEngine
from repro_torch.tree import tree_leaves

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)

ARCH = "phi-3-vision-4.2b"
FP32_TOL, GRAD_TOL = 1e-4, 1e-4
B, S, N_FRONT, CAPACITY, STEPS = 2, 28, 10, 40, 4


@functools.lru_cache(maxsize=None)
def _pair(n_layers=None):
    """(JAX model, JAX params with numpy leaves, port model, port params
    loaded on the CPU): the same fp32 weights."""
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


def _batch(cfg, seed=0, s=S, n=N_FRONT):
    """Tokens, next-token targets and ``n`` frontend rows (numpy, fp32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, s)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
            "frontend_embeds": rng.normal(size=(B, n, cfg.frontend.d_frontend))
            .astype(np.float32)}


def test_config_and_bridge_match_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced)) == dataclasses.asdict(
            jax_get_config(ARCH, reduced))
    assert dataclasses.asdict(phi3v.CONFIG) == dataclasses.asdict(jax_phi3v.CONFIG)
    full = get_config(ARCH)
    assert (full.head_dim, full.n_heads, full.n_kv_heads) == (96, 32, 32)
    mj, pj, mt, _ = _pair()
    pt = from_jax_params(mt.cfg, pj)
    assert tuple(pt["frontend_proj"].shape) == (mt.cfg.frontend.d_frontend, mt.cfg.d_model)
    back = to_jax_params(mt.cfg, pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, b)
    mine = mt.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items() if k != "layers"} == {
        k: v.shape for k, v in pj.items() if k != "decoder"}
    rng = np.random.default_rng(1)
    caches = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                          if a.dtype != np.int32 else rng.integers(-1, 9, a.shape, np.int32),
                          jax.tree.map(np.asarray, mj.init_cache(2, 12)))
    flat = from_jax_caches(mt.cfg, caches)
    assert {n: t.shape for n, t in flat.items()} == {
        n: tuple(t.shape) for n, t in mt.init_cache(2, 12).items()}
    back = to_jax_caches(mt.cfg, {n: torch.from_numpy(a) for n, a in flat.items()})
    assert jax.tree.structure(back) == jax.tree.structure(caches)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(caches)):
        np.testing.assert_array_equal(a, b)


def test_frontend_prefill_and_decode_match_reference():
    """Prefill over 10 projected patch rows and 18 text tokens, then ragged
    greedy decode steps over the cache the patch rows wrote."""
    mj, pj, mt, pt = _pair()
    batch = _batch(mt.cfg)
    want_lg, want_c = jax.jit(lambda p, b: mj.prefill(p, b))(
        pj, {k: v for k, v in batch.items() if k != "targets"})
    want_c = mj.prepare_decode_caches(want_c, CAPACITY)
    step = jax.jit(lambda p, c, t, pos: mj.decode_step(p, c, t, pos, ragged=True))
    with torch.no_grad():
        logits, caches = mt.prefill(pt, batch)
        _close(logits, want_lg, FP32_TOL)
        text_only, _ = mt.prefill(pt, {"tokens": batch["tokens"]})
        assert (text_only - logits).abs().max() > 1e-3  # the patch rows took effect
        caches = mt.prepare_decode_caches(caches, CAPACITY)
        for name, w in from_jax_caches(mt.cfg, jax.tree.map(np.asarray, want_c)).items():
            _close(caches[name], w, FP32_TOL)
        tok, pos = np.asarray(want_lg)[:, 0].argmax(-1).astype(np.int32), np.full(B, S, np.int32)
        for _ in range(STEPS):
            want_lg, want_c = step(pj, want_c, tok[:, None], pos)
            logits, caches = mt.decode_step(pt, caches, torch.from_numpy(tok)[:, None].long(),
                                            torch.from_numpy(pos).long(), ragged=True)
            _close(logits, want_lg, FP32_TOL)
            tok, pos = np.asarray(want_lg)[:, 0].argmax(-1).astype(np.int32), pos + 1


def test_decode_matches_teacher_forcing():
    """``tests/test_archs.py``'s check on the port, with the frontend rows
    in both prefills."""
    _, _, mt, pt = _pair()
    batch = _batch(mt.cfg, seed=1, s=32, n=16)
    toks = torch.from_numpy(batch["tokens"]).long()
    with torch.no_grad():
        _, caches = mt.prefill(pt, dict(batch, tokens=toks[:, :31]))
        caches = mt.prepare_decode_caches(caches, capacity=40)
        step, _ = mt.decode_step(pt, caches, toks[:, 31:], torch.full((B,), 31))
        full, _ = mt.prefill(pt, batch)
    assert (step - full).abs().max().item() / (full.abs().max().item() + 1e-9) < 1e-4


def test_train_loss_masks_the_frontend_and_gradients_match_reference():
    mj, pj, mt, _ = _pair()
    cfg = mt.cfg
    batch = _batch(cfg, seed=5)
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
    assert np.abs(got["frontend_proj"]).max() > 0
    # the frontend positions weigh 0: other targets there leave the loss as it was
    other = dict(batch, targets=batch["targets"].copy())
    other["targets"][:, :N_FRONT] = (other["targets"][:, :N_FRONT] + 7) % cfg.vocab
    with torch.no_grad():
        same, _ = mt.train_loss(params, other)
        text = {k: v for k, v in other.items() if k != "frontend_embeds"}
        moved, _ = mt.train_loss(params, text)
    assert same.item() == loss.item() and moved.item() != loss.item()


def _grads(params):
    """The ``.grad`` of every leaf of a port param tree, in its layout."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_grads(v) for v in params]
    return params.grad


@pytest.mark.parametrize("n_slots", [3])
def test_engine_serves_text_as_the_reference(n_slots):
    """The engines serve phi-3-vision on text, as the reference's do: the
    continuous engine's greedy fp32 streams equal the JAX engine's."""
    mj, pj, mt, pt = _pair(n_layers=2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, mt.cfg.vocab, (n,)).astype(np.int32) for n in (5, 11, 3, 8)]
    budgets = [5, 3, 6, 4]
    want = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=n_slots, max_len=32,
                                                seed=0).generate(prompts, budgets)
    got = ContinuousBatchingEngine(mt, pt, n_slots=n_slots, max_len=32, seed=0).generate(
        prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
