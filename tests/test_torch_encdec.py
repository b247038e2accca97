"""The port's encoder-decoder against the JAX package's, on
``seamless-m4t-large-v2`` ``REDUCED`` (2 encoder and 2 decoder layers,
d_model 128, 4 heads over 4 KV heads; audio frames of width 32): the
config, the weight and cache bridges (the encoder's stack, the decoder's
``ln_cross``/``cross`` leaves, the cross K/V), the encoder's output and
the cross K/V it gives every decoder layer, ``init_cache`` with a memory
length, prefill over ``encoder_frames`` and the decode steps after it, the
reference's decode-versus-teacher-forcing check on the port,
``train_loss`` and its gradients, and both engines refusing the model with
the reference's messages.

Weights are made by the JAX package and cross the bridge; inputs come from
seeded numpy generators.  Tolerances: fp32 activations, logits and caches
1e-4 (``tests/test_torch_model.py``); gradients each leaf within 1e-4 of
its largest value."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import seamless_m4t_large_v2 as jax_seamless
from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime import serving as jax_serving
from repro_torch.bridge import from_jax_caches, from_jax_params, to_jax_caches, to_jax_params
from repro_torch.configs import seamless_m4t_large_v2 as seamless
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.runtime.serving import ContinuousBatchingEngine, ServingEngine
from repro_torch.tree import tree_leaves

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
FP32_TOL, GRAD_TOL = 1e-4, 1e-4
B, S, M, CAPACITY, STEPS = 2, 12, 20, 24, 4


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model, JAX params with numpy leaves, port model, port params
    loaded on the CPU): the same fp32 weights."""
    cfg_j = dataclasses.replace(jax_get_config(ARCH, reduced=True), compute_dtype="float32")
    cfg_t = dataclasses.replace(get_config(ARCH, reduced=True), compute_dtype="float32")
    mj = jax_build_model(cfg_j)
    pj = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0)))
    mt = build_model(cfg_t, device="cpu")
    return mj, pj, mt, mt.load(from_jax_params(cfg_t, pj))


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _batch(cfg, seed=0, s=S, m=M):
    """Decoder tokens and targets [B, s], encoder frames [B, m, d_frontend]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, s)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
            "encoder_frames": rng.normal(size=(B, m, cfg.frontend.d_frontend))
            .astype(np.float32)}


def test_config_and_bridge_match_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced)) == dataclasses.asdict(
            jax_get_config(ARCH, reduced))
    assert dataclasses.asdict(seamless.CONFIG) == dataclasses.asdict(jax_seamless.CONFIG)
    assert build_model(get_config(ARCH), device="cpu").cfg.n_encoder_layers == 24  # full width
    mj, pj, mt, _ = _pair()
    cfg = mt.cfg
    pt = from_jax_params(cfg, pj)
    assert len(pt["encoder"]) == cfg.n_encoder_layers and len(pt["layers"]) == cfg.n_layers
    assert set(pt["encoder"][0]) == {"ln1", "mixer", "ln2", "ffn"}
    assert set(pt["layers"][0]) == {"ln1", "mixer", "ln_cross", "cross", "ln2", "ffn"}
    back = to_jax_params(cfg, pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, b)
    mine = mt.init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(to_jax_params(cfg, mine)) == jax.tree.structure(pj)

    rng = np.random.default_rng(1)
    caches = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                          if a.dtype != np.int32 else rng.integers(-1, 9, a.shape, np.int32),
                          jax.tree.map(np.asarray, mj.init_cache(2, 12, mem_len=7)))
    flat = from_jax_caches(cfg, caches)
    assert {n: t.shape for n, t in flat.items()} == {
        n: tuple(t.shape) for n, t in mt.init_cache(2, 12, mem_len=7).items()}
    assert flat["cross_k"].shape == (cfg.n_layers, 2, 7, cfg.n_kv_heads, cfg.head_dim)
    back = to_jax_caches(cfg, {n: torch.from_numpy(a) for n, a in flat.items()})
    assert jax.tree.structure(back) == jax.tree.structure(caches)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(caches)):
        np.testing.assert_array_equal(a, b)


def test_encoder_output_and_cross_kv_match_reference():
    mj, pj, mt, pt = _pair()
    batch = _batch(mt.cfg)
    want_mem = jax.jit(lambda p, b: mj._encode(p, b, jnp.float32))(pj, batch)
    want_kv = mj._decoder_cross_caches(jax.tree.map(jnp.asarray, pj), want_mem)
    with torch.no_grad():
        memory = mt._encode(pt, batch)
        _close(memory, want_mem, FP32_TOL)
        kv = mt._decoder_cross_caches(pt, memory)
    (want_kv,) = want_kv  # period 1: one block, stacked over the layers
    for name in ("k", "v"):
        _close(kv[f"cross_{name}"], want_kv[name], FP32_TOL)


def test_prefill_and_decode_match_reference():
    """Prefill over the encoder frames and a 12-token prompt, the caches
    re-laid (the cross K/V untouched), then ragged greedy decode steps."""
    mj, pj, mt, pt = _pair()
    batch = _batch(mt.cfg)
    feed = {k: v for k, v in batch.items() if k != "targets"}
    want_lg, want_c = jax.jit(lambda p, b: mj.prefill(p, b))(pj, feed)
    want_c = mj.prepare_decode_caches(want_c, CAPACITY)
    step = jax.jit(lambda p, c, t, pos: mj.decode_step(p, c, t, pos, ragged=True))
    with torch.no_grad():
        logits, caches = mt.prefill(pt, feed)
        _close(logits, want_lg, FP32_TOL)
        relaid = mt.prepare_decode_caches(caches, CAPACITY)
        for name in ("cross_k", "cross_v"):
            assert relaid[name] is caches[name]
        caches = relaid
        for name, w in from_jax_caches(mt.cfg, jax.tree.map(np.asarray, want_c)).items():
            _close(caches[name], w, FP32_TOL)
        tok, pos = np.asarray(want_lg)[:, 0].argmax(-1).astype(np.int32), np.full(B, S, np.int32)
        for _ in range(STEPS):
            want_lg, want_c = step(pj, want_c, tok[:, None], pos)
            logits, caches = mt.decode_step(pt, caches, torch.from_numpy(tok)[:, None].long(),
                                            torch.from_numpy(pos).long(), ragged=True)
            _close(logits, want_lg, FP32_TOL)
            tok, pos = np.asarray(want_lg)[:, 0].argmax(-1).astype(np.int32), pos + 1
    for name, w in from_jax_caches(mt.cfg, jax.tree.map(np.asarray, want_c)).items():
        _close(caches[name], w, FP32_TOL)


def test_decode_matches_teacher_forcing():
    """``tests/test_archs.py``'s check on the port: the same encoder frames
    in both prefills."""
    _, _, mt, pt = _pair()
    batch = _batch(mt.cfg, seed=1, s=32, m=32)
    toks = torch.from_numpy(batch["tokens"]).long()
    with torch.no_grad():
        _, caches = mt.prefill(pt, dict(batch, tokens=toks[:, :31]))
        caches = mt.prepare_decode_caches(caches, capacity=40)
        step, _ = mt.decode_step(pt, caches, toks[:, 31:], torch.full((B,), 31))
        full, _ = mt.prefill(pt, batch)
    assert (step - full).abs().max().item() / (full.abs().max().item() + 1e-9) < 1e-4


def test_train_loss_gradients_match_reference():
    """Through the encoder, the cross K/V and the decoder (each block under
    ``torch.utils.checkpoint``, as ``remat`` asks)."""
    mj, pj, mt, _ = _pair()
    cfg = mt.cfg
    assert cfg.remat
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


def _grads(params):
    """The ``.grad`` of every leaf of a port param tree, in its layout."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_grads(v) for v in params]
    return params.grad


def test_engines_refuse_it_with_the_reference_messages():
    mj, pj, mt, pt = _pair()
    message = "continuous batching supports decoder-only models"
    with pytest.raises(NotImplementedError, match=message):
        jax_serving.ContinuousBatchingEngine(mj, pj)
    with pytest.raises(NotImplementedError, match=message):
        ContinuousBatchingEngine(mt, pt)
    prompts = np.ones((2, 8), np.int32)
    for engine in (jax_serving.ServingEngine(mj, pj, max_len=16), ServingEngine(mt, pt, 16)):
        with pytest.raises(NotImplementedError, match="use generate_enc_dec"):
            engine.generate(prompts, 4)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != ARCH])
def test_engines_take_every_other_architecture(arch):
    """Every other architecture the JAX package registers builds at full
    width, and its REDUCED config serves a token through both engines."""
    build_model(get_config(arch), device="cpu")
    model = build_model(get_config(arch, reduced=True), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = np.arange(1, 6, dtype=np.int32)
    out = ContinuousBatchingEngine(model, params, n_slots=1, max_len=8).generate([prompt], 2)
    assert len(out[0]) == 2
    assert ServingEngine(model, params, max_len=8).generate(prompt[None], 2).shape == (1, 2)
