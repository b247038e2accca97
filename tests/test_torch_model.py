"""The port's model against the JAX package's, on the REDUCED configs of the
three dense main-path architectures and the two MoE ones: configs, the
weight bridge, prefill (both JAX paths: XLA, and the Pallas kernels in
interpret mode), the prompt-cache re-lay and ragged/lockstep decode.

Weights are made by the JAX package and cross the bridge; inputs come from a
seeded numpy generator.  Tolerances: fp32 logits and caches 1e-4 (the two
frameworks sum the same products in different orders through 4 layers; the
observed gap is ~4e-6).  Whole-model bf16 logits and caches: 5e-2 absolute plus
2e-2 relative -- the per-kernel bf16 tolerance of ``tests/test_kernels.py`` (2e-2)
does not hold even between the JAX package's own XLA and Pallas prefill
paths, which differ by up to 3.9e-2 on these logits (a few bf16 ulps at
magnitude ~4, rounded at different places)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.bridge import from_jax_params, to_jax_params
from repro_torch.configs.base import get_config
from repro_torch.models import build_model

ARCHS = ["internlm2-1.8b", "h2o-danube-1.8b", "qwen3-32b", "granite-moe-1b-a400m", "olmoe-1b-7b"]
FP32_TOL = 1e-4
BF16_TOL = 2e-2
BF16_MODEL_ATOL = 5e-2
# right-padded prompts; capacity 96 > the h2o-danube REDUCED window of 64, and
# the rows decode past position 64, so the sliding window moves
LENS, SEQ, CAPACITY, STEPS = (70, 61), 80, 96, 8


@functools.lru_cache(maxsize=None)
def make_pair(arch, compute_dtype="float32"):
    """(JAX model, JAX params, port model, port params loaded on the CPU)
    with the same weights.  Cached: no test modifies them."""
    cfg_j = dataclasses.replace(jax_get_config(arch, reduced=True), compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(get_config(arch, reduced=True), compute_dtype=compute_dtype)
    mj = jax_build_model(cfg_j)
    pj = mj.init(jax.random.PRNGKey(0))
    mt = build_model(cfg_t, device="cpu")
    pt = mt.load(from_jax_params(cfg_t, jax.tree.map(np.asarray, pj)))
    return mj, pj, mt, pt


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(a, b, tol, atol=None):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol if atol is None else atol, rtol=tol)


def _prompts(vocab, lens, seq):
    """Right-padded prompts [B, seq] of the given true lengths."""
    rng = np.random.default_rng(0)
    toks = rng.integers(1, vocab, (len(lens), seq)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    return toks


def _jax_cache(caches):
    (c,) = caches  # period-1 pattern: one stacked block
    return jax.tree.map(np.asarray, c["mixer"])


@functools.lru_cache(maxsize=None)
def _jax_prefill(mj, impl):
    return jax.jit(lambda p, t, lp: mj.prefill(p, {"tokens": t}, impl=impl, last_pos=lp))


@functools.lru_cache(maxsize=None)
def reference_run(arch, compute_dtype="float32", lens=LENS, ragged=True, impl="xla"):
    """The JAX package's prefill of right-padded prompts (``last_pos``); for
    ``impl="xla"`` also the prompt-cache re-lay and STEPS greedy decode
    steps.  Computed once per configuration and shared by the tests."""
    mj, pj, mt, _ = make_pair(arch, compute_dtype)
    lens = np.array(lens, np.int32)
    toks = _prompts(mt.cfg.vocab, lens, SEQ)
    logits, caches = _jax_prefill(mj, impl)(pj, toks, lens - 1)
    out = dict(toks=toks, lens=lens, prefill_logits=np.asarray(logits),
               prefill_caches=_jax_cache(caches))
    if impl != "xla":
        return out
    caches = mj.prepare_decode_caches(mj.mask_prompt_cache(caches, lens), capacity=CAPACITY)
    out["decode_caches"] = _jax_cache(caches)
    dec = jax.jit(lambda p, c, t, pos: mj.decode_step(p, c, t, pos, ragged=ragged))
    tok, pos = np.array(jnp.argmax(logits[:, 0], axis=-1), np.int32), lens.copy()
    out["feeds"], out["step_logits"] = [], []
    for _ in range(STEPS):
        out["feeds"].append(tok)
        logits, caches = dec(pj, caches, tok[:, None], pos)
        out["step_logits"].append(np.asarray(logits))
        tok, pos = np.array(jnp.argmax(logits[:, 0], axis=-1), np.int32), pos + 1
    out["final_caches"] = _jax_cache(caches)
    return out


def port_run(arch, ref, compute_dtype="float32", ragged=True):
    """The port on the same prompts, decode fed with the reference's tokens."""
    _, _, mt, pt = make_pair(arch, compute_dtype)
    lens = torch.as_tensor(ref["lens"])
    logits, caches = mt.prefill(pt, torch.as_tensor(ref["toks"]), last_pos=lens - 1)
    out = dict(prefill_logits=logits, prefill_caches=caches)
    caches = mt.prepare_decode_caches(mt.mask_prompt_cache(caches, lens), CAPACITY)
    out["decode_caches"] = {n: t.clone() for n, t in caches.items()}
    out["step_logits"], pos = [], lens.long()
    for tok in ref.get("feeds", []):
        step, caches = mt.decode_step(pt, caches, torch.as_tensor(tok[:, None]), pos,
                                      ragged=ragged)
        out["step_logits"].append(step)
        pos = pos + 1
    out["final_caches"] = caches
    return out


def _check_caches(got, want, tol, atol=None):
    np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape  # [layers, B, L, KV, D]
        _close(got[name], want[name], tol, atol)


def _check_decode(ref, got, tol, atol=None):
    """Logits of every step within tolerance, the same greedy token at every
    step, and the same caches at the end."""
    for i, (lt, lj) in enumerate(zip(got["step_logits"], ref["step_logits"])):
        _close(lt, lj, tol, atol)
        if i + 1 < len(ref["feeds"]):
            np.testing.assert_array_equal(lt[:, 0].argmax(-1).numpy(), ref["feeds"][i + 1])
    _check_caches(got["final_caches"], ref["final_caches"], tol, atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced)) == dataclasses.asdict(
            jax_get_config(arch, reduced)
        )


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(arch):
    _, pj, _, _ = make_pair(arch)
    pj = jax.tree.map(np.asarray, pj)
    cfg = get_config(arch, reduced=True)
    pt = from_jax_params(cfg, pj)
    assert len(pt["layers"]) == cfg.n_layers
    assert pt["layers"][0]["mixer"]["w_q"].dtype == torch.float32
    back = to_jax_params(cfg, pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)  # bit-exact


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, impl):
    """Right-padded prefill with ``last_pos`` against both JAX attention
    paths (the Pallas kernel in interpret mode)."""
    ref = reference_run(arch, impl=impl)
    got = port_run(arch, ref)
    assert got["prefill_logits"].shape == (2, 1, get_config(arch, True).vocab)
    _close(got["prefill_logits"], ref["prefill_logits"], FP32_TOL)
    _check_caches(got["prefill_caches"], ref["prefill_caches"], FP32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_cache_relay_matches_reference(arch):
    """``mask_prompt_cache`` + ``prepare_decode_caches``: the same ring, the
    pad entries dropped; and, in a dense model, right padding never reaches
    the last real token's logits.  (In an MoE model it does, in the port as
    in the reference: expert capacity counts the pad tokens of the group.)"""
    ref = reference_run(arch)
    got = port_run(arch, ref)
    _check_caches(got["decode_caches"], ref["decode_caches"], FP32_TOL)
    _, _, mt, pt = make_pair(arch)
    if mt.cfg.moe is not None:
        return
    n = int(ref["lens"][1])
    alone, _ = mt.prefill(pt, torch.as_tensor(ref["toks"][1:, :n]))
    _close(alone[0], got["prefill_logits"][1], FP32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_decode_matches_reference(arch):
    ref = reference_run(arch)
    _check_decode(ref, port_run(arch, ref), FP32_TOL)


def test_lockstep_decode_matches_reference():
    ref = reference_run("internlm2-1.8b", lens=(SEQ, SEQ), ragged=False)
    _check_decode(ref, port_run("internlm2-1.8b", ref, ragged=False), FP32_TOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-32b"])
def test_bf16_prefill_and_decode_match_reference(arch):
    ref = reference_run(arch, "bfloat16")
    got = port_run(arch, ref, "bfloat16")
    assert got["prefill_logits"].dtype == torch.bfloat16
    assert got["final_caches"]["k"].dtype == torch.bfloat16
    _close(got["prefill_logits"], ref["prefill_logits"], BF16_TOL, BF16_MODEL_ATOL)
    for lt, lj in zip(got["step_logits"], ref["step_logits"]):
        _close(lt, lj, BF16_TOL, BF16_MODEL_ATOL)
    _check_caches(got["final_caches"], ref["final_caches"], BF16_TOL, BF16_MODEL_ATOL)


def test_load_casts_weights_once():
    cfg = get_config("internlm2-1.8b", reduced=True)
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    assert params["layers"][0]["ffn"]["w_up"].dtype == torch.float32
    loaded = model.load(params)
    assert loaded["layers"][0]["ffn"]["w_up"].dtype == torch.bfloat16
    assert model.load(loaded)["embed"] is loaded["embed"]  # no second copy
    np.testing.assert_array_equal(
        loaded["lm_head"].float().numpy(), params["lm_head"].to(torch.bfloat16).float().numpy()
    )


def test_unported_families_raise():
    """Every family is ported; what still raises is a config the reference
    cannot build either: an encoder-decoder with no frontend to project its
    frames, MLA layers with no MLA config, SSM layers with no SSM config."""
    cfg = get_config("internlm2-1.8b", reduced=True)
    for bad in (dict(enc_dec=True), dict(attn_type="mla"), dict(attn_period=2)):
        with pytest.raises(NotImplementedError):
            build_model(dataclasses.replace(cfg, **bad), device="cpu")


# ---------------------------------------------------------------- mamba2 (SSM)
# mamba2 has its own cases: SSM state has no positional record, so its
# prompts are prefilled at their exact length (no right padding, no
# ``last_pos``), as the engines do.  S = 40 is below the REDUCED chunk of 256,
# which both JAX impls accept.
SSM = "mamba2-1.3b"
SSM_SEQ = 40


def test_mamba2_config_and_bridge_match_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(SSM, reduced)) == dataclasses.asdict(
            jax_get_config(SSM, reduced))
    _, pj, _, _ = make_pair(SSM)
    pj = jax.tree.map(np.asarray, pj)
    cfg = get_config(SSM, reduced=True)
    pt = from_jax_params(cfg, pj)
    assert len(pt["layers"]) == cfg.n_layers and "ffn" not in pt["layers"][0]
    assert set(pt["layers"][0]["mixer"]) >= {"w_x", "conv_wx", "a_log", "dt_bias", "d_skip"}
    for a, b in zip(jax.tree.leaves(to_jax_params(cfg, pt)), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def ssm_reference_run(compute_dtype="float32", impl="xla"):
    """The JAX package's exact-length prefill of two prompts of SSM_SEQ
    tokens, then (``impl="xla"``) STEPS greedy ragged decode steps."""
    mj, pj, mt, _ = make_pair(SSM, compute_dtype)
    toks = np.random.default_rng(8).integers(1, mt.cfg.vocab, (2, SSM_SEQ)).astype(np.int32)
    logits, caches = jax.jit(lambda p, t: mj.prefill(p, {"tokens": t}, impl=impl))(pj, toks)
    out = dict(toks=toks, prefill_logits=np.asarray(logits), prefill_caches=_jax_cache(caches))
    if impl != "xla":
        return out
    caches = mj.prepare_decode_caches(mj.mask_prompt_cache(caches, SSM_SEQ), capacity=CAPACITY)
    dec = jax.jit(lambda p, c, t, pos: mj.decode_step(p, c, t, pos, ragged=True))
    tok, pos = np.array(jnp.argmax(logits[:, 0], axis=-1), np.int32), np.full(2, SSM_SEQ)
    out["feeds"], out["step_logits"] = [], []
    for _ in range(STEPS):
        out["feeds"].append(tok)
        logits, caches = dec(pj, caches, tok[:, None], pos)
        out["step_logits"].append(np.asarray(logits))
        tok, pos = np.array(jnp.argmax(logits[:, 0], axis=-1), np.int32), pos + 1
    out["final_caches"] = _jax_cache(caches)
    return out


def ssm_port_run(ref, compute_dtype="float32"):
    _, _, mt, pt = make_pair(SSM, compute_dtype)
    logits, caches = mt.prefill(pt, torch.as_tensor(ref["toks"]))
    out = dict(prefill_logits=logits, prefill_caches={n: t.clone() for n, t in caches.items()})
    lens = torch.full((2,), SSM_SEQ)
    caches = mt.prepare_decode_caches(mt.mask_prompt_cache(caches, lens), CAPACITY)
    out["step_logits"], pos = [], lens
    for tok in ref.get("feeds", []):
        step, caches = mt.decode_step(pt, caches, torch.as_tensor(tok[:, None]), pos,
                                      ragged=True)
        out["step_logits"].append(step)
        pos = pos + 1
    out["final_caches"] = caches
    return out


def _check_ssm_caches(got, want, tol, atol=None):
    """conv_x/conv_b/conv_c [layers, B, W-1, C] and h [layers, B, H, P, N]."""
    assert set(got) == set(want) == {"conv_x", "conv_b", "conv_c", "h"}
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == getattr(torch, str(want[name].dtype))
        _close(got[name], want[name], tol, atol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba2_prefill_matches_reference(impl):
    ref = ssm_reference_run(impl=impl)
    got = ssm_port_run(ref)
    assert got["prefill_logits"].shape == (2, 1, get_config(SSM, True).vocab)
    _close(got["prefill_logits"], ref["prefill_logits"], FP32_TOL)
    _check_ssm_caches(got["prefill_caches"], ref["prefill_caches"], FP32_TOL)


def test_mamba2_decode_matches_reference():
    """8 ragged decode steps: logits and greedy tokens at every step, and the
    state at the end; the cache re-lay passes SSM state through."""
    ref = ssm_reference_run()
    got = ssm_port_run(ref)
    for i, (lt, lj) in enumerate(zip(got["step_logits"], ref["step_logits"])):
        _close(lt, lj, FP32_TOL)
        if i + 1 < STEPS:
            np.testing.assert_array_equal(lt[:, 0].argmax(-1).numpy(), ref["feeds"][i + 1])
    _check_ssm_caches(got["final_caches"], ref["final_caches"], FP32_TOL)


def test_mamba2_bf16_prefill_matches_reference():
    """bf16: prefill logits, the state it leaves and the first decode step,
    at the whole-model bf16 tolerance.  Later steps are compared in fp32
    above: the recurrent state carries each step's bf16 rounding on, and the
    logit gap grows to 0.057 by step 6 (4 bf16 ulps at magnitude 3; the
    reference's own XLA and Pallas prefills differ by 0.023 here)."""
    ref = ssm_reference_run("bfloat16")
    got = ssm_port_run(ref, "bfloat16")
    assert got["prefill_logits"].dtype == torch.bfloat16
    assert got["prefill_caches"]["conv_x"].dtype == torch.bfloat16
    assert got["prefill_caches"]["h"].dtype == torch.float32
    _close(got["prefill_logits"], ref["prefill_logits"], BF16_TOL, BF16_MODEL_ATOL)
    _check_ssm_caches(got["prefill_caches"], ref["prefill_caches"], BF16_TOL, BF16_MODEL_ATOL)
    _close(got["step_logits"][0], ref["step_logits"][0], BF16_TOL, BF16_MODEL_ATOL)


def test_mamba2_load_keeps_ssm_constants_in_fp32():
    """``a_log``, ``dt_bias`` and ``d_skip`` are not bf16-exact; the reference
    reads them in fp32, so loading keeps every 1-D leaf in fp32."""
    cfg = get_config(SSM, reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    loaded = model.load(params)
    mixer = loaded["layers"][0]["mixer"]
    assert mixer["w_x"].dtype == torch.bfloat16
    for name in ("a_log", "dt_bias", "d_skip", "norm"):
        assert mixer[name].dtype == torch.float32
        assert torch.equal(mixer[name], params["layers"][0]["mixer"][name])


def test_hybrid_stacks_are_refused_by_name():
    """Hybrid attention/SSM stacks are ported, and so are MLA, frontends and
    encoder-decoders; what the port still refuses, each by name: a stack
    with SSM layers and no SSM config (hybrid and attention-free alike: the
    reference has no SSM parameters to build for it), MLA layers with no
    MLA config and an encoder-decoder with no frontend.  A frontend on a
    dense stack builds."""
    from repro_torch.configs.base import FrontendConfig

    cfg = dataclasses.replace(get_config(SSM, reduced=True), attn_period=2, n_heads=4,
                              n_kv_heads=2)
    assert build_model(cfg, device="cpu").cfg is cfg  # a hybrid with an SSM config builds
    for bad in (dict(ssm=None), dict(attn_period=0, ssm=None)):
        with pytest.raises(NotImplementedError, match="SSM layers without an SSM config"):
            build_model(dataclasses.replace(cfg, **bad), device="cpu")
    dense = get_config("internlm2-1.8b", reduced=True)
    for bad, name in ((dict(attn_type="mla"), "MLA layers without an MLA config"),
                      (dict(enc_dec=True), "encoder-decoder without a frontend")):
        with pytest.raises(NotImplementedError, match=name):
            build_model(dataclasses.replace(dense, **bad), device="cpu")
    vision = dataclasses.replace(dense, frontend=FrontendConfig("vision", 64, 16))
    assert build_model(vision, device="cpu").cfg is vision
