"""The port's hybrid stack against the JAX package's, on ``jamba-v0.1-52b``
``REDUCED`` (8 layers, d_model 128: one pattern period of 7 Mamba-2 layers
and one attention layer at position 4, MoE FFNs of 4 experts top-2 on the
odd layers and dense SwiGLUs on the even ones): the config, the weight and
cache bridges at one and two pattern repeats, prefill (both JAX paths: XLA,
and the Pallas kernels in interpret mode), the prompt-cache re-lay, ragged
decode, the greedy streams of both engines, the serve launcher and the
``train_loss`` gradients.

Weights are made by the JAX package and cross the bridge; caches cross back
per mixer kind with ``from_jax_caches``; inputs come from seeded numpy
generators.  The reference runs sit in module fixtures that several tests
share, at two prompt lengths (each length is one more JAX compile of the
8-layer stack).  As the engines do, every prompt is prefilled alone at its
exact length (SSM state has no positional record), below the SSD chunk of
256, which both JAX SSD paths require of such a prompt.

Tolerances: fp32 logits and caches 4e-4 abs + rel, the SSD scan's 20 x 2e-5
(``tests/test_kernels.py``): every output below layer 0 has passed through
its state (the observed gap is about 5e-6).  bf16: the whole-model bound,
5e-2 abs + 2e-2 relative to each tensor's largest value, on the first
decode step and on each of its sublayers (``_close_to_largest``).
Gradients: each leaf within 1e-4 of its largest value."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v01_52b as jax_jamba
from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime import serving as jax_serving
from repro_torch.bridge import from_jax_caches, from_jax_params, to_jax_caches, to_jax_params
from repro_torch.configs import jamba_v01_52b as jamba
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.transformer import CACHE_KEYS, mixer_kind
from repro_torch.runtime.serving import ContinuousBatchingEngine, ServingEngine
from repro_torch.tree import tree_leaves, tree_map

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
FP32_TOL = 4e-4
BF16_TOL, BF16_ATOL = 2e-2, 5e-2
LENS = (40, 29)  # the two prompt lengths of the whole file
CAPACITY, STEPS = 64, 5


@functools.lru_cache(maxsize=None)
def _pair(compute_dtype="float32", n_layers=None):
    """(JAX model, JAX params with numpy leaves, port model, port params
    loaded on the CPU): the same weights.  Cached: no test modifies them."""
    over = dict(compute_dtype=compute_dtype)
    if n_layers:
        over["n_layers"] = n_layers
    cfg_j = dataclasses.replace(jax_get_config(ARCH, reduced=True), **over)
    cfg_t = dataclasses.replace(get_config(ARCH, reduced=True), **over)
    mj = jax_build_model(cfg_j)
    pj = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0)))
    mt = build_model(cfg_t, device="cpu")
    return mj, pj, mt, mt.load(from_jax_params(cfg_t, pj))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(a, b, tol, atol=None):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol if atol is None else atol)


def _check_caches(cfg, got, want, tol, atol=None):
    """The port's flat caches against the JAX ones mapped per kind: the
    same keys, shapes and dtypes, and values within tolerance (``pos``
    exactly)."""
    want = from_jax_caches(cfg, want)
    assert set(got) == set(want) == set(CACHE_KEYS["attn"] + CACHE_KEYS["ssm"])
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == getattr(torch, str(w.dtype)), name
        if name == "pos":
            np.testing.assert_array_equal(got[name].numpy(), w)
        else:
            _close(got[name], w, tol, atol)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in LENS]


def _jax_rows(mj, pj, prompts, impl="xla", capacity=None):
    """Each prompt alone through the JAX prefill: logits [B, 1, V] and, per
    row, the prefill caches (and, with ``capacity``, the decode caches)."""
    fn = jax.jit(lambda p, t: mj.prefill(p, {"tokens": t}, impl=impl))
    logits, pre, dec = [], [], []
    for p in prompts:
        lg, c = fn(pj, p[None])
        logits.append(np.asarray(lg))
        pre.append(jax.tree.map(np.asarray, c))
        if capacity:
            dec.append(mj.prepare_decode_caches(mj.mask_prompt_cache(c, len(p)), capacity))
    return np.concatenate(logits), pre, dec


def _cat_rows(caches):
    """JAX per-row caches of one layout -> one batch (batch is the leaves'
    axis 0 at r = 1)."""
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *caches)


@pytest.fixture(scope="module")
def reference(pair):
    """The JAX package on the two prompts: each prefilled alone (XLA), its
    caches re-laid for decode with headroom, then STEPS ragged greedy decode
    steps of the two rows (at positions 40 and 29 onwards)."""
    mj, pj, mt, _ = pair
    prompts = _prompts(mt.cfg.vocab)
    logits, pre, dec = _jax_rows(mj, pj, prompts, capacity=CAPACITY)
    caches = _cat_rows(dec)
    out = dict(prompts=prompts, logits=logits, prefill=pre,
               decode_caches=jax.tree.map(np.asarray, caches), feeds=[], steps=[])
    step = jax.jit(lambda p, c, t, pos: mj.decode_step(p, c, t, pos, ragged=True))
    tok, pos = logits[:, 0].argmax(-1).astype(np.int32), np.array(LENS, np.int32)
    for _ in range(STEPS):
        out["feeds"].append(tok)
        lg, caches = step(pj, caches, tok[:, None], pos)
        out["steps"].append(np.asarray(lg))
        tok, pos = np.asarray(lg)[:, 0].argmax(-1).astype(np.int32), pos + 1
    out["final"] = jax.tree.map(np.asarray, caches)
    return out


def _port_rows(mt, pt, prompts):
    """The port's counterpart of ``_jax_rows`` with a capacity: logits,
    prefill caches per row and the decode caches of the batch, each row
    re-laid alone (as ``KVPool.write`` installs it) and then stacked."""
    logits, pre, dec = [], [], []
    for p in prompts:
        lg, c = mt.prefill(pt, torch.as_tensor(p[None]))
        logits.append(lg)
        pre.append(c)
        dec.append(mt.prepare_decode_caches(mt.mask_prompt_cache(c, len(p)), CAPACITY))
    caches = {n: torch.cat([d[n] for d in dec], dim=1) for n in dec[0]}
    return torch.cat(logits), pre, caches


# ---------------------------------------------------------------- config, bridge
def test_config_matches_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced)) == dataclasses.asdict(
            jax_get_config(ARCH, reduced))
    assert dataclasses.asdict(jamba.CONFIG) == dataclasses.asdict(jax_jamba.CONFIG)
    assert dataclasses.asdict(jamba.REDUCED) == dataclasses.asdict(jax_jamba.REDUCED)
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")  # full width builds (nothing is allocated)
    assert model.cfg.pattern_period() == 8
    kinds = [mixer_kind(cfg, i) for i in range(8)]
    assert kinds == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [cfg.layer_is_moe(i) for i in range(8)] == [False, True] * 4


@pytest.mark.parametrize("n_layers", [8, 16], ids=["r1", "r2"])
def test_bridge_round_trip_params_and_caches(pair, n_layers):
    """Params and caches cross both ways bit-exactly, at one pattern repeat
    and at two (the JAX leaves then repeat-stacked); the port's caches are
    its own ``init_cache`` layout, stacked per kind in layer order."""
    mj, pj, mt, _ = pair if n_layers == 8 else _pair(n_layers=n_layers)
    cfg = mt.cfg
    assert cfg.n_layers // cfg.pattern_period() == n_layers // 8
    pt = from_jax_params(cfg, pj)
    assert len(pt["layers"]) == n_layers
    assert "w_q" in pt["layers"][4]["mixer"] and "w_x" in pt["layers"][3]["mixer"]
    back = to_jax_params(cfg, pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(n_layers)
    caches = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                          if a.dtype != np.int32 else rng.integers(-1, 9, a.shape, np.int32),
                          jax.tree.map(np.asarray, mj.init_cache(2, 12)))
    flat = from_jax_caches(cfg, caches)
    port = build_model(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
    assert {n: t.shape for n, t in flat.items()} == {
        n: tuple(t.shape) for n, t in port.init_cache(2, 12).items()}
    assert flat["k"].shape[0] == n_layers // 8 and flat["h"].shape[0] == 7 * n_layers // 8
    # the attention layers are 4 and 12: repeats 0 and 1 of pattern position 4
    for rep in range(n_layers // 8):
        leaf = caches[4]["mixer"]["k"]
        np.testing.assert_array_equal(flat["k"][rep], leaf[rep] if n_layers > 8 else leaf)
    again = to_jax_caches(cfg, {n: torch.from_numpy(a) for n, a in flat.items()})
    assert jax.tree.structure(again) == jax.tree.structure(caches)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(caches)):
        np.testing.assert_array_equal(a, b)
    # bf16 rows cross as their bits, a uint16 view
    bf16 = {n: torch.from_numpy(a).to(torch.bfloat16) if n in ("k", "v", "conv_x") else
            torch.from_numpy(a) for n, a in flat.items()}
    bits = to_jax_caches(cfg, bf16)
    assert bits[4]["mixer"]["k"].dtype == np.uint16
    back = from_jax_caches(cfg, jax.tree.map(
        lambda a: a.view(jnp.bfloat16) if a.dtype == np.uint16 else a, bits))
    for name, t in bf16.items():
        np.testing.assert_array_equal(back[name].astype(np.float32), t.float().numpy())


def test_two_repeat_prefill_caches_match_reference():
    """Two pattern repeats (16 layers): the JAX prefill scans over them and
    emits every cache leaf repeat-stacked; the port emits each kind's caches
    in layer order, and the two agree layer for layer."""
    mj, pj, mt, pt = _pair(n_layers=16)
    tokens = _prompts(mt.cfg.vocab)[1][None]
    want_logits, want = jax.jit(lambda p, t: mj.prefill(p, {"tokens": t}))(pj, tokens)
    logits, caches = mt.prefill(pt, torch.as_tensor(tokens))
    _close(logits, want_logits, FP32_TOL)
    _check_caches(mt.cfg, caches, jax.tree.map(np.asarray, want), FP32_TOL)


# ---------------------------------------------------------------- prefill, decode
def test_prefill_matches_reference_xla(pair, reference):
    _, _, mt, pt = pair
    logits, pre, _ = _port_rows(mt, pt, reference["prompts"])
    assert logits.shape == (2, 1, mt.cfg.vocab)
    _close(logits, reference["logits"], FP32_TOL)
    for got, want in zip(pre, reference["prefill"]):
        _check_caches(mt.cfg, got, want, FP32_TOL)


def test_prefill_matches_reference_pallas(pair, reference):
    """The JAX package's Pallas path (flash attention and the SSD scan in
    interpret mode) on the first prompt."""
    mj, pj, mt, pt = pair
    prompt = reference["prompts"][:1]
    logits, pre, _ = _jax_rows(mj, pj, prompt, impl="pallas")
    got, caches = mt.prefill(pt, torch.as_tensor(prompt[0][None]), impl="pallas")
    _close(got, logits, FP32_TOL)
    _check_caches(mt.cfg, caches, pre[0], FP32_TOL)


def test_prompt_cache_relay_matches_reference(pair, reference):
    """``mask_prompt_cache`` then ``prepare_decode_caches`` on a cache that
    holds both kinds: the attention ring re-laid to the capacity, the SSM
    leaves passed through as they are."""
    _, _, mt, pt = pair
    prompt = reference["prompts"][0]
    _, caches = mt.prefill(pt, torch.as_tensor(prompt[None]))
    relaid = mt.prepare_decode_caches(mt.mask_prompt_cache(caches, len(prompt)), CAPACITY)
    for name in CACHE_KEYS["ssm"]:
        assert relaid[name] is caches[name]
    assert relaid["k"].shape[2] == CAPACITY
    _, _, dec = _port_rows(mt, pt, reference["prompts"])
    _check_caches(mt.cfg, dec, reference["decode_caches"], FP32_TOL)


def test_ragged_decode_matches_reference(pair, reference):
    """STEPS ragged decode steps of rows at positions 40 and 29 onwards, fed
    the reference's greedy tokens: logits and greedy tokens at every step,
    the caches at the end.  Every layer writes its views of the stacked
    caches in place: the attention layer its ring, the SSM layers their
    state."""
    _, _, mt, pt = pair
    _, _, caches = _port_rows(mt, pt, reference["prompts"])
    ptrs = {n: t.data_ptr() for n, t in caches.items()}
    pos = torch.as_tensor(LENS)
    for i, (tok, want) in enumerate(zip(reference["feeds"], reference["steps"])):
        before = {n: t.clone() for n, t in caches.items()}
        logits, out = mt.decode_step(pt, caches, torch.as_tensor(tok[:, None]), pos, ragged=True)
        assert out is caches and {n: t.data_ptr() for n, t in out.items()} == ptrs
        assert all(not torch.equal(before[n], caches[n]) for n in caches)
        _close(logits, want, FP32_TOL)
        if i + 1 < STEPS:
            np.testing.assert_array_equal(logits[:, 0].argmax(-1).numpy(),
                                          reference["feeds"][i + 1])
        pos = pos + 1
    _check_caches(mt.cfg, caches, reference["final"], FP32_TOL)


def _bf16_tensor(a) -> torch.Tensor:
    """A numpy leaf of the JAX package (bf16 ones included) as a tensor of
    its dtype; bf16 values cross exactly through fp32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close_to_largest(got, want):
    """|got - want| <= 5e-2 + 2e-2 max|want|, element by element."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=BF16_ATOL + BF16_TOL * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_decode_block(cfg, kind, moe):
    """The JAX package's layer of mixer ``kind`` and an MoE or a dense FFN
    in a ragged decode step, its sublayers apart: (h, mixer out, mixer
    cache, h2, ffn out, x out).  One compile per kind of layer."""
    from repro.models import attention as jax_attn
    from repro.models import layers as jax_layers
    from repro.models import moe as jax_moe
    from repro.models import ssm as jax_ssm

    def block(p, x, cache, positions):
        h = jax_layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == "attn":
            out, cache = jax_attn.attention_apply(p["mixer"], h, cfg, positions=positions,
                                                  cache=cache, ragged=True)
        else:
            out, cache = jax_ssm.ssm_apply(p["mixer"], h, cfg, positions=positions, cache=cache)
        x = x + out
        h2 = jax_layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        if moe:
            out2, _ = jax_moe.moe_apply(p["ffn"], h2, cfg)
        else:
            out2 = jax_layers.mlp_apply(p["ffn"], h2, h2.dtype)
        return h, out, cache, h2, out2, x + out2

    return jax.jit(block)


def test_bf16_first_decode_step_matches_reference():
    """bf16 weights and caches: the first ragged decode step after a
    prefill of two prompts, end to end, and one sublayer at a time: each
    norm, mixer (the attention ring, the SSM's conv ring and ``ssd_step``)
    and FFN (MoE at the decode capacity, dense SwiGLU) of the 8 layers given
    the reference's own input and cache (crossed with ``from_jax_caches``).
    Every output and cache leaf within the whole-model bound, its relative
    term taken against the tensor's largest value (``_close_to_largest``).
    Taken element by element the bound is missed on a few logits: the MoE
    layers' outputs reach about 200 here, where a bf16 step is 1, and in
    some elements the top-2 contributions and the residual cancel to a few
    units, so one rounding of a contribution is a gap of a few units in a
    block's output and of several 1e-2 in the logits."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod

    mj, pj, mt, pt = _pair("bfloat16")
    cfg = mt.cfg
    tokens = np.stack([p[:LENS[1]] for p in _prompts(cfg.vocab, seed=3)])
    logits, caches = jax.jit(lambda p, t: mj.prefill(p, {"tokens": t}))(pj, tokens)
    caches = mj.prepare_decode_caches(caches, CAPACITY)
    tok = np.asarray(logits)[:, 0].argmax(-1).astype(np.int32)
    pos = np.full((2, 1), LENS[1], np.int32)
    x = jnp.asarray(pj["embed"]).astype(jnp.bfloat16)[tok[:, None]]
    port_caches = {n: _bf16_tensor(a) for n, a in
                   from_jax_caches(cfg, jax.tree.map(np.asarray, caches)).items()}
    kinds = [mixer_kind(cfg, i) for i in range(cfg.n_layers)]

    def close(got, want):
        want = np.asarray(want)
        assert got.dtype == _bf16_tensor(want).dtype
        _close_to_largest(got, want)

    for i, kind in enumerate(kinds):
        p, layer = pj["decoder"][i], pt["layers"][i]
        h, out, cache, h2, out2, x_next = _jax_decode_block(mj.cfg, kind, cfg.layer_is_moe(i))(
            p, x, caches[i]["mixer"], jnp.asarray(pos))
        close(layers.rms_norm(_bf16_tensor(x), layer["ln1"], cfg.norm_eps), h)
        k = kinds[:i].count(kind)
        mine = {n: port_caches[n][k] for n in CACHE_KEYS[kind]}
        if kind == "attn":
            got, mine = attn_mod.attention_apply(layer["mixer"], _bf16_tensor(h), cfg,
                                                 positions=torch.as_tensor(pos), cache=mine,
                                                 ragged=True)
        else:
            got, mine = ssm_mod.ssm_apply(layer["mixer"], _bf16_tensor(h), cfg, cache=mine)
        close(got, out)
        for name in CACHE_KEYS[kind]:
            close(mine[name], cache[name])
        x2 = _bf16_tensor(x) + _bf16_tensor(out)
        close(layers.rms_norm(x2, layer["ln2"], cfg.norm_eps), h2)
        if cfg.layer_is_moe(i):
            got, _ = moe_mod.moe_apply(layer["ffn"], _bf16_tensor(h2), cfg)
        else:
            got = layers.mlp_apply(layer["ffn"], _bf16_tensor(h2))
        close(got, out2)
        x = x_next

    want_step, _ = jax.jit(lambda p, c, t, q: mj.decode_step(p, c, t, q, ragged=True))(
        pj, caches, tok[:, None], pos[:, 0])
    _, mine = mt.prefill(pt, torch.as_tensor(tokens))
    step, _ = mt.decode_step(pt, mt.prepare_decode_caches(mine, CAPACITY),
                             torch.as_tensor(tok[:, None]), torch.as_tensor(pos[:, 0]),
                             ragged=True)
    assert step.dtype == torch.bfloat16
    _close_to_largest(step, np.asarray(want_step))


# ---------------------------------------------------------------- engines
def test_continuous_engine_matches_reference_greedy_streams(pair):
    """Three requests on two slots, at the fixed ``n_slots`` of both engines
    (expert capacity couples the rows of a decode step): equal greedy fp32
    streams, each prompt prefilled alone at its exact length."""
    mj, pj, mt, pt = pair
    a, b = _prompts(mt.cfg.vocab, seed=5)
    prompts, budgets = [a, b, a[::-1].copy()], [5, 3, 4]
    want = jax_serving.ContinuousBatchingEngine(mj, pj, n_slots=2, max_len=48, seed=0).generate(
        prompts, budgets)
    eng = ContinuousBatchingEngine(mt, pt, n_slots=2, max_len=48, seed=0)
    got = eng.generate(prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert [(g, n) for g, n, _ in eng.metrics.prefill_walls] == [(1, len(p)) for p in prompts]
    eng.pool.check()
    assert set(eng.pool.caches) == set(CACHE_KEYS["attn"] + CACHE_KEYS["ssm"])
    assert eng.pool.n_alloc == eng.pool.n_evict == 3


def test_one_shot_engine_matches_reference_greedy_streams(pair):
    mj, pj, mt, pt = pair
    static = np.stack([p[:LENS[1]] for p in _prompts(mt.cfg.vocab, seed=6)])
    want = jax_serving.ServingEngine(mj, pj, max_len=48).generate(static, 5)
    got = ServingEngine(mt, pt, max_len=48).generate(static, 5)
    np.testing.assert_array_equal(got, want)


def test_launcher_serves_jamba_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--prompt-len", "12", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 ragged requests" in out and "prefills=3" in out
    assert f"{ARCH}: 8 layers" in out


# ---------------------------------------------------------------- training
def test_remat_over_mixed_blocks_changes_no_gradient(pair, monkeypatch):
    """Block remat over a stack whose blocks differ in kind: the same loss
    and gradients with and without it, and with it every block runs its
    mixer and FFN twice (forward, then the recompute): the SSD scan on the
    7 SSM layers, attention on the one attention layer, the expert FFN on
    the 4 MoE layers."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    _, pj, mt, _ = pair
    calls = []
    for mod, name in ((fa_ops, "flash_attention"), (gmm_ops, "expert_ffn"), (ssd_ops, "ssd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name, **k: calls.append(name)
                            or fn(*a, **k))
    batch = SyntheticLM(vocab=mt.cfg.vocab, seq_len=16, global_batch=2,
                        seed=1).global_batch_arrays(0)
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(mt.cfg, remat=remat), device="cpu")
        params = tree_map(lambda t: t.requires_grad_(), from_jax_params(model.cfg, pj))
        calls.clear()
        loss, _ = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[remat] = (loss.detach(), grads, sorted(calls))
    per_pass = {"ssd": 7, "flash_attention": 1, "expert_ffn": 4}
    for remat, (_, _, made) in out.items():
        assert made == sorted(n for n, k in per_pass.items() for _ in range((1 + remat) * k))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_loss_and_grads_match_jax(pair):
    """``train_loss`` of a hybrid (opened by this slice): the loss, the MoE
    layers' load-balancing loss and every gradient leaf against
    ``jax.value_and_grad`` of the reference's, each leaf within 1e-4 of its
    largest value."""
    mj, pj, mt, _ = pair
    batch = SyntheticLM(vocab=mt.cfg.vocab, seq_len=32, global_batch=2,
                        seed=0).global_batch_arrays(0)
    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        lambda p: mj.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(pj)
    params = tree_map(lambda t: t.requires_grad_(), from_jax_params(mt.cfg, pj))
    loss, metrics = mt.train_loss(params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=2e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()),
                               float(want_metrics["aux_loss"]), rtol=2e-5)
    assert float(want_metrics["aux_loss"]) > 0
    it = iter(grads)
    got = to_jax_params(mt.cfg, tree_map(lambda _: next(it), params))
    flat_w, flat_g = jax.tree.leaves(want_grads), jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    for w, g in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert w.shape == g.shape
        scale = float(np.abs(w).max())
        assert scale > 0
        np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0)
