"""The port's train path against the JAX package's: the loss, AdamW and its
schedule and weight-decay mask, the synthetic data, the flash attention
backward, ``train_loss`` and its gradients (dense and MoE stacks, the MoE
load-balancing loss included), block remat, microbatching, the ``Trainer``
and the launcher, on the REDUCED configs in fp32 on the CPU.  The SSM
stack's training is in ``tests/test_torch_train_ssm.py``.

Weights are made by the JAX package and cross the bridge; gradients cross
back with ``to_jax_params``; inputs come from seeded numpy generators.
Tolerances: the loss 2e-5 (relative for a whole model); the optimizer 1e-6;
the flash VJP 1e-4 (``tests/test_kernels.py``); each gradient leaf 1e-4 of
its largest value (the two frameworks sum the same products in other orders
through 4 layers and a backward pass); the loss curve 1e-4 relative."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig
from repro.configs.base import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.models import build_model as jax_build_model
from repro.models.layers import cross_entropy_loss as jax_cross_entropy_loss
from repro.optim import adamw as jax_adamw
from repro.optim.adamw import _decay_mask as jax_decay_mask
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.bridge import from_jax_params, to_jax_params
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.runtime.trainer import Trainer, value_and_grads

DENSE = ["internlm2-1.8b", "h2o-danube-1.8b", "qwen3-32b"]
MOE = ["granite-moe-1b-a400m", "olmoe-1b-7b"]
SSM = "mamba2-1.3b"
B, S = 2, 96  # S > the h2o-danube REDUCED window of 64

# Two intra-op threads per process.  Under pytest-xdist every worker imports
# this module, so the cap holds in all of them: six workers of torch's
# default (one thread per core) oversubscribe the cores, and the suite's
# wall-clock-sensitive tests then fail under the load.
torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@functools.lru_cache(maxsize=None)
def make_pair(arch, remat=True):
    """(JAX model, JAX params, port model) in fp32 with the same config."""
    cfg_j = dataclasses.replace(jax_get_config(arch, reduced=True), compute_dtype="float32",
                                remat=remat)
    cfg_t = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32",
                                remat=remat)
    mj = jax_build_model(cfg_j)
    pj = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0)))
    return mj, pj, build_model(cfg_t, device="cpu")


def port_params(model, pj):
    """Fresh fp32 port params that require grad, equal to the JAX ``pj``."""
    return tree_map(lambda t: t.requires_grad_(), from_jax_params(model.cfg, pj))


def batch_of(vocab, b=B, s=S, seed=0):
    pipe = SyntheticLM(vocab=vocab, seq_len=s, global_batch=b, seed=seed)
    return pipe.global_batch_arrays(0)


# ---------------------------------------------------------------- loss
@pytest.mark.parametrize("mask_kind", ["ones", "ragged", "zeros"])
def test_cross_entropy_loss_matches_jax(mask_kind):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 17, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (3, 17)).astype(np.int32)
    mask = {"ones": np.ones((3, 17)), "ragged": rng.random((3, 17)) < 0.6,
            "zeros": np.zeros((3, 17))}[mask_kind].astype(np.float32)
    want = jax_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    if mask_kind == "zeros":
        assert float(got) == 0.0


# ---------------------------------------------------------------- optimizer
def test_cosine_schedule_matches_jax():
    cfg_t = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    cfg_j = jax_adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    for t in (0, 5, 10, 55, 100):
        want = float(jax_adamw.cosine_schedule(cfg_j, jnp.asarray(t)))
        assert adamw.cosine_schedule(cfg_t, t) == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_adamw_update_matches_jax_with_clipping():
    """Three steps on 2-D and 1-D leaves (decayed and not), gradients large
    enough that the clip at norm 1 scales them every step."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "layers": [{"scale": (5,), "proj": (5, 3)}], "bias": (3,)}
    p0 = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: 4 * rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    kw = dict(lr=0.05, weight_decay=0.1, warmup_steps=2, total_steps=10)
    cfg_j, cfg_t = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    pj, sj = p0, jax_adamw.adamw_init(p0, cfg_j)
    pt = tree_map(lambda a: torch.tensor(a), p0)
    st = adamw.adamw_init(pt, cfg_t)
    for g in grads:
        pj, sj, mj = jax_adamw.adamw_update(pj, g, sj, cfg_j)
        pt, st, mt = adamw.adamw_update(pt, tree_map(torch.tensor, g), st, cfg_t,
                                        tree_map(adamw._decay_mask, pt))
        assert float(mj["grad_norm"]) > cfg_t.clip_norm
        np.testing.assert_allclose(_np(mt["grad_norm"]), np.asarray(mj["grad_norm"]), rtol=1e-6)
        assert mt["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
    assert st["step"] == int(sj["step"]) == 3
    for a, b in zip(jax.tree.leaves(pj), tree_leaves(pt)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(sj[key]), tree_leaves(st[key])):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_adamw_decreases_loss_quadratic():
    params = {"w": torch.tensor([3.0, -2.0], requires_grad=True),
              "scale": torch.ones(2, requires_grad=True)}
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100)
    state = adamw.adamw_init(params, cfg)

    def loss(p):
        return (p["w"] ** 2).sum() + ((p["scale"] - 1.0) ** 2).sum()

    l0 = float(loss(params).detach())
    for _ in range(50):
        g = torch.autograd.grad(loss(params), list(params.values()))
        params, state, _ = adamw.adamw_update(params, dict(zip(params, g)), state, cfg,
                                              tree_map(adamw._decay_mask, params))
    assert float(loss(params).detach()) < 0.1 * l0


# ---------------------------------------------------------------- data
def test_synthetic_lm_batches_equal_jax():
    kw = dict(vocab=512, seq_len=40, global_batch=4, seed=3)
    a, b = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    for step in (0, 7):
        x, y = a.global_batch_arrays(step), b.global_batch_arrays(step)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
    np.testing.assert_array_equal(a.host_batch(2, 1, 2)["tokens"], b.host_batch(2, 1, 2)["tokens"])


# ---------------------------------------------------------------- flash backward
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_vjp_matches_jax(causal, window):
    """The port's autograd function on the CPU against the JAX package's
    custom VJP around the Pallas kernel (interpret mode), at
    ``tests/test_kernels.py``'s shapes."""
    rng = np.random.default_rng(5)
    b, s, h, kv, d = 1, 128, 4, 2, 32
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, kv, kv))
    cot = rng.normal(size=(b, s, h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(
        q_, k_, v_, causal=causal, window=window, block_q=64, block_k=64, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(cot))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for g, w, x in zip(got, want, leaves):
        assert g.dtype == x.dtype
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- train_loss
@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    mj, pj, _ = make_pair(arch)
    batch = {k: jnp.asarray(v) for k, v in batch_of(mj.cfg.vocab).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: mj.train_loss(p, batch, impl="xla"), has_aux=True))(pj)
    return float(loss), float(metrics["aux_loss"]), jax.tree.map(np.asarray, grads)


def _assert_grads_match(mt, params, grads, want_grads):
    """Every gradient leaf within 1e-4 of the reference leaf's largest value."""
    it = iter(grads)
    got = to_jax_params(mt.cfg, tree_map(lambda _: next(it), params))
    flat_w, flat_g = jax.tree.leaves(want_grads), jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    for w, g in zip(flat_w, flat_g):
        assert w.shape == g.shape
        scale = float(np.abs(w).max())
        assert scale > 0
        np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_grads_match_jax(arch):
    mj, pj, mt = make_pair(arch)
    want_loss, want_aux, want_grads = _jax_value_and_grad(arch)
    params = port_params(mt, pj)
    loss, metrics = mt.train_loss(params, batch_of(mt.cfg.vocab))
    assert float(metrics["aux_loss"]) == want_aux == 0.0
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=2e-5)
    _assert_grads_match(mt, params, torch.autograd.grad(loss, tree_leaves(params)), want_grads)


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_loss_and_grads_match_jax(arch):
    """MoE stacks: the loss is the cross entropy plus 0.01 x the
    load-balancing loss summed over the layers, ``metrics["aux_loss"]``
    equals the reference's, and every gradient (the router's through both
    the gate weights and the aux loss, the experts' through the grouped
    matmul's backward) matches ``jax.value_and_grad``."""
    mj, pj, mt = make_pair(arch)
    want_loss, want_aux, want_grads = _jax_value_and_grad(arch)
    params = port_params(mt, pj)
    loss, metrics = mt.train_loss(params, batch_of(mt.cfg.vocab))
    aux = float(metrics["aux_loss"].detach())
    assert aux > 0
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    torch.testing.assert_close(loss, metrics["loss"] + 0.01 * metrics["aux_loss"], rtol=0, atol=0)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=2e-5)
    _assert_grads_match(mt, params, torch.autograd.grad(loss, tree_leaves(params)), want_grads)


def test_remat_changes_no_gradient_and_recomputes_attention(monkeypatch):
    """Block remat on and off: equal loss and gradients; with it, the flash
    forward runs twice a layer (forward, then the recompute)."""
    calls = []
    forward = fa_ops._forward
    monkeypatch.setattr(fa_ops, "_forward", lambda *a: calls.append(1) or forward(*a))
    out = {}
    for remat in (False, True):
        _, pj, mt = make_pair("internlm2-1.8b", remat=remat)
        params = port_params(mt, pj)
        calls.clear()
        loss, _ = mt.train_loss(params, batch_of(mt.cfg.vocab))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[remat] = (loss, grads, len(calls))
    n = mt.cfg.n_layers
    assert (out[False][2], out[True][2]) == (n, 2 * n)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _count_gmm(monkeypatch):
    """A list that grows by one at every ``gmm`` call (forward products)."""
    calls = []
    gmm = gmm_ops.gmm
    monkeypatch.setattr(gmm_ops, "gmm", lambda x, w: calls.append(1) or gmm(x, w))
    return calls


@pytest.mark.parametrize("rank", range(4))
def test_local_rows_are_the_ranks_block_of_each_global_microbatch(rank):
    """The reference slices its global batch into microbatches and splits
    each over the data-parallel axes (an MoE layer routes the rows of one
    such slice together): a rank's rows, microbatch by microbatch, are its
    (pod, data) block of each slice; with one microbatch its block of the
    batch."""
    from repro_torch.runtime.trainer import local_rows

    mesh = Mesh(("pod", "data", "model"), (2, 2, 1), rank, {}, "none")
    batch = {"tokens": np.arange(16 * 3).reshape(16, 3), "targets": torch.arange(16)}
    got = local_rows(batch, mesh, microbatches=2)
    block = np.arange(2 * rank, 2 * rank + 2)
    want = np.concatenate([block, 8 + block])
    np.testing.assert_array_equal(got["targets"].numpy(), want)
    np.testing.assert_array_equal(got["tokens"], batch["tokens"][want])
    one = local_rows(batch, mesh)["targets"].numpy()
    np.testing.assert_array_equal(one, np.arange(4 * rank, 4 * rank + 4))
    with pytest.raises(ValueError, match="microbatches"):
        local_rows(batch, mesh, microbatches=3)


@pytest.mark.parametrize("arch,name", [("granite-moe-1b-a400m", "MoE"), ("mamba2-1.3b", "SSM")])
def test_train_loss_refuses_moe_and_ssm_stacks(arch, name):
    """MoE and SSM stacks train (the grouped matmul and the SSD scan have
    their backward): a finite loss, with a positive load-balancing loss on
    MoE, and a finite gradient that reaches every leaf.  What ``train_loss``
    refuses on them is an ``impl`` that is neither of the reference's; a
    model axis runs (on ranks: ``tests/test_torch_train_mesh.py``), and one
    of size 1 changes nothing."""
    model = build_model(get_config(arch, reduced=True), device="cpu")
    params = tree_map(lambda t: t.requires_grad_(), model.init(torch.Generator().manual_seed(0)))
    batch = batch_of(model.cfg.vocab, s=16)
    with pytest.raises(NotImplementedError, match="impl"):
        model.train_loss(params, batch, impl="triton")
    loss, metrics = model.train_loss(params, batch)
    one, _ = model.train_loss(params, batch, mesh=Mesh(("data", "model"), (1, 1), 0, {}, "none"))
    assert torch.equal(one, loss)
    assert bool(torch.isfinite(loss))
    assert (float(metrics["aux_loss"].detach()) > 0) == (name == "MoE")
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert all(bool(torch.isfinite(g).all()) and bool(g.any()) for g in grads)


def test_moe_remat_changes_no_gradient_and_recomputes_the_experts(monkeypatch):
    """granite with block remat on and off: equal loss and gradients; with
    it, the three grouped matmuls of each layer run twice (forward, then the
    recompute), which routes the same tokens to the same buckets."""
    calls = _count_gmm(monkeypatch)
    out = {}
    for remat in (False, True):
        _, pj, mt = make_pair("granite-moe-1b-a400m", remat=remat)
        params = port_params(mt, pj)
        calls.clear()
        loss, _ = mt.train_loss(params, batch_of(mt.cfg.vocab))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[remat] = (loss, grads, len(calls))
    n = mt.cfg.n_layers
    assert (out[False][2], out[True][2]) == (3 * n, 6 * n)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_moe_microbatches_route_each_slice_alone():
    """With microbatches each slice routes its own tokens, at the capacity
    of its own size, as the reference's microbatch scan does: the step's
    gradients are the mean of the slices' own, and its loss the mean of
    their cross entropies."""
    _, pj, mt = make_pair("granite-moe-1b-a400m")
    batch = batch_of(mt.cfg.vocab, b=4, s=32, seed=2)
    params = port_params(mt, pj)
    grads, metrics = value_and_grads(mt, params, batch, microbatches=2)
    halves = [value_and_grads(mt, params, {k: v[i:i + 2] for k, v in batch.items()})
              for i in (0, 2)]
    for g, a, b in zip(tree_leaves(grads), tree_leaves(halves[0][0]), tree_leaves(halves[1][0])):
        torch.testing.assert_close(g, (a + b) / 2, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(metrics["loss"]),
                               (float(halves[0][1]["loss"]) + float(halves[1][1]["loss"])) / 2,
                               rtol=1e-6)


# ---------------------------------------------------------------- trainer
def test_microbatched_grads_match_full_batch():
    _, pj, mt = make_pair("internlm2-1.8b")
    batch = batch_of(mt.cfg.vocab, b=8, s=32, seed=1)
    out = []
    for m in (1, 4):
        trainer = Trainer(mt, adamw.AdamWConfig(lr=1e-3), microbatches=m)
        params = port_params(mt, pj)
        params, _, metrics = trainer.step(params, adamw.adamw_init(params, trainer.opt_cfg),
                                          batch)
        out.append((params, metrics["loss"]))
    (p1, l1), (p2, l2) = out
    d = max(float((a - b).detach().abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 5e-5, d
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        value_and_grads(mt, p1, batch, microbatches=3)


def test_trainer_loss_curve_matches_jax():
    """Five steps of ``SyntheticLM`` batches through both trainers from the
    same weights."""
    mj, pj, mt = make_pair("internlm2-1.8b")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    step_j = JaxTrainer(mj, jax_adamw.AdamWConfig(**kw)).jitted_step(donate=False)
    trainer = Trainer(mt, adamw.AdamWConfig(**kw))
    pipe = SyntheticLM(vocab=mt.cfg.vocab, seq_len=64, global_batch=4, seed=0)
    params_j, opt_j = pj, jax_adamw.adamw_init(pj, jax_adamw.AdamWConfig(**kw))
    params_t = port_params(mt, pj)
    opt_t = adamw.adamw_init(params_t, trainer.opt_cfg)
    want, got = [], []
    for i in range(5):
        batch = pipe.global_batch_arrays(i)
        params_j, opt_j, mj_ = step_j(params_j, opt_j, {k: jnp.asarray(v) for k, v in batch.items()})
        params_t, opt_t, mt_ = trainer.step(params_t, opt_t, batch)
        want.append(float(mj_["loss"]))
        got.append(float(mt_["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_moe_trainer_loss_curve_matches_jax():
    """granite-moe over five steps: both trainers report the cross entropy
    (the minimised loss adds 0.01 x the load-balancing loss).  The port's
    Trainer takes each step from the reference Trainer's params and
    optimizer state.  Left to run alone, the two trajectories part: a
    gradient element near 1e-7, what remains of larger terms that cancel,
    can differ by a third between the frameworks' roundings, and AdamW moves
    every weight by about lr whatever its gradient's size, so one step puts
    weights 1.7e-4 apart; four steps later a routing decision near a tie
    flips and the losses part by 3.5e-4 (the dense curve, smooth in its
    weights, stays within 1e-6).  Each step's loss, gradient norm and update
    are the port's own."""
    mj, pj, mt = make_pair("granite-moe-1b-a400m")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    step_j = JaxTrainer(mj, jax_adamw.AdamWConfig(**kw)).jitted_step(donate=False)
    trainer = Trainer(mt, adamw.AdamWConfig(**kw))
    pipe = SyntheticLM(vocab=mt.cfg.vocab, seq_len=64, global_batch=4, seed=0)
    params_j, opt_j = pj, jax_adamw.adamw_init(pj, jax_adamw.AdamWConfig(**kw))
    want, got = [], []
    for i in range(5):
        batch = pipe.global_batch_arrays(i)
        params_t = port_params(mt, jax.tree.map(np.asarray, params_j))
        opt_t = {"step": int(opt_j["step"]), "m": from_jax_params(mt.cfg, opt_j["m"]),
                 "v": from_jax_params(mt.cfg, opt_j["v"])}
        params_j, opt_j, mj_ = step_j(params_j, opt_j,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
        params_t, opt_t, mt_ = trainer.step(params_t, opt_t, batch)
        want.append((float(mj_["loss"]), float(mj_["grad_norm"])))
        got.append((float(mt_["loss"]), float(mt_["grad_norm"])))
        assert opt_t["step"] == int(opt_j["step"]) == i + 1
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1][0] < got[0][0]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m", SSM,
                                  "jamba-v0.1-52b"])
def test_decay_mask_matches_the_reference_on_its_stacked_tree(arch):
    """The reference's ``_decay_mask`` (``ndim >= 2``) on its own tree, where
    the layers are stacked over the pattern's repeats, equals
    ``Model.decay_mask`` leaf by leaf; with one layer nothing is stacked and
    the 1-D leaves are not decayed.  jamba's pattern (attention every 8th
    layer, MoE on the odd ones) has a period of 8: REDUCED's 8 layers are
    one period, not stacked, and 16 layers stack two."""
    for n_layers in (None, 1) + ((16,) if arch == "jamba-v0.1-52b" else ()):
        mj, pj, mt = make_pair(arch)
        if n_layers:
            cfg_j = dataclasses.replace(mj.cfg, n_layers=n_layers)
            pj = jax.tree.map(np.asarray, jax_build_model(cfg_j).init(jax.random.PRNGKey(0)))
            mt = build_model(dataclasses.replace(mt.cfg, n_layers=n_layers), device="cpu")
        mask = mt.decay_mask(from_jax_params(mt.cfg, pj))
        got = to_jax_params(mt.cfg, tree_map(lambda d: torch.tensor(d), mask))
        want = jax.tree.map(lambda a: bool(jax_decay_mask(a)), pj)
        flat = [np.asarray(g) for g in jax.tree.leaves(got)]  # one bool per layer of a leaf
        assert all(g.all() == g.any() for g in flat)
        assert [bool(g.all()) for g in flat] == jax.tree.leaves(want)
        if n_layers == 1:
            assert not mask["layers"][0]["ln1"]
        elif arch == SSM:
            assert mask["layers"][0]["mixer"]["a_log"] and mask["layers"][0]["mixer"]["dt_bias"]
        elif arch == "jamba-v0.1-52b":  # layer 0 is Mamba-2; its a_log stacks at 16 layers
            assert mask["layers"][0]["mixer"]["a_log"] == (n_layers == 16)


def test_trainer_refuses_a_mesh_and_a_parallel_config():
    """A trainer on a model axis above 1 knows, once made, the dim each
    leaf is split at, from the leaves' shapes alone: the dims of the whole
    params drawn.  Its ``init`` draws the whole params and keeps this
    rank's blocks (rank 1 of a model axis of 2 here, no collective
    needed).  A ``ParallelConfig`` without a mesh runs the plain step, as
    in the reference; meshes are tested on ranks in
    ``tests/test_torch_parallel_train.py`` and
    ``tests/test_torch_train_mesh.py``."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.sharding import model_dims

    _, _, mt = make_pair("internlm2-1.8b")
    tp = Mesh(("data", "model"), (1, 2), 1, {}, "gloo")
    trainer = Trainer(mt, adamw.AdamWConfig(), mesh=tp)
    whole = mt.init(torch.Generator().manual_seed(0))
    assert trainer.dims == model_dims(mt.param_axes(), whole, tp)
    assert callable(trainer.step) and trainer.jitted_step() is trainer.step
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    assert trainer.dims["layers"][0]["mixer"]["w_q"] == 1
    assert trainer.dims["layers"][0]["ffn"]["w_down"] == 0
    assert trainer.dims["final_norm"] is None
    cols = params["layers"][0]["mixer"]["w_q"].shape[1]
    assert torch.equal(params["layers"][0]["mixer"]["w_q"],
                       whole["layers"][0]["mixer"]["w_q"][:, cols:])
    assert opt["m"]["layers"][0]["mixer"]["w_q"].shape == params["layers"][0]["mixer"]["w_q"].shape
    assert trainer.checkpoint_dims() == (trainer.dims, {"m": trainer.dims, "v": trainer.dims})
    _, _, moe = make_pair("granite-moe-1b-a400m")
    Trainer(moe, adamw.AdamWConfig(), mesh=Mesh(("data", "model"), (1, 1), 0, {}, "gloo"))
    trainer = Trainer(mt, adamw.AdamWConfig(), ParallelConfig(hierarchical_grad_sync=True))
    assert trainer.jitted_step() is trainer.step


def test_train_launcher_runs_on_cpu(capsys):
    train_launcher.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "32", "--log-every", "1"])
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("step ")]
    assert len(lines) == 3 and all("loss" in l and "gnorm" in l and "lr" in l for l in lines)
    assert "tokens/s" in out and "not measured (cpu)" in out


def test_train_launcher_trains_moe_on_cpu(capsys):
    train_launcher.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "32", "--log-every", "1",
                         "--microbatches", "2"])
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("step ")]
    assert out.startswith("arch=granite-moe-1b-a400m") and len(lines) == 3
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
