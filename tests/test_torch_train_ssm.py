"""The port's SSM train path against the JAX package's: mamba2's
``train_loss`` and its gradients with both of the reference's ``impl``
paths, block remat over SSM blocks, the ``Trainer``'s loss curve with the
weight decay the reference gives the per-layer 1-D leaves, and the
launcher, on the REDUCED config in fp32 on the CPU, at B 2 and S of 64 or
96.  The chunk is cut to 32 rows so that the chunked scan and its backward
carry a state across chunks.  On the CPU the port differentiates its plain
``ssd_chunked``; the card's backward kernel is held against that in
``tests/test_torch_ssd_scan.py``, ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Weights are made by the JAX package and cross the bridge; gradients cross
back with ``to_jax_params``; inputs come from seeded numpy generators.
Tolerances: the loss 2e-5 relative; each gradient leaf 1e-4 of its largest
value; the loss curve 1e-4 relative and the 1-D leaves 1e-5 absolute."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.bridge import from_jax_params, to_jax_params
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map

ARCH = "mamba2-1.3b"
B, S, CHUNK = 2, 96, 32


@functools.lru_cache(maxsize=None)
def make_pair(remat=True):
    """(JAX model, JAX params, port model): REDUCED mamba2 in fp32, chunks
    of ``CHUNK`` rows."""
    def cut(cfg):
        return dataclasses.replace(cfg, compute_dtype="float32", remat=remat,
                                   ssm=dataclasses.replace(cfg.ssm, chunk_size=CHUNK))

    mj = jax_build_model(cut(jax_get_config(ARCH, reduced=True)))
    pj = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0)))
    return mj, pj, build_model(cut(get_config(ARCH, reduced=True)), device="cpu")


def port_params(model, pj):
    """Fresh fp32 port params that require grad, equal to the JAX ``pj``."""
    return tree_map(lambda t: t.requires_grad_(), from_jax_params(model.cfg, pj))


def batch_of(vocab, b=B, s=S, seed=0):
    return SyntheticLM(vocab=vocab, seq_len=s, global_batch=b, seed=seed).global_batch_arrays(0)


def _grads(model, params, batch, **kw):
    loss, metrics = model.train_loss(params, batch, **kw)
    return loss, metrics, torch.autograd.grad(loss, tree_leaves(params))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ssm_train_loss_and_grads_match_jax(impl):
    """The reference differentiates ``ssd_chunked`` with ``impl="xla"`` and
    the ``ssd`` custom VJP (the Pallas forward in interpret mode, ``jax.vjp``
    of the sequential ``reference_ssd`` backward) with ``impl="pallas"``;
    the port takes its one path, autograd through its plain
    ``ssd_chunked`` on the CPU, whichever ``impl`` it is given.  Every
    gradient leaf within 1e-4 of the reference leaf's largest value."""
    mj, pj, mt = make_pair()
    batch = batch_of(mt.cfg.vocab)
    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        lambda p: mj.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, impl=impl),
        has_aux=True))(pj)
    params = port_params(mt, pj)
    loss, metrics, grads = _grads(mt, params, batch, impl=impl)
    assert float(metrics["aux_loss"]) == float(want_metrics["aux_loss"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=2e-5)
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


def test_ssm_remat_changes_no_gradient_and_recomputes_the_scan(monkeypatch):
    """Block remat on and off: equal loss and gradients; with it, the SSD
    scan runs twice a layer (forward, then the recompute), as
    ``chip_smoke.py`` counts its launches on the card."""
    calls = []
    ssd = ssd_ops.ssd
    monkeypatch.setattr(ssd_ops, "ssd", lambda *a, **k: calls.append(1) or ssd(*a, **k))
    out = {}
    for remat in (False, True):
        _, pj, mt = make_pair(remat)
        calls.clear()
        loss, _, grads = _grads(mt, port_params(mt, pj), batch_of(mt.cfg.vocab, s=64))
        out[remat] = (loss, grads, len(calls))
    n = mt.cfg.n_layers
    assert (out[False][2], out[True][2]) == (n, 2 * n)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssm_trainer_loss_curve_matches_jax():
    """Five steps through both trainers from the same weights.  The SSM
    leaves ``a_log``, ``dt_bias`` and ``d_skip`` and the norm scales are 1-D
    per layer and far from 0, so the curve also holds the weight decay the
    reference gives them on its stacked tree (``Model.decay_mask``):
    without it ``dt_bias`` would end 9e-3 apart, ``a_log`` 4e-3."""
    mj, pj, mt = make_pair()
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    step_j = JaxTrainer(mj, jax_adamw.AdamWConfig(**kw)).jitted_step(donate=False)
    trainer = Trainer(mt, adamw.AdamWConfig(**kw))
    pipe = SyntheticLM(vocab=mt.cfg.vocab, seq_len=64, global_batch=B, seed=0)
    params_j, opt_j = pj, jax_adamw.adamw_init(pj, jax_adamw.AdamWConfig(**kw))
    params_t = port_params(mt, pj)
    opt_t = adamw.adamw_init(params_t, trainer.opt_cfg)
    want, got = [], []
    for i in range(5):
        batch = pipe.global_batch_arrays(i)
        params_j, opt_j, mj_ = step_j(params_j, opt_j,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
        params_t, opt_t, mt_ = trainer.step(params_t, opt_t, batch)
        want.append(float(mj_["loss"]))
        got.append(float(mt_["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    # the per-layer 1-D leaves, [L, d] on the reference's stacked tree
    flat_t = jax.tree.leaves(to_jax_params(mt.cfg, params_t)["decoder"])
    flat_j = jax.tree.leaves(params_j["decoder"])
    assert sum(a.ndim == 2 for a in flat_j) >= 4
    for a, b in zip(flat_j, flat_t):
        if a.ndim == 2:
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)


def test_train_launcher_trains_ssm_on_cpu(capsys):
    train_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "32", "--log-every", "1"])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("step ")]
    assert out.startswith(f"arch={ARCH}") and len(lines) == 3
    assert all(np.isfinite(float(line.split()[3])) for line in lines)
