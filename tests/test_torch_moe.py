"""The port's MoE layer against the JAX package's single-device path:
routing (ties included), dispatch slots (capacity drops included) and
``moe_local`` against the JAX ``moe_local`` under both its expert paths
(XLA einsums, and the Pallas grouped matmul in interpret mode), and its
gradients, the load-balancing loss's included, against ``jax.grad`` of it.

Weights are made by the JAX package; inputs come from a seeded numpy
generator.  Experts and slots must be equal exactly; outputs agree within
2e-5 in fp32 (the per-kernel fp32 tolerance of ``tests/test_kernels.py``;
the two frameworks sum the same products in different orders) and, in bf16,
within 2e-2 of the outputs' largest magnitude (the two frameworks round the
SwiGLU product, of magnitude up to ~30 here, at different places, and the
down projection sums those roundings).  Gradients agree within 1e-4 of each
leaf's largest magnitude, as ``tests/test_torch_train.py`` holds them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.layers import Initializer
from repro_torch.configs.base import get_config
from repro_torch.models import moe

D, T = 64, 64


def _cfgs(arch="olmoe-1b-7b", compute_dtype="float32", **over):
    """(JAX config, port config): the arch's REDUCED config at width D, with
    MoE fields overridden as in ``tests/test_moe.py``."""
    fields = dict(n_experts=8, top_k=2, d_expert_ff=32, capacity_factor=8.0)
    fields.update(over)
    out = []
    for get in (jax_get_config, get_config):
        base = get(arch, reduced=True)
        out.append(dataclasses.replace(base, d_model=D, compute_dtype=compute_dtype,
                                       moe=dataclasses.replace(base.moe, **fields)))
    return out


def _params(cfg_j, seed=0):
    """JAX params and the same values as torch tensors."""
    pj, _ = jax_moe.moe_init(Initializer(jax.random.PRNGKey(seed)), cfg_j, jnp.float32)
    return pj, {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}


def _x(t=T, seed=3, dtype="float32"):
    a = np.random.default_rng(seed).normal(size=(t, D)).astype(np.float32)
    xj = jnp.asarray(a, getattr(jnp, dtype))
    return xj, torch.from_numpy(np.array(xj, np.float32)).to(getattr(torch, dtype))


def test_router_topk_breaks_ties_as_jax():
    """Exact ties go to the lower expert index, as ``jax.lax.top_k`` does
    (``torch.topk`` would return experts [2, 4] for the first row)."""
    logits = np.log(np.array([[.1, .3, .3, .2, .3, .1], [.2, .2, .2, .2, .1, .1]], np.float32))
    eye = np.eye(6, dtype=np.float32)  # router = identity: logits pass through
    wj, ej, aux_j = jax_moe.router_topk(jnp.asarray(eye), jnp.asarray(logits), 2)
    wt, et, aux_t = moe.router_topk(torch.from_numpy(eye), torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(et.numpy(), [[1, 2], [0, 1]])
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-7)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


def test_router_topk_matches_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j)
    xj, xt = _x()
    wj, ej, aux_j = jax_moe.router_topk(pj["router"], xj, 2)
    wt, et, aux_t = moe.router_topk(pt["router"], xt, 2)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=2e-5)
    np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_dispatch_slots_equal_reference(capacity_factor):
    """Slots equal exactly, capacity drops (-1) included."""
    rng = np.random.default_rng(5)
    experts = rng.integers(0, 8, (T, 2)).astype(np.int32)
    experts[:, 1] = (experts[:, 0] + 1 + rng.integers(0, 7, T)) % 8  # distinct per token
    cap = max(int(capacity_factor * T * 2 / 8), 2)
    fj, sj = jax_moe._dispatch_indices(jnp.asarray(experts), 2, 8, cap)
    ft, st = moe._dispatch_indices(torch.from_numpy(experts).long(), cap)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if capacity_factor != 1.25:  # 8.0 never binds, 0.25 always does
        assert (st.numpy() < 0).any() == (capacity_factor == 0.25)
    assert moe.capacity(_cfgs(capacity_factor=capacity_factor)[1], T) == cap


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_moe_local_matches_reference(impl, capacity_factor):
    """Through both of the JAX package's expert paths; at 0.25 tokens are
    dropped, and the rows the reference zeroes are zero here too."""
    cfg_j, cfg_t = _cfgs(capacity_factor=capacity_factor)
    pj, pt = _params(cfg_j)
    xj, xt = _x()
    want, aux_j = jax_moe.moe_local(pj, xj, cfg_j, impl=impl)
    got, aux_t = moe.moe_local(pt, xt, cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    zero_rows = (got == 0).all(-1).numpy()
    np.testing.assert_array_equal(zero_rows, np.asarray(jnp.all(want == 0.0, axis=-1)))
    if capacity_factor != 1.25:  # 8.0 never binds, 0.25 always does
        assert zero_rows.any() == (capacity_factor == 0.25)


def _leaf_close(got, want, rel=1e-4):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_moe_local_grads_match_reference(impl, capacity_factor):
    """Gradients of ``sum(out * cot) + aux`` with respect to the router, the
    three expert weights and the tokens, through both of the JAX package's
    expert paths (the Pallas path's backward runs its kernel in interpret
    mode); each leaf within 1e-4 of its largest value."""
    cfg_j, cfg_t = _cfgs(capacity_factor=capacity_factor)
    pj, pt = _params(cfg_j)
    xj, xt = _x()
    cot = np.random.default_rng(6).normal(size=(T, D)).astype(np.float32)

    def loss_j(p, x):
        out, aux = jax_moe.moe_local(p, x, cfg_j, impl=impl)
        return jnp.sum(out * cot) + aux

    want_p, want_x = jax.grad(loss_j, argnums=(0, 1))(pj, xj)
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    x = xt.clone().requires_grad_()
    out, aux = moe.moe_local(leaves, x, cfg_t)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum() + aux,
                              [*leaves.values(), x])
    for name, g in zip(leaves, got):
        _leaf_close(g, want_p[name])
    _leaf_close(got[-1], want_x)


def test_aux_loss_gradient_reaches_the_router():
    """The load-balancing loss alone: equal to the reference's, and its
    gradient (through the router's probabilities; the top expert's one-hot
    is constant) equal to ``jax.grad`` of the reference's, for the router
    and the tokens, and zero for the expert weights."""
    cfg_j, cfg_t = _cfgs(capacity_factor=1.25)
    pj, pt = _params(cfg_j)
    xj, xt = _x()
    aux_j, (g_router, g_x) = jax.value_and_grad(
        lambda r, x: jax_moe.moe_local({**pj, "router": r}, x, cfg_j)[1], argnums=(0, 1))(
        pj["router"], xj)
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    x = xt.clone().requires_grad_()
    _, aux = moe.moe_local(leaves, x, cfg_t)
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), rtol=1e-5)
    got = torch.autograd.grad(aux, [*leaves.values(), x], allow_unused=True,
                              materialize_grads=True)
    grads = dict(zip(leaves, got))
    _leaf_close(grads["router"], g_router)
    _leaf_close(got[-1], g_x)
    for name in ("w_gate", "w_up", "w_down"):
        assert not grads[name].any()


def test_moe_local_bf16_matches_reference():
    cfg_j, cfg_t = _cfgs("granite-moe-1b-a400m", compute_dtype="bfloat16", capacity_factor=1.25)
    pj, pt = _params(cfg_j)
    xj, xt = _x(dtype="bfloat16")
    want, _ = jax_moe.moe_local(pj, xj, cfg_j, impl="xla")
    got, _ = moe.moe_local({k: v.bfloat16() for k, v in pt.items()}, xt, cfg_t)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2 * np.abs(want).max(), rtol=0)


def test_moe_apply_keeps_batch_layout():
    cfg_j, cfg_t = _cfgs()
    _, pt = _params(cfg_j)
    _, xt = _x()
    out, aux = moe.moe_apply(pt, xt.reshape(4, T // 4, D), cfg_t)
    flat, aux_flat = moe.moe_local(pt, xt, cfg_t)
    assert out.shape == (4, T // 4, D)
    np.testing.assert_array_equal(out.reshape(T, D).numpy(), flat.numpy())
    assert float(aux) == float(aux_flat)


def test_init_keeps_reference_fan_in():
    """Expert weights [E, D, F] take E as fan-in (``dense_init``'s rule for
    any rank >= 2), so their std is 1/sqrt(E), as in the JAX package."""
    cfg = get_config("granite-moe-1b-a400m")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert_ff
    assert p["router"].shape == (d, e) and p["w_gate"].shape == (e, d, f)
    assert p["w_down"].shape == (e, f, d)
    # truncated at 2 sigma: std of the standard part is ~0.88
    np.testing.assert_allclose(p["w_up"].std().item(), 0.88 / np.sqrt(e), rtol=0.02)
    np.testing.assert_allclose(p["router"].std().item(), 0.88 * 0.02, rtol=0.05)
