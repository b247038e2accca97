"""The port's grouped expert matmul against the JAX package's: its plain
version (what ``ops.gmm`` and ``ops.expert_ffn`` compute for CPU tensors)
against the Pallas kernel in interpret mode and against the JAX oracle, over
the sweep of ``tests/test_kernels.py``; and its backward, dx and dw through
the port's autograd function, against ``jax.vjp`` of the JAX package's
custom VJP (the Pallas kernel in interpret mode) where the Pallas blocks
divide C, and of the JAX oracle at ragged C.  Tolerances as there: the
grouped matmul 5 x (fp32 2e-5, bf16 2e-2), the expert FFN 1e-4 in fp32; the
gradients of the grouped matmul 2e-4 and of the expert FFN 2e-3 in fp32
(``test_kernels.py``'s gradient tests).  In bf16 the grouped matmul's
gradients keep the forward's 5 x 2e-2; the expert FFN's are held within
2e-2 of their largest magnitude, the bound ``tests/test_torch_moe.py`` sets
for a bf16 MoE layer: the two frameworks round silu(gate) * up to bf16 at
different places, and the products after it sum those roundings.

The CUDA kernel itself cannot run without a card; ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold it against this plain version on one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import expert_ffn as jax_expert_ffn
from repro.kernels.moe_gmm.ops import gmm as jax_gmm
from repro.kernels.moe_gmm.ref import reference_grouped_matmul as jax_reference_grouped_matmul
from repro_torch.kernels.moe_gmm import ops
from repro_torch.kernels.moe_gmm.ref import reference_expert_ffn, reference_grouped_matmul

TOL = {"float32": 5 * 2e-5, "bfloat16": 5 * 2e-2}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 5 * 2e-2}
# (E, C, D, F) whose backward products the Pallas kernel's blocks divide:
# dx = g w^T needs C <= 128 or a multiple of 128; dw = x^T g contracts over
# C in blocks of min(512, C)
GRAD_SHAPES = [(2, 128, 128, 128), (4, 256, 256, 128), (8, 64, 128, 64), (2, 384, 128, 128)]
SWEEP = [(4, 256, 256, 128), (8, 128, 512, 256), (2, 128, 128, 128), (16, 128, 256, 128)]


def _inputs(e, c, d, f, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(e, c, d)), rng.normal(size=(e, d, f)) / np.sqrt(d)


def _both(arrays, dtype):
    """The same values as JAX arrays and as torch tensors of ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype)) for x in jx]
    return jx, tt


def _close(a, b, tol):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", SWEEP)
def test_plain_gmm_matches_pallas_and_reference(e, c, d, f, dtype):
    (xj, wj), (x, w) = _both(_inputs(e, c, d, f), dtype)
    out = ops.gmm(x, w)
    assert out.dtype == x.dtype and out.shape == (e, c, f)
    _close(out, jax_gmm(xj, wj, interpret=True), TOL[dtype])
    _close(out, jax_reference_grouped_matmul(xj, wj), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 8, 40, 50, 160])
def test_ragged_capacity_matches_reference(c, dtype):
    """Capacities that no tile divides (the served ones are
    ``max(int(1.25 * T * k / E), k)``); the Pallas kernel asserts on them, so
    only the JAX oracle is compared."""
    (xj, wj), (x, w) = _both(_inputs(4, c, 128, 64, seed=c), dtype)
    _close(ops.gmm(x, w), jax_reference_grouped_matmul(xj, wj), TOL[dtype])


def test_expert_ffn_matches_pallas():
    rng = np.random.default_rng(2)
    e, c, d, f = 4, 128, 128, 256
    arrays = {
        "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
        "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
        "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f),
        "buckets": rng.normal(size=(e, c, d)),
    }
    jx, tt = _both(list(arrays.values()), "float32")
    pj, pt = dict(zip(arrays, jx)), dict(zip(arrays, tt))
    out = ops.expert_ffn(pt, pt["buckets"])
    want = jax_expert_ffn(pj, pj["buckets"], interpret=True)
    _close(out, want, 1e-4)
    _close(reference_expert_ffn(pt, pt["buckets"]), want, 1e-4)


def test_plain_version_reads_strided_views():
    """x as a view that skips rows, w as a slice of a wider tensor: the same
    result as contiguous copies (the kernel reads through strides, too)."""
    rng = np.random.default_rng(3)
    xx = torch.from_numpy(rng.normal(size=(3, 20, 32)).astype(np.float32))
    ww = torch.from_numpy(rng.normal(size=(3, 32, 48)).astype(np.float32))
    x, w = xx[:, :13], ww[:, :, 16:]
    np.testing.assert_array_equal(
        ops.gmm(x, w).numpy(), reference_grouped_matmul(x.contiguous(), w.contiguous()).numpy()
    )


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    x, w = torch.zeros(2, 8, 64), torch.zeros(2, 64, 32)
    ops._check(x, w)  # accepted
    ops._check(x[:, 1:], w)  # a ragged view of the rows: strides stay aligned
    with pytest.raises(TypeError):
        ops._check(x.half(), w.half())
    with pytest.raises(TypeError):
        ops._check(x, w.bfloat16())
    with pytest.raises(ValueError):
        ops._check(x, torch.zeros(3, 64, 32))  # expert count
    with pytest.raises(ValueError):
        ops._check(x, torch.zeros(2, 48, 32))  # depth
    with pytest.raises(ValueError):
        ops._check(torch.zeros(2, 8, 6), torch.zeros(2, 6, 32))  # D not a multiple of 4
    with pytest.raises(ValueError):
        ops._check(torch.zeros(2, 0, 64), w)  # empty capacity
    # the backward's operands, read in place: x^T (its middle dim
    # contiguous) and w^T (likewise), and a transposed view of x
    ops._check(x.transpose(1, 2), torch.zeros(2, 8, 32))
    ops._check(torch.zeros(2, 8, 32), w.transpose(1, 2))
    ops._check(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError):
        ops._check(torch.zeros(2, 8, 128)[:, :, ::2], w)  # neither last dim contiguous
    with pytest.raises(ValueError):
        ops._check(x.transpose(1, 2), torch.zeros(2, 8, 30))  # output rows off 16 bytes
    with pytest.raises(ValueError):
        ops._check(torch.zeros(2, 64, 6).transpose(1, 2), torch.zeros(2, 64, 32))  # C of 6
    with pytest.raises(ValueError):
        ops._check(torch.zeros(2, 8, 66)[:, :, 1:65], w)  # rows off 16-byte alignment
    with pytest.raises(ValueError):
        ops.gmm(x.to("meta"), w.to("meta"))


def _port_grads(fn, arrays, cot):
    """Gradients of ``sum(fn(*arrays) * cot)`` through the port, for each
    array (torch tensors made from the JAX arrays' values)."""
    dt = getattr(torch, str(arrays[0].dtype))
    leaves = [torch.from_numpy(np.array(a, np.float32)).to(dt).requires_grad_() for a in arrays]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, torch.from_numpy(np.array(cot, np.float32)).to(dt))


def _grad_inputs(e, c, d, f, dtype, seed):
    rng = np.random.default_rng(seed)
    x, w = _inputs(e, c, d, f, seed)
    (xj, wj, cj), _ = _both([x, w, rng.normal(size=(e, c, f))], dtype)
    return xj, wj, cj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GRAD_SHAPES)
def test_gmm_grads_match_pallas_vjp(e, c, d, f, dtype):
    """dx and dw against the JAX package's custom VJP, whose backward runs
    the Pallas kernel twice (interpret mode); each in its operand's dtype."""
    xj, wj, cj = _grad_inputs(e, c, d, f, dtype, seed=c + d)
    _, vjp = jax.vjp(lambda x, w: jax_gmm(x, w, interpret=True), xj, wj)
    want = vjp(cj)
    got = _port_grads(ops.gmm, (xj, wj), cj)
    for g, w_ in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and g.shape == w_.shape
        _close(g, w_, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 8, 40, 50, 160])
def test_gmm_grads_at_ragged_capacity_match_reference(c, dtype):
    """Capacities no Pallas block divides (dw contracts over them): against
    ``jax.vjp`` of the JAX oracle."""
    xj, wj, cj = _grad_inputs(4, c, 128, 64, dtype, seed=c)
    _, vjp = jax.vjp(jax_reference_grouped_matmul, xj, wj)
    for g, w_ in zip(_port_grads(ops.gmm, (xj, wj), cj), vjp(cj)):
        _close(g, w_, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_grads_match_pallas(dtype):
    """Every gradient of the expert SwiGLU (buckets and the three weights)
    against ``jax.vjp`` of the JAX package's ``expert_ffn`` over its Pallas
    grouped matmuls, at ``tests/test_kernels.py``'s shape."""
    rng = np.random.default_rng(7)
    e, c, d, f = 2, 128, 128, 128
    arrays = [rng.normal(size=(e, c, d)), rng.normal(size=(e, d, f)) / np.sqrt(d),
              rng.normal(size=(e, d, f)) / np.sqrt(d), rng.normal(size=(e, f, d)) / np.sqrt(f),
              rng.normal(size=(e, c, d))]
    (bj, gj, uj, dj, cj), _ = _both(arrays, dtype)

    def jax_fn(b, wg, wu, wd):
        return jax_expert_ffn({"w_gate": wg, "w_up": wu, "w_down": wd}, b, interpret=True)

    def port_fn(b, wg, wu, wd):
        return ops.expert_ffn({"w_gate": wg, "w_up": wu, "w_down": wd}, b)

    _, vjp = jax.vjp(jax_fn, bj, gj, uj, dj)
    for g, w_ in zip(_port_grads(port_fn, (bj, gj, uj, dj), cj), vjp(cj)):
        w_ = np.asarray(w_, np.float32)
        if dtype == "float32":
            _close(g, w_, 2e-3)
        else:
            np.testing.assert_allclose(g.float().numpy(), w_, atol=2e-2 * np.abs(w_).max(),
                                       rtol=0)


@pytest.mark.parametrize("needs", ["x", "w", "both"])
def test_backward_runs_one_product_per_needed_grad_on_transposed_views(monkeypatch, needs):
    """The CPU path is the card's wiring with the plain version in each
    product: the forward, then dx = g w^T only where x needs a gradient and
    dw = x^T g only where w does, each transposed operand passed as a view
    of the saved tensor, not a copy."""
    calls = []
    plain = ops.reference_grouped_matmul
    monkeypatch.setattr(ops, "reference_grouped_matmul", lambda a, b: calls.append(
        (tuple(a.shape), a.is_contiguous(), tuple(b.shape), b.is_contiguous())) or plain(a, b))
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(3, 10, 16)), dtype=torch.float32,
                     requires_grad=needs in ("x", "both"))
    w = torch.tensor(rng.normal(size=(3, 16, 8)), dtype=torch.float32,
                     requires_grad=needs in ("w", "both"))
    ops.gmm(x, w).backward(torch.ones(3, 10, 8))
    dx, dw = ((3, 10, 8), True, (3, 8, 16), False), ((3, 16, 10), False, (3, 10, 8), True)
    want = [((3, 10, 16), True, (3, 16, 8), True)]
    want += {"x": [dx], "w": [dw], "both": [dx, dw]}[needs]
    assert calls == want
    for t in (x, w):
        assert (t.grad is not None) == t.requires_grad


def test_backward_takes_a_broadcast_gradient():
    """``gmm(x, w).sum()`` hands the backward a stride-0 gradient; the
    gradients equal autograd's through the plain version."""
    rng = np.random.default_rng(9)
    x0, w0 = rng.normal(size=(2, 5, 8)), rng.normal(size=(2, 8, 4))
    got = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (x0, w0)]
    want = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (x0, w0)]
    ops.gmm(*got).sum().backward()
    reference_grouped_matmul(*want).sum().backward()
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g.grad, w_.grad, rtol=1e-6, atol=1e-6)
