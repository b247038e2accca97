"""The port's grouped expert matmul against the JAX package's: its plain
version (what ``ops.gmm`` and ``ops.expert_ffn`` compute for CPU tensors)
against the Pallas kernel in interpret mode and against the JAX oracle, over
the sweep of ``tests/test_kernels.py``.  Tolerances as there: the grouped
matmul 5 x (fp32 2e-5, bf16 2e-2), the expert FFN 1e-4 in fp32.

The CUDA kernel itself cannot run without a card; ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold it against this plain version on one."""

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
    with pytest.raises(ValueError):
        ops._check(x.transpose(1, 2).contiguous().transpose(1, 2), w)  # strided last dim
    with pytest.raises(ValueError):
        ops._check(torch.zeros(2, 8, 66)[:, :, 1:65], w)  # rows off 16-byte alignment
    with pytest.raises(ValueError):
        ops.gmm(x.to("meta"), w.to("meta"))
