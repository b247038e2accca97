"""The port's SSD chunked scan against the JAX package's: its plain version
(what ``ops.ssd`` computes for CPU tensors) against the Pallas kernel in
interpret mode and against the sequential oracle over the sweep of
``tests/test_kernels.py``, with that sweep's tolerance (20 x fp32 2e-5 /
bf16 2e-2); at ragged S, which the JAX wrappers refuse (they assert that the
chunk divides S), against the sequential oracle alone; with an initial state
against the JAX ``ssd_chunked``.  Inputs come from seeded numpy generators.

The CUDA kernel itself cannot run without a card; ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold it against this plain version on one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import reference_ssd as jax_reference_ssd
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import reference_ssd, ssd_chunked

TOL = {"float32": 20 * 2e-5, "bfloat16": 20 * 2e-2}
SWEEP = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 128, 16)]


def _inputs(b, s, h, p, n, seed=4, with_h0=False):
    """x, dt, a, b, c (and h0) as numpy, drawn as the JAX sweep draws them."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.2, size=(b, s, h)),
           -rng.uniform(0.5, 4.0, size=(h,)), rng.normal(size=(b, s, n)),
           rng.normal(size=(b, s, n))]
    if with_h0:
        out.append(rng.normal(size=(b, h, p, n)))
    return out


def _both(arrays, dtype):
    """x, b, c in ``dtype``, the rest in fp32, as JAX arrays and torch tensors
    of the same values."""
    low = {0, 3, 4}  # x, b, c
    jx = [jnp.asarray(a, getattr(jnp, dtype) if i in low else jnp.float32)
          for i, a in enumerate(arrays)]
    tt = [torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype) if i in low
                                                       else torch.float32)
          for i, j in enumerate(jx)]
    return jx, tt


def _close(a, b, tol):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_plain_ssd_matches_pallas_and_reference(b, s, h, p, n, chunk, dtype):
    jx, tt = _both(_inputs(b, s, h, p, n), dtype)
    y, hf = ops.ssd(*tt, chunk=chunk)
    assert y.dtype == tt[0].dtype and y.shape == (b, s, h, p)
    assert hf.dtype == torch.float32 and hf.shape == (b, h, p, n)
    yp, hp = jax_ssd_scan(*jx, chunk=chunk, interpret=True)
    yr, hr = jax_reference_ssd(*jx)
    for want_y, want_h in ((yp, hp), (yr, hr)):
        _close(y, want_y, TOL[dtype])
        _close(hf, want_h, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequential_oracle_matches_reference(dtype):
    """The port's ``reference_ssd`` against the JAX one, from an initial
    state."""
    jx, tt = _both(_inputs(2, 40, 3, 8, 16, seed=5, with_h0=True), dtype)
    y, hf = reference_ssd(*tt)
    yr, hr = jax_reference_ssd(*jx)
    assert y.dtype == tt[0].dtype
    _close(y, yr, TOL[dtype])
    _close(hf, hr, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(1, 64), (7, 4), (77, 32), (130, 64), (200, 512)])
def test_ragged_s_matches_sequential_oracle(s, chunk, dtype):
    """S that no chunk divides (a short last chunk), and S below the chunk:
    the served prompts have exact lengths."""
    jx, tt = _both(_inputs(2, s, 3, 16, 32, seed=s), dtype)
    y, hf = ops.ssd(*tt, chunk=chunk)
    yr, hr = jax_reference_ssd(*jx)
    _close(y, yr, TOL[dtype])
    _close(hf, hr, TOL[dtype])


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32), (77, 32)])
def test_initial_state_matches_reference(s, chunk):
    """``ssd_chunked`` from a state ``h0``: the JAX ``ssd_chunked`` where its
    chunk divides S, the sequential oracle always."""
    jx, tt = _both(_inputs(1, s, 4, 8, 16, seed=9, with_h0=True), "float32")
    y, hf = ssd_chunked(*tt[:5], chunk=chunk, h0=tt[5])
    wants = [jax_reference_ssd(*jx)]
    if s % chunk == 0:
        wants.append(jax_ssd_chunked(*jx[:5], chunk=chunk, h0=jx[5]))
    for yr, hr in wants:
        _close(y, yr, 1e-4)
        _close(hf, hr, 1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_result_does_not_depend_on_chunk(seed):
    """The state-passing identity: every chunk gives the sequential result
    (fixed seeds; ``tests/test_kernels.py`` draws them with Hypothesis)."""
    _, tt = _both(_inputs(1, 96, 2, 8, 8, seed=seed), "float32")
    y0, h0 = reference_ssd(*tt)
    for chunk in (1, 5, 32, 96, 1000):
        y, hf = ssd_chunked(*tt, chunk=chunk)
        np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(hf.numpy(), h0.numpy(), atol=1e-4, rtol=1e-4)


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    def mk(b=1, s=8, h=2, p=32, n=16, dtype=torch.float32):
        return [torch.zeros(b, s, h, p, dtype=dtype), torch.zeros(b, s, h),
                torch.zeros(h), torch.zeros(b, s, n, dtype=dtype),
                torch.zeros(b, s, n, dtype=dtype)]

    ops._check(*mk())  # accepted
    ops._check(*mk(p=64, n=128, dtype=torch.bfloat16))
    ops._check(*mk(p=12, n=4))
    with pytest.raises(ValueError):
        ops._check(*mk(p=48))  # above 32, not a multiple of 32
    with pytest.raises(ValueError):
        ops._check(*mk(p=6))
    with pytest.raises(ValueError):
        ops._check(*mk(n=256))  # state beyond the shared memory
    with pytest.raises(ValueError):
        ops._check(*mk(n=18))
    with pytest.raises(ValueError):
        ops._check(*mk(s=0))
    x, dt, a, b, c = mk()
    with pytest.raises(ValueError):
        ops._check(x, dt[:, :4], a, b, c)  # dt does not fit x
    with pytest.raises(TypeError):
        ops._check(x.half(), dt, a, b.half(), c.half())
    with pytest.raises(TypeError):
        ops._check(x, dt, a, b.bfloat16(), c)
    with pytest.raises(TypeError):
        ops._check(x, dt.bfloat16(), a, b, c)
    with pytest.raises(ValueError):
        ops._check(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, b, c)
    with pytest.raises(ValueError):
        ops.ssd(*(t.to("meta") for t in mk()))
