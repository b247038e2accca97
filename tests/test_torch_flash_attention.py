"""The port's flash attention against the JAX package's: its plain version
(what ``ops.flash_attention`` computes for CPU tensors) against the Pallas
kernel in interpret mode and against ``reference_attention``, over the sweep
of ``tests/test_kernels.py``.  Tolerances as there: fp32 2e-5, bf16 2e-2.

The CUDA kernel itself cannot run without a card; ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold it against this plain version on one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import reference_attention as jax_reference_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import reference_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the shapes of tests/test_kernels.py's sweep; the Pallas kernel runs at its
# default tiling (one block per sequence here), since tiling is a parameter
# of the TPU kernel that the port has no counterpart of
SWEEP = [  # b, s, h, kv, d, causal, window
    (2, 256, 4, 2, 64, True, 0),
    (1, 512, 8, 8, 32, True, 0),
    (2, 256, 4, 1, 64, True, 64),
    (1, 128, 2, 2, 128, False, 0),
    (1, 384, 6, 3, 64, True, 128),
]


def _inputs(b, s, h, kv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _both(arrays, dtype):
    """The same values as JAX arrays and as torch tensors of ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype)) for x in jx]
    return jx, tt


def _close(a, b, dtype):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window", SWEEP)
def test_plain_version_matches_pallas_and_reference(b, s, h, kv, d, causal, window, dtype):
    (qj, kj, vj), (q, k, v) = _both(_inputs(b, s, h, kv, d, dtype), dtype)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    pallas = jax_flash_attention(qj, kj, vj, causal=causal, window=window, interpret=True)
    _close(out, pallas, dtype)
    _close(out, jax_reference_attention(qj, kj, vj, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window", [(1000, 0), (77, 0), (300, 50)])
def test_ragged_length_matches_reference(s, window, dtype):
    """S that no tile divides (the engine prefills at min(next_pow2, capacity))."""
    (qj, kj, vj), (q, k, v) = _both(_inputs(1, s, 4, 2, 80, dtype, seed=s), dtype)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    _close(out, jax_reference_attention(qj, kj, vj, causal=True, window=window), dtype)


def test_plain_version_reads_strided_views():
    """q/k/v as views of one fused projection give the same result as
    contiguous copies (the kernel reads through strides, too)."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(size=(2, 64, 8, 32)).astype(np.float32))
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = ops.flash_attention(q, k, v, causal=True)
    ref = reference_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    q = torch.zeros(1, 16, 4, 64)
    k = torch.zeros(1, 16, 2, 64)
    ops._check(q, k, k)  # accepted
    with pytest.raises(TypeError):
        ops._check(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        ops._check(torch.zeros(1, 16, 4, 48), torch.zeros(1, 16, 2, 48), torch.zeros(1, 16, 2, 48))
    with pytest.raises(ValueError):
        ops._check(torch.zeros(1, 16, 3, 64), k, k)  # 3 heads over 2 kv heads
    with pytest.raises(ValueError):
        ops._check(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)  # strided head dim
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))

