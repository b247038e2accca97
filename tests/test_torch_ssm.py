"""The port's Mamba-2 layer against the JAX package's on ``mamba2-1.3b``
``REDUCED`` (d_model 128, 8 heads of 32, state 32, conv width 4, chunk 256):
initialisation constants, the causal depthwise conv and its decode ring,
``ssd_step``, and ``ssm_apply`` in prefill (against both JAX impls: XLA's
``ssd_chunked`` and the Pallas kernel in interpret mode) and in decode.

Weights are made by the JAX package and cross as numpy arrays; inputs come
from seeded numpy generators.  Tolerances: fp32 1e-4 (the two frameworks sum
the same products in other orders, and the port's prefill scans in chunks of
the config's size while JAX's XLA path takes ``min(chunk, S)``); bf16 5e-2
absolute plus 2e-2 relative, as the whole-model bf16 cases of
``tests/test_torch_model.py``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import ssm as jax_ssm
from repro.models.layers import Initializer
from repro_torch.configs.base import get_config
from repro_torch.models import ssm

ARCH = "mamba2-1.3b"
FP32_TOL = 1e-4
BF16_TOL, BF16_ATOL = 2e-2, 5e-2


@functools.lru_cache(maxsize=None)
def _layer(compute_dtype="float32"):
    """(JAX config, port config, JAX params, port params) of one layer."""
    cfg_j = dataclasses.replace(jax_get_config(ARCH, reduced=True), compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(get_config(ARCH, reduced=True), compute_dtype=compute_dtype)
    pj, _ = jax_ssm.ssm_init(Initializer(jax.random.PRNGKey(3)), cfg_j, jnp.float32)
    # every weight made non-trivial: the reference inits biases and norm at 0
    rng = np.random.default_rng(11)
    pj = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32) if k.startswith(
        ("conv_b", "norm")) else np.asarray(v) for k, v in pj.items()}
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return cfg_j, cfg_t, {k: jnp.asarray(v) for k, v in pj.items()}, pt


def _x(shape, seed, dtype="float32"):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(a, b, tol, atol=None):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                               atol=tol if atol is None else atol)


def test_init_matches_reference_shapes_and_constants():
    cfg_j = jax_get_config(ARCH, reduced=True)
    pj, _ = jax_ssm.ssm_init(Initializer(jax.random.PRNGKey(0)), cfg_j, jnp.float32)
    pt = ssm.ssm_init(torch.Generator().manual_seed(0), get_config(ARCH, reduced=True))
    assert set(pt) == set(pj)
    for k, v in pj.items():
        assert tuple(pt[k].shape) == v.shape and pt[k].dtype == torch.float32, k
    for k in ("a_log", "d_skip", "dt_bias", "norm", "conv_bx", "conv_bb", "conv_bc"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-7)
    # fan-in truncated normal; the conv taps at std 0.5
    assert abs(pt["w_x"].std().item() * np.sqrt(128) - 0.88) < 0.05
    assert abs(pt["conv_wx"].std().item() - 0.5 * 0.88) < 0.05


def test_softplus_is_jax_softplus():
    """Also past ``F.softplus``'s threshold of 20; atol 1e-38 because XLA
    flushes softplus(-100) = 3.8e-44, a denormal, to 0."""
    x = np.array([-100.0, -20.0, -1.0, 0.0, 0.5, 19.0, 21.0, 50.0, 100.0], np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-38)


@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_and_tail_match_reference(s):
    """The conv over a prompt (shorter than the conv width too) and the
    ring it leaves for decode."""
    xj, xt = _x((2, s, 16), seed=s)
    wj, wt = _x((4, 16), seed=100)
    bj, bt = _x((16,), seed=101)
    out_j, tail_j = jax_ssm._causal_depthwise_conv(xj, wj, bj, jnp.float32)
    out_t, tail_t = ssm._causal_depthwise_conv(xt, wt, bt, torch.float32)
    _close(out_t, out_j, 1e-6)
    _close(tail_t, tail_j, 0)


def test_conv_step_and_ssd_step_match_reference():
    hj, ht = _x((2, 3, 16), seed=1)
    nj, nt = _x((2, 1, 16), seed=2)
    wj, wt = _x((4, 16), seed=3)
    bj, bt = _x((16,), seed=4)
    out_j, ring_j = jax_ssm._conv_step(hj, nj, wj, bj, jnp.float32)
    out_t, ring_t = ssm._conv_step(ht, nt, wt, bt, torch.float32)
    _close(out_t, out_j, 1e-6)
    _close(ring_t, ring_j, 0)

    rng = np.random.default_rng(5)
    args = [rng.normal(size=(2, 4, 8, 16)), rng.normal(size=(2, 4, 8)),
            rng.uniform(0.001, 0.2, size=(2, 4)), -rng.uniform(0.5, 4.0, size=(4,)),
            rng.normal(size=(2, 16)), rng.normal(size=(2, 16))]
    args = [a.astype(np.float32) for a in args]
    yj, hj = jax_ssm.ssd_step(*(jnp.asarray(a) for a in args))
    yt, ht = ssm.ssd_step(*(torch.from_numpy(a) for a in args))
    _close(yt, yj, 1e-5)
    _close(ht, hj, 1e-5)


def _reference_prefill(cfg_j, pj, xj, impl):
    return jax.jit(lambda p, x: jax_ssm.ssm_apply(p, x, cfg_j, update_cache=True, impl=impl))(
        pj, xj)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", [48, 77])
def test_prefill_matches_reference(s, impl):
    """Exact-length prompts below the chunk, which both JAX impls accept:
    the output and the decode state it leaves."""
    cfg_j, cfg_t, pj, pt = _layer()
    xj, xt = _x((2, s, cfg_t.d_model), seed=s)
    out_j, cache_j = _reference_prefill(cfg_j, pj, xj, impl)
    out_t, cache_t = ssm.ssm_apply(pt, xt, cfg_t, update_cache=True)
    _close(out_t, out_j, FP32_TOL)
    assert set(cache_t) == set(cache_j)
    for k in cache_j:
        assert tuple(cache_t[k].shape) == cache_j[k].shape
        _close(cache_t[k], cache_j[k], FP32_TOL)


def test_prefill_over_several_chunks_matches_reference():
    """S = 512 with the config's chunk of 256: two chunks, state carried."""
    cfg_j, cfg_t, pj, pt = _layer()
    xj, xt = _x((1, 512, cfg_t.d_model), seed=7)
    out_j, cache_j = _reference_prefill(cfg_j, pj, xj, "xla")
    out_t, cache_t = ssm.ssm_apply(pt, xt, cfg_t, update_cache=True)
    _close(out_t, out_j, FP32_TOL)
    _close(cache_t["h"], cache_j["h"], FP32_TOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_matches_reference(compute_dtype):
    """Prefill, then 4 decode steps (conv ring + ``ssd_step``): the port
    writes its cache in place, the reference returns a new one."""
    cfg_j, cfg_t, pj, pt = _layer(compute_dtype)
    tol, atol = (FP32_TOL, None) if compute_dtype == "float32" else (BF16_TOL, BF16_ATOL)
    xj, xt = _x((2, 20, cfg_t.d_model), seed=21, dtype=compute_dtype)
    _, cache_j = _reference_prefill(cfg_j, pj, xj, "xla")
    _, cache_t = ssm.ssm_apply(pt, xt, cfg_t, update_cache=True)
    step = jax.jit(lambda p, x, c: jax_ssm.ssm_apply(p, x, cfg_j, cache=c))
    for i in range(4):
        tj, tt = _x((2, 1, cfg_t.d_model), seed=30 + i, dtype=compute_dtype)
        out_j, cache_j = step(pj, tj, cache_j)
        before = cache_t["h"]
        out_t, cache_t = ssm.ssm_apply(pt, tt, cfg_t, cache=cache_t)
        assert cache_t["h"] is before  # in place
        assert out_t.dtype == getattr(torch, compute_dtype)
        _close(out_t, out_j, tol, atol)
    for k in cache_j:
        assert cache_t[k].dtype == getattr(torch, str(cache_j[k].dtype))
        _close(cache_t[k], cache_j[k], tol, atol)
