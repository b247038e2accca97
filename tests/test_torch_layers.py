"""The port's layers against the JAX package's ``models/layers.py`` and the
plain attention paths of ``models/attention.py``, on the same seeded numpy
inputs, in fp32 (2e-5) and bf16 (2e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro_torch.configs.base import get_config
from repro_torch.models import attention, layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(arr, dtype):
    j = jnp.asarray(arr, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))


def _close(t, j, dtype):
    assert str(t.dtype).endswith(dtype)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(3, 7, 64)) * 3.0, dtype)
    sj, st = _pair(rng.normal(size=(64,)) * 0.1, dtype)
    _close(layers.rms_norm(xt, st, 1e-5), jax_layers.rms_norm(xj, sj, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 1000, 100000])
def test_apply_rope(dtype, offset):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 9, 4, 32)), dtype)
    pos = offset + rng.integers(0, 64, (2, 9))
    out_j = jax_layers.apply_rope(xj, jnp.asarray(pos), 10000.0)
    _close(layers.apply_rope(xt, torch.from_numpy(pos), 10000.0), out_j, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_and_mlp(dtype):
    rng = np.random.default_rng(2)
    gj, gt = _pair(rng.normal(size=(4, 48)), dtype)
    uj, ut = _pair(rng.normal(size=(4, 48)), dtype)
    _close(layers.swiglu(gt, ut), jax_layers.swiglu(gj, uj), dtype)
    pj = {n: jnp.asarray(rng.normal(size=s) / np.sqrt(s[0]), jnp.float32)
          for n, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    pt = {n: torch.from_numpy(np.array(w)) for n, w in pj.items()}
    xj, xt = _pair(rng.normal(size=(2, 5, 32)), dtype)
    _close(layers.mlp_apply(pt, xt), jax_layers.mlp_apply(pj, xj, getattr(jnp, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,q_chunk", [(0, 4096), (16, 24)])
def test_blockwise_attention(dtype, window, q_chunk):
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng.normal(size=(2, 40, 4, 32)), dtype)
    kj, kt = _pair(rng.normal(size=(2, 40, 2, 32)), dtype)
    vj, vt = _pair(rng.normal(size=(2, 40, 2, 32)), dtype)
    kw = dict(causal=True, window=window, q_offset=0, scale=32**-0.5, q_chunk=q_chunk)
    _close(attention.blockwise_attention(qt, kt, vt, **kw),
           jax_attention.blockwise_attention(qj, kj, vj, **kw), dtype)


def test_initialisers_draw_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (256, 512))
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-6  # truncated at 2 sigma, sigma = 256**-0.5
    ref = np.asarray(jax_layers.dense_init(jax_layers.Initializer(jax.random.PRNGKey(0)),
                                           (256, 512), jnp.float32))
    assert abs(float(w.std()) - float(ref.std())) < 2e-3
    e = layers.embed_init(gen, 1000, 64)
    assert abs(float(e.std()) - 0.02) < 1e-3
    cfg = get_config("qwen3-32b", reduced=True)
    p = attention.attention_init(gen, cfg)
    assert p["w_q"].shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert float(p["q_norm"].abs().sum()) == 0.0  # norms start at zero


def test_cache_length_is_window_for_swa():
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    c = attention.init_attention_cache(cfg, 2, 200, torch.float32, "cpu")
    assert c["k"].shape == (2, 64, cfg.n_kv_heads, cfg.head_dim)
    assert c["pos"].dtype == torch.int32 and int(c["pos"].max()) == -1
    j = jax_attention.init_attention_cache(cfg, 2, 200)
    assert j["k"].shape == tuple(c["k"].shape)
