"""The flash attention backward's plain version against the JAX package: the
port's ``attention_backward`` and the logsumexp rows of ``attention_forward``
(the functions the backward kernel is held against on the card) against
``jax.vjp`` of the JAX package's ``reference_attention`` and
``jax.nn.logsumexp`` of its masked scaled scores; and the port's autograd
function on the CPU against the JAX custom VJP around the Pallas kernel in
interpret mode.  Shapes as ``tests/test_kernels.py``'s (B <= 2, S <= 200,
D <= 64); inputs from seeded numpy generators.  Tolerances: the gradients
1e-4 in fp32 (``tests/test_kernels.py``'s VJP test) and 2e-2 in bf16 (the
kernel sweep's), abs + rel; the logsumexp rows 1e-5, computed in fp32 from
the same values in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import reference_attention as jax_reference_attention
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import (attention_backward, attention_forward,
                                                     reference_attention)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-5
MASKS = {"causal": (True, 0), "full": (False, 0), "window": (True, 48)}
GROUPS = {"g1": (4, 4), "g2": (4, 2), "g4": (4, 1)}  # (query heads, kv heads)


def _arrays(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))]


def _both(arrays, dtype):
    """The same values as JAX arrays and as torch tensors of ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return jx, [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype)) for x in jx]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _jax_lse(q, k, causal, window):
    """logsumexp of the JAX reference's masked scaled scores, [B, H, S]."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qf = q.astype(jnp.float32).reshape(b, s, kv, h // kv, d)
    scores = jnp.einsum("bqkgd,bskd->bkgqs", qf, k.astype(jnp.float32)) * d**-0.5
    q_pos, k_pos = jnp.arange(s)[:, None], jnp.arange(k.shape[1])[None, :]
    mask = jnp.ones((s, k.shape[1]), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    scores = jnp.where(mask, scores, -1e30)
    return jax.nn.logsumexp(scores, axis=-1).reshape(b, h, s)


def _check_backward(b, s, h, kv, d, causal, window, dtype, seed):
    (qj, kj, vj, gj), (q, k, v, g) = _both(_arrays(b, s, h, kv, d, seed), dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_reference_attention(
        q_, k_, v_, causal=causal, window=window), qj, kj, vj)
    want = vjp(gj)
    o, lse = attention_forward(q, k, v, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(_np(lse), np.asarray(_jax_lse(qj, kj, causal, window)),
                               atol=LSE_TOL, rtol=LSE_TOL)
    got = attention_backward(q, k, v, o, lse, g, causal=causal, window=window)
    for x, gx, w in zip((q, k, v), got, want):
        assert gx.dtype == x.dtype and gx.shape == x.shape
        np.testing.assert_allclose(_np(gx), _np(w), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("mask", list(MASKS))
def test_attention_backward_and_lse_match_jax_vjp(mask, group, dtype):
    (causal, window), (h, kv) = MASKS[mask], GROUPS[group]
    _check_backward(2, 128, h, kv, 64, causal, window, dtype, seed=len(mask) + h + kv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,d", [(77, 0, 32), (200, 48, 64), (1, 0, 64)])
def test_attention_backward_at_a_ragged_length(s, window, d, dtype):
    """S that no kernel tile divides (the last tile short), and one row."""
    _check_backward(1, s, 8, 2, d, True, window, dtype, seed=s)


def test_forward_with_lse_gives_the_reference_output():
    """``attention_forward``'s output is ``reference_attention``'s, bit for bit:
    serving (no lse) and training (lse) see the same attention."""
    (_, _, _, _), (q, k, v, _) = _both(_arrays(2, 100, 8, 2, 32, 3), "float32")
    for causal, window in MASKS.values():
        out, _ = attention_forward(q, k, v, causal=causal, window=window)
        assert torch.equal(out, reference_attention(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask,group,s", [("causal", "g4", 128), ("window", "g1", 192),
                                          ("full", "g2", 128)])
def test_autograd_function_matches_jax_custom_vjp(mask, group, s, dtype):
    """dq, dk and dv through ``ops.flash_attention`` on the CPU (the plain
    forward with lse, then ``attention_backward``) against the JAX custom
    VJP around the Pallas kernel in interpret mode."""
    (causal, window), (h, kv) = MASKS[mask], GROUPS[group]
    (qj, kj, vj, gj), (q, k, v, g) = _both(_arrays(1, s, h, kv, 32, seed=s + h), dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(
        q_, k_, v_, causal=causal, window=window, block_q=64, block_k=64, interpret=True),
        qj, kj, vj)
    want = vjp(gj)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, g)
    for x, gx, w in zip(leaves, got, want):
        assert gx.dtype == x.dtype
        np.testing.assert_allclose(_np(gx), _np(w), atol=TOL[dtype], rtol=TOL[dtype])


def test_backward_computes_only_the_gradients_asked_for(monkeypatch):
    """With only q requiring grad, the backward gives dq alone (equal to the
    full backward's) and None for k and v."""
    returned = []
    backward = ops._backward
    monkeypatch.setattr(ops, "_backward", lambda *a: returned.append(backward(*a)) or returned[-1])
    (_, _, _, _), (q, k, v, g) = _both(_arrays(2, 64, 4, 2, 32, 9), "float32")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(*leaves, causal=True), leaves, g)
    qq = q.clone().requires_grad_()
    (dq,) = torch.autograd.grad(ops.flash_attention(qq, k, v, causal=True), [qq], g)
    assert torch.equal(dq, want[0])
    assert [t is None for t in returned[-1]] == [False, True, True]


def test_no_grad_forward_writes_no_lse(monkeypatch):
    """Where no gradient can flow (serving), the forward runs alone: no
    autograd function, no logsumexp rows."""
    calls = []
    forward = ops._forward
    monkeypatch.setattr(ops, "_forward", lambda *a: calls.append(a[5:]) or forward(*a))
    (_, _, _, _), (q, k, v, _) = _both(_arrays(1, 32, 4, 2, 32, 4), "float32")
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    ops.flash_attention(q.detach(), k, v)
    out = ops.flash_attention(q.detach().requires_grad_(), k, v)
    assert calls == [(), (), (True,)] and out.grad_fn is not None


def test_scratch_rows_cover_the_sequence():
    assert [kernel.scratch_rows(s) for s in (1, 127, 128, 129, 256)] == [128, 128, 128, 256, 256]
