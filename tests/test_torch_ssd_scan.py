"""The port's SSD chunked scan against the JAX package's: its plain version
(what ``ops.ssd`` computes for CPU tensors) against the Pallas kernel in
interpret mode and against the sequential oracle over the sweep of
``tests/test_kernels.py``, with that sweep's tolerance (20 x fp32 2e-5 /
bf16 2e-2); at ragged S, which the JAX wrappers refuse (they assert that the
chunk divides S), against the sequential oracle alone; with an initial state
against the JAX ``ssd_chunked``.  Inputs come from seeded numpy generators.

Gradients: ``ops.ssd`` on the CPU (autograd through ``ssd_chunked``)
against the JAX ``ssd``'s custom VJP around the Pallas kernel in interpret
mode, at ``tests/test_kernels.py::test_ssd_grads``'s shape, and against
``jax.vjp`` of the sequential oracle at ragged S, within that test's 5e-4
of each gradient's largest value.

The CUDA kernels themselves cannot run without a card; ``chip_smoke.py``
and ``tests/test_torch_gpu.py`` hold them against this plain version on one.
The forward's bf16 arithmetic (fp32 factors split into two bf16 terms for
the tensor cores) is emulated here in PyTorch and held against the fp32
plain version at mamba2-1.3b's widths; so are the backward kernel's passes
(entry states, exit-state gradients, per-chunk gradients, the sums over
heads) against autograd."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import reference_ssd as jax_reference_ssd
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel, ops
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


def _terms(v, n):
    """v as the kernel feeds it to bf16 tensor cores: hi = bf16(v) and, for
    two terms, lo = bf16(v - hi); the terms' values in fp32."""
    hi = v.to(torch.bfloat16).float()
    return (hi,) if n == 1 else (hi, (v - hi).to(torch.bfloat16).float())


def _tensor_core_ssd(x, dt, a, b, c, n_terms, chunk=64):
    """The CUDA kernel's bf16 route, emulated: x, b, c hold bf16 values (in
    fp32); each fp32 factor is folded into one operand of a product, which
    goes in as ``n_terms`` bf16 terms, and the products sum in fp32 (as
    wgmma's fp32 accumulators do).  C B^T takes its exact operands as they
    are.  Returns y in fp32 (before its bf16 store) and the final state."""
    bs, s, h, p = x.shape
    xh, dth = x.permute(0, 2, 1, 3), dt.permute(0, 2, 1)  # [B,H,S,P], [B,H,S]
    state = torch.zeros(bs, h, p, b.shape[-1])
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, min(t0 + chunk, s))
        q = sl.stop - t0
        d = dth[..., sl]  # [B,H,Q]
        cum = torch.cumsum(d * a[None, :, None], -1)
        bc, cc, xc = b[:, sl], c[:, sl], xh[:, :, sl]
        mask = torch.ones(q, q, dtype=torch.bool).tril()
        diff = torch.where(mask, cum[..., :, None] - cum[..., None, :], float("-inf"))
        g = (cc @ bc.transpose(1, 2))[:, None] * torch.exp(diff) * d[..., None, :]
        y = sum(t @ xc for t in _terms(g, n_terms))
        y = y + torch.exp(cum)[..., None] * sum(cc[:, None] @ t.transpose(-1, -2)
                                                for t in _terms(state, n_terms))
        xw = xc * (torch.exp(cum[..., -1:] - cum) * d)[..., None]
        state = torch.exp(cum[..., -1])[..., None, None] * state + sum(
            t.transpose(-1, -2) @ bc[:, None] for t in _terms(xw, n_terms))
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), state


@pytest.mark.parametrize("s", [866, 512])
def test_two_bf16_terms_keep_fp32_accuracy(s):
    """The bf16 tensor-core route's arithmetic at mamba2-1.3b's widths (P 64,
    N 128; 4 heads) and served lengths: with two terms, y and the final state
    are within 1e-4 of the fp32 plain version, relative to their largest
    value; with one term (plain bf16 operands) the state is not, and that
    state is carried into every decode step."""
    x, dt, a, b, c = (torch.from_numpy(v).float() for v in _inputs(1, s, 4, 64, 128, seed=s))
    x, b, c = (t.bfloat16().float() for t in (x, b, c))  # the served dtype's values
    y_ref, h_ref = ssd_chunked(x, dt, a, b, c, chunk=256)

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    y2, h2 = _tensor_core_ssd(x, dt, a, b, c, n_terms=2)
    assert rel(y2, y_ref) <= 1e-4 and rel(h2, h_ref) <= 1e-4
    _, h1 = _tensor_core_ssd(x, dt, a, b, c, n_terms=1)
    assert rel(h1, h_ref) > 1e-4


def test_route_takes_tensor_cores_for_bf16_rows_tma_can_address():
    """bfloat16 with P and N multiples of 8 (16-byte rows for TMA) takes the
    tensor-core kernel; float32 and the other bfloat16 shapes the FMA one."""
    assert kernel.route(torch.bfloat16, 64, 128) == "wgmma"
    assert kernel.route(torch.bfloat16, 8, 16) == "wgmma"
    assert kernel.route(torch.float32, 64, 128) == "fma"
    assert kernel.route(torch.bfloat16, 12, 128) == "fma"
    assert kernel.route(torch.bfloat16, 64, 20) == "fma"


def test_backward_route_takes_tensor_cores_for_one_tile_of_p():
    """The backward takes the wgmma route where the forward does and P fits
    one 64-column tile of x; its partials of dB and dC are one per head on
    the FMA route and one per group of 8, 4, 2 or 1 heads (the largest that
    divides H) on the wgmma route."""
    assert kernel.bwd_route(torch.bfloat16, 64, 128) == "wgmma"
    assert kernel.bwd_route(torch.bfloat16, 8, 16) == "wgmma"
    assert kernel.bwd_route(torch.bfloat16, 128, 128) == "fma"
    assert kernel.bwd_route(torch.float32, 64, 128) == "fma"
    assert kernel.bwd_route(torch.bfloat16, 12, 20) == "fma"
    assert [kernel.bwd_parts("wgmma", h) for h in (64, 12, 6, 3)] == [8, 3, 3, 3]
    assert kernel.bwd_parts("fma", 64) == 64


# ---------------------------------------------------------------- backward
GRAD_TOL = 5e-4  # tests/test_kernels.py::test_ssd_grads, of each gradient's largest value


def _cotangents(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


def _port_grads(fn, arrays, dy, dh):
    """Gradients of ``sum(y * dy) + sum(h_final * dh)`` through ``fn``
    with respect to x, dt, a, b and c, as numpy."""
    leaves = [torch.tensor(np.asarray(t, np.float32), requires_grad=True) for t in arrays]
    y, hf = fn(*leaves)
    grads = torch.autograd.grad([y, hf], leaves, [torch.from_numpy(dy), torch.from_numpy(dh)])
    return [g.numpy() for g in grads]


def _close_to_largest(got, want, tol):
    """Each gradient within ``tol`` of the reference gradient's largest value."""
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol * float(np.abs(w).max()), rtol=0, err_msg=name)


def test_ssd_gradients_match_jax_custom_vjp():
    """``tests/test_kernels.py::test_ssd_grads``'s shape and draw, with
    cotangents of y and of the final state: the JAX ``ssd`` differentiates
    through its custom VJP (the forward the Pallas kernel in interpret mode,
    the backward ``jax.vjp`` of ``reference_ssd``)."""
    rng = np.random.default_rng(8)
    b, s, h, p, n = 1, 64, 2, 16, 16
    arrays = [rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.2, size=(b, s, h)),
              -rng.uniform(0.5, 3.0, size=(h,)), rng.normal(size=(b, s, n)),
              rng.normal(size=(b, s, n))]
    jx = [jnp.asarray(t, jnp.float32) for t in arrays]
    dy, dh = _cotangents(b, s, h, p, n, seed=9)
    _, vjp = jax.vjp(lambda *t: jax_ssd(*t, chunk=32, interpret=True), *jx)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = _port_grads(lambda *t: ops.ssd(*t, chunk=32), arrays, dy, dh)
    _close_to_largest(got, want, GRAD_TOL)


@pytest.mark.parametrize("s,chunk", [(77, 32), (130, 64)])
def test_ssd_gradients_at_ragged_s_match_reference_vjp(s, chunk):
    """S that no chunk divides, which the JAX wrappers refuse: against
    ``jax.vjp`` of the sequential oracle."""
    b, h, p, n = 2, 3, 16, 32
    arrays = _inputs(b, s, h, p, n, seed=s)
    jx = [jnp.asarray(t, jnp.float32) for t in arrays]
    dy, dh = _cotangents(b, s, h, p, n, seed=s + 1)
    _, vjp = jax.vjp(jax_reference_ssd, *jx)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = _port_grads(lambda *t: ops.ssd(*t, chunk=chunk), arrays, dy, dh)
    _close_to_largest(got, want, GRAD_TOL)


def _kernel_backward(x, dt, a, b, c, dy, dh, q=kernel.CHUNK):
    """The CUDA backward's passes, emulated in fp32 (``csrc/ssd_scan.cu``,
    ``ssd_bwd_states``, ``ssd_bwd_chunk``, ``ssd_bwd_reduce``): each chunk's
    entry state by a forward walk and the gradient of its exit state by a
    backward walk from ``dh``; then each chunk's gradients from those two
    alone; then the heads' dB and dC and the chunks' da summed.  Rows past S
    are zeros with dt = 0, as the kernel loads them."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // q)

    def rows(t, dim):  # [.., S, ..] -> [.., nc, q, ..], zeros past S
        pad = [0, 0] * (t.dim() - 1 - dim) + [0, nc * q - s]
        return torch.nn.functional.pad(t, pad).unflatten(dim, (nc, q))

    xs, ys = rows(x.permute(0, 2, 1, 3), 2), rows(dy.permute(0, 2, 1, 3), 2)  # [B,H,nc,q,P]
    d = rows(dt.permute(0, 2, 1), 2)  # [B,H,nc,q]
    bc, cc = rows(b, 1)[:, None], rows(c, 1)[:, None]  # [B,1,nc,q,N]
    cum = torch.cumsum(d * a[None, :, None, None], -1)
    e, t, decay = torch.exp(cum), torch.exp(cum[..., -1:] - cum), torch.exp(cum[..., -1])
    states, exits = [], [None] * nc
    st = torch.zeros(bs, h, p, n)
    for k in range(nc):
        states.append(st)
        xw = xs[:, :, k] * (t * d)[:, :, k, :, None]
        st = decay[:, :, k, None, None] * st + xw.transpose(-1, -2) @ bc[:, :, k]
    ds = dh
    for k in reversed(range(nc)):
        exits[k] = ds
        ds = decay[:, :, k, None, None] * ds + (ys[:, :, k] * e[:, :, k, :, None]).transpose(
            -1, -2) @ cc[:, :, k]
    S, dS = torch.stack(states, 2), torch.stack(exits, 2)  # [B,H,nc,P,N]
    mask = torch.ones(q, q, dtype=torch.bool).tril()
    lij = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :], float("-inf")))
    m = (cc @ bc.transpose(-1, -2)) * lij  # (C B^T) L
    du_ = (ys @ xs.transpose(-1, -2)) * d[..., None, :]  # dy_i . u_j
    du = m.transpose(-1, -2) @ ys + t[..., None] * (bc @ dS.transpose(-1, -2))
    dcs = e[..., None] * (ys @ S)
    dbs = (t * d)[..., None] * (xs @ dS)
    w, dd = du_ * m, du_ * lij
    tterm = (bc * dbs).sum(-1)
    dcum = w.sum(-1) - w.sum(-2) + (cc * dcs).sum(-1) - tterm
    dcum[..., -1] += tterm.sum(-1) + decay * (dS * S).sum((-1, -2))
    dla = dcum.flip(-1).cumsum(-1).flip(-1)
    db = (dbs + dd.transpose(-1, -2) @ cc).sum(1)  # over H
    dc = (dcs + dd @ bc).sum(1)

    def back(t, dim):  # [.., nc, q, ..] -> [.., S, ..]
        return t.flatten(dim, dim + 1).narrow(dim, 0, s)

    return (back(du * d[..., None], 2).permute(0, 2, 1, 3),
            back(dla * a[None, :, None, None] + (du * xs).sum(-1), 2).permute(0, 2, 1),
            (dla * d).sum((0, 2, 3)), back(db, 1), back(dc, 1))


@pytest.mark.parametrize("s,edges", [(64, False), (200, False), (77, True), (1, False)])
def test_kernel_backward_algorithm_matches_autograd(s, edges):
    """The backward kernel's arithmetic, emulated in fp32, against autograd
    through ``ssd_chunked``: ragged S, S of one row, and (``edges``) rows of
    dt = 0, dt far below fp32's resolution next to 1 and dt < 0, as
    ``tests/test_torch_gpu.py`` gives the forward."""
    b, h, p, n = 2, 3, 8, 16
    arrays = _inputs(b, s, h, p, n, seed=s + 20)
    if edges:
        arrays[1][:, ::7] = 0.0
        arrays[1][:, 3::11] = 1e-30
        arrays[1][:, 5::13] = -0.01
    dy, dh = _cotangents(b, s, h, p, n, seed=s + 21)
    want = _port_grads(lambda *t: ssd_chunked(*t, chunk=32), arrays, dy, dh)
    t = [torch.tensor(np.asarray(v, np.float32)) for v in arrays]
    got = [g.numpy() for g in _kernel_backward(*t, torch.from_numpy(dy), torch.from_numpy(dh))]
    for g, w in zip(got, want):
        if not np.abs(w).max():  # S = 1: da is 0 (the one row's decay cancels)
            np.testing.assert_allclose(g, w, atol=1e-6)
            continue
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * float(np.abs(w).max()), rtol=0)


def _split_product(u, v, n_terms):
    """u @ v with both fp32 factors split, as the kernel's wgmmas sum them:
    hi hi + hi lo + lo hi for two terms (lo lo lies below both terms'
    rounding), hi hi for one."""
    tu, tv = _terms(u, n_terms), _terms(v, n_terms)
    out = tu[0] @ tv[0]
    return out if n_terms == 1 else out + tu[0] @ tv[1] + tu[1] @ tv[0]


def _tensor_core_backward(x, dt, a, b, c, dy, dh, n_terms, q=kernel.CHUNK):
    """The backward's wgmma route, emulated (``csrc/ssd_scan.cu``,
    ``ssd_bwd_walk_tc``, ``ssd_bwd_chunk_tc``, ``ssd_bwd_reduce``): x, dy, b
    and c hold bf16 values (in fp32) and enter every product exact; each
    fp32 factor enters as ``n_terms`` bf16 terms (``_terms``), the states
    too, as pass 1 stores them, and the products sum in fp32.  The heads'
    dB and dC are summed in the kernel's order: within each block's group
    of heads (``kernel.bwd_parts``), then over the groups.  Returns dx, ddt,
    da, db, dc in fp32, before the bf16 stores of dx, db and dc."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // q)
    terms = lambda v: _terms(v, n_terms)  # noqa: E731

    def rows(t, dim):  # [.., S, ..] -> [.., nc, q, ..], zeros past S
        pad = [0, 0] * (t.dim() - 1 - dim) + [0, nc * q - s]
        return torch.nn.functional.pad(t, pad).unflatten(dim, (nc, q))

    xs, ys = rows(x.permute(0, 2, 1, 3), 2), rows(dy.permute(0, 2, 1, 3), 2)  # [B,H,nc,q,P]
    d = rows(dt.permute(0, 2, 1), 2)  # [B,H,nc,q]
    bc, cc = rows(b, 1)[:, None], rows(c, 1)[:, None]  # [B,1,nc,q,N]
    cum = torch.cumsum(d * a[None, :, None, None], -1)
    e, t, decay = torch.exp(cum), torch.exp(cum[..., -1:] - cum), torch.exp(cum[..., -1])
    # pass 1: the walks, the state in fp32, each update's fp32 factor split
    states, exits = [], [None] * nc
    st = torch.zeros(bs, h, p, n)
    for k in range(nc):
        states.append(st)
        st = decay[:, :, k, None, None] * st + sum(
            v.transpose(-1, -2) @ bc[:, :, k] for v in terms(xs[:, :, k] * (t * d)[:, :, k, :, None]))
    ds = dh if dh is not None else torch.zeros(bs, h, p, n)
    for k in reversed(range(nc)):
        exits[k] = ds
        ds = decay[:, :, k, None, None] * ds + sum(
            v.transpose(-1, -2) @ cc[:, :, k] for v in terms(ys[:, :, k] * e[:, :, k, :, None]))
    S, dS = torch.stack(states, 2), torch.stack(exits, 2)  # [B,H,nc,P,N], stored in terms
    # pass 2
    mask = torch.ones(q, q, dtype=torch.bool).tril()
    lij = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :], float("-inf")))
    cb = cc @ bc.transpose(-1, -2)  # C B^T, exact operands
    dd = (ys @ xs.transpose(-1, -2)) * d[..., None, :] * lij  # D = DU∘L
    w = dd * cb
    dc_h = sum(v @ bc for v in terms(dd)) + _split_product(ys * e[..., None], S, n_terms)
    db_h = (sum(v.transpose(-1, -2) @ cc for v in terms(dd))
            + _split_product(xs * (t * d)[..., None], dS, n_terms))
    dub = sum(bc @ v.transpose(-1, -2) for v in terms(dS))  # B dS^T
    du = sum(v @ ys for v in terms((cb * lij).transpose(-1, -2))) + t[..., None] * dub
    e_term = e * (ys * sum(cc @ v.transpose(-1, -2) for v in terms(S))).sum(-1)
    t_term = t * d * (xs * dub).sum(-1)
    dcum = w.sum(-1) - w.sum(-2) + e_term - t_term
    dcum[..., -1] += t_term.sum(-1) + decay * (sum(terms(dS)) * sum(terms(S))).sum((-1, -2))
    dla = dcum.flip(-1).cumsum(-1).flip(-1)

    def heads_summed(g):  # [B,H,nc,q,N] -> [B,nc,q,N], within groups, then over them
        per = h // kernel.bwd_parts("wgmma", h)
        total = None
        for h0 in range(0, h, per):
            part = g[:, h0]
            for hh in range(h0 + 1, h0 + per):
                part = part + g[:, hh]
            total = part if total is None else total + part
        return total

    def back(t, dim):  # [.., nc, q, ..] -> [.., S, ..]
        return t.flatten(dim, dim + 1).narrow(dim, 0, s)

    return (back(du * d[..., None], 2).permute(0, 2, 1, 3),
            back(dla * a[None, :, None, None] + (du * xs).sum(-1), 2).permute(0, 2, 1),
            (dla * d).sum((0, 2, 3)), back(heads_summed(db_h), 1), back(heads_summed(dc_h), 1))


# the wgmma backward's arithmetic against fp32 autograd, relative to each
# gradient's largest value: two terms gave 1.4e-6 to 5.4e-6 at these shapes,
# one term (plain bf16 factors) 4e-4 to 3.0e-3
TC_GRAD_REL = 1e-5


@pytest.mark.parametrize("s,edges", [(256, False), (200, True)])
def test_tensor_core_backward_keeps_fp32_accuracy(s, edges):
    """The backward's wgmma route at mamba2-1.3b's widths (P 64, N 128; 6
    heads, so three groups of two in the dB and dC sums): at the train
    length with y's cotangent alone, and at a ragged S with rows of dt = 0,
    tiny and negative and the final state's cotangent.  With two terms each
    gradient is within ``TC_GRAD_REL`` of autograd through the fp32
    ``ssd_chunked``, relative to its largest value; with one term it is
    not."""
    bs, h, p, n = 1, 6, 64, 128
    arrays = _inputs(bs, s, h, p, n, seed=s + 40)
    if edges:
        arrays[1][:, ::7] = 0.0
        arrays[1][:, 3::11] = 1e-30
        arrays[1][:, 5::13] = -0.01
    dy, dh = _cotangents(bs, s, h, p, n, seed=s + 41)
    if not edges:
        dh = np.zeros_like(dh)  # training: no cotangent of the final state
    bf = lambda v: np.asarray(torch.from_numpy(np.asarray(v, np.float32)).bfloat16().float())  # noqa: E731
    arrays = [bf(v) if i in (0, 3, 4) else np.asarray(v, np.float32) for i, v in enumerate(arrays)]
    dy = bf(dy)
    want = _port_grads(lambda *t: ssd_chunked(*t, chunk=64), arrays, dy, dh)
    t = [torch.from_numpy(v) for v in arrays]
    rels = {}
    for n_terms in (1, 2):
        got = _tensor_core_backward(*t, torch.from_numpy(dy), torch.from_numpy(dh) if edges else None,
                                    n_terms)
        rels[n_terms] = [float(np.abs(g.numpy() - w).max() / np.abs(w).max())
                         for g, w in zip(got, want)]
    assert max(rels[2]) <= TC_GRAD_REL, rels[2]
    assert max(rels[1]) > 100 * TC_GRAD_REL, rels[1]
