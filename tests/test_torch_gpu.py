"""Tests of the port that need a CUDA card; each skips without one.  This
file imports no JAX, so that it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import (attention_backward, attention_forward,
                                                     reference_attention)
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ref import reference_grouped_matmul
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import reference_ssd, ssd_chunked
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the SSD backward's ddt and da, which both routes store in fp32, in bf16:
# the wgmma route's two-term split reads about 4e-6 of each one's largest
# value, plain bf16 factors 4e-4 to 3e-3 (test_torch_ssd_scan.py, TC_GRAD_REL)
SSD_FP32_STORE_TOL = 1e-4
SHAPES = [  # b, s, h, kv, d, causal, window
    (2, 256, 4, 2, 64, True, 0),
    (1, 512, 8, 8, 32, True, 0),
    (2, 256, 4, 1, 64, True, 64),
    (1, 128, 2, 2, 128, False, 0),
    (1, 384, 6, 3, 64, True, 128),
    (1, 1000, 16, 8, 128, True, 0),
    (2, 77, 32, 8, 80, True, 64),
    # the edges of the bf16 kernel's tiles (128 query rows, 128 keys, 64 columns)
    *[(2, s, 16, 8, 128, True, 0) for s in (1, 127, 129, 1025)],
    (2, 300, 8, 4, 64, True, 32), (1, 1025, 8, 2, 128, True, 100),  # windows below one tile
    *[(1, 257, 8, kv, 64, True, 0) for kv in (8, 4, 2, 1)],  # GQA groups of 1, 2, 4, 8
    *[(2, 200, 4, 2, d, True, 0) for d in (32, 64, 80, 96, 128)],
    (1, 129, 4, 2, 128, False, 0),
]
FUSED_SHAPES = [(2, 333, 16, 8, 128, True, 0), (1, 129, 32, 8, 80, True, 64)]
GMM_SHAPES = [  # e, c, d, f: the JAX sweep, ragged capacities, granite's decode and prefill
    (4, 256, 256, 128), (8, 128, 512, 256), (2, 128, 128, 128), (16, 128, 256, 128),
    (4, 1, 128, 64), (8, 50, 128, 64), (32, 8, 1024, 512), (32, 160, 512, 1024),
    # the edges of the bf16 kernels' tiles: 128 x 128 prefill, 8 or 16 columns in decode
    *[(8, c, 256, 128) for c in (1, 7, 9, 16, 17, 63, 65, 127, 129, 2560)],
]

SSD_SHAPES = [  # b, s, h, p, n, the plain version's chunk: the JAX sweep, ragged S, mamba2
    (2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 128, 16),
    (2, 77, 3, 16, 32, 32), (1, 1, 2, 32, 16, 256),
    (1, 300, 64, 64, 128, 512), (2, 512, 64, 64, 128, 512),
    # the edges of the bf16 kernel's tiles (64-row chunks, 32 columns of P,
    # 64-column boxes of N), and a bf16 shape of the FMA route (P, N not
    # multiples of 8)
    *[(1, s, 4, 64, 128, 256) for s in (1, 63, 64, 65, 127, 128, 129, 1000)],
    *[(2, 130, 4, p, 64, 64) for p in (8, 16, 32, 64)],
    *[(2, 130, 4, 32, n, 64) for n in (16, 32, 64, 128)],
    (4, 200, 8, 64, 128, 64), (2, 100, 3, 12, 20, 64),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for b, s, h, kv, d, causal, window in SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device=cuda).to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device=cuda).to(dtype)
        before = kernel.launches
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        ref = reference_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (2, 256, 16, 8, 128, True, 0)),
                                         (torch.float32, (1, 200, 4, 2, 64, True, 64))])
def test_flash_gradients_on_card_match_cpu(cuda, dtype, shape):
    """dq, dk and dv through the forward and backward kernels on the card (one
    launch each) against the same autograd function on the CPU (the plain
    versions), in q's dtypes."""
    b, s, h, kv, d, causal, window = shape
    rng = np.random.default_rng(3)
    host = [torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32)).to(dtype)
            for n in (h, kv, kv)]
    cot = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32)).to(dtype)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in host]
        before = (kernel.launches, kernel.bwd_launches)
        out = ops.flash_attention(*leaves, causal=causal, window=window)
        grads[str(dev)] = torch.autograd.grad(out, leaves, cot.to(dev))
        made = (kernel.launches - before[0], kernel.bwd_launches - before[1])
        assert made == ((1, 1) if dev == cuda else (0, 0))
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_card.dtype == dtype
        torch.testing.assert_close(g_card.cpu().float(), g_cpu.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_backward_kernel_matches_plain_version(cuda, dtype):
    """The backward kernel's dq, dk and dv against ``attention_backward`` on
    the same inputs (o and lse from the plain forward there, from the kernel
    here, which must agree with them), at a windowed GQA shape with a short
    last tile and on q, k and v as views of one fused buffer; two passes
    bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for b, s, h, kv, d, window, fused in ((2, 300, 8, 2, 64, 100, False),
                                          (2, 333, 16, 8, 128, 0, True)):
        if fused:
            qkv = torch.randn(b, s, h + 2 * kv, d, generator=gen, device=cuda).to(dtype)
            q, k, v = qkv.split([h, kv, kv], dim=2)
        else:
            q, k, v = (torch.randn(b, s, n, d, generator=gen, device=cuda).to(dtype)
                       for n in (h, kv, kv))
        cot = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
        passes = []
        for _ in range(2):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            before = kernel.bwd_launches
            out = ops.flash_attention(*leaves, causal=True, window=window)
            passes.append(torch.autograd.grad(out, leaves, cot))
            assert kernel.bwd_launches == before + 1
        assert all(torch.equal(a, c) for a, c in zip(*passes))
        _, lse = ops._forward(q, k, v, True, window, True)
        o_plain, lse_plain = attention_forward(q, k, v, causal=True, window=window)
        torch.testing.assert_close(lse, lse_plain, atol=1e-4, rtol=1e-4)
        want = attention_backward(q, k, v, o_plain, lse_plain, cot, causal=True, window=window)
        tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
        for g, w, x in zip(passes[0], want, (q, k, v)):
            assert g.dtype == dtype and g.shape == x.shape
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,s,skv,causal,need", [
    (2, 8, 2, 300, 100, True, (True, True, True)), (2, 8, 2, 100, 300, True, (True, True, True)),
    (2, 8, 2, 256, 256, True, (True, False, False)), (2, 8, 2, 256, 256, True, (False, True, True))],
    ids=["skv<s", "skv>s", "dq-only", "dkdv-only"])
def test_flash_backward_grid_takes_every_block(cuda, b, h, kv, s, skv, causal, need):
    """The bf16 backward's one grid of dK/dV and dQ blocks: causal with S
    past Skv (every query tile reaches the few key tiles) and with Skv past
    S (key blocks that no query row reaches: their blocks walk no tile and
    store zeros), and with only dq or only dk and dv asked for (the other
    kind's blocks not launched); against ``attention_backward``, one launch
    each."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    d = 64
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(b, skv, kv, d, generator=gen, device=cuda).bfloat16() for _ in range(2))
    cot = torch.randn(b, s, h, d, generator=gen, device=cuda).bfloat16()
    leaves = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
    before = kernel.bwd_launches
    out = ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], cot)
    assert kernel.bwd_launches == before + 1
    o_plain, lse_plain = attention_forward(q, k, v, causal=causal)
    want = [w for w, n in zip(attention_backward(q, k, v, o_plain, lse_plain, cot, causal=causal),
                              need) if n]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=TOL[torch.bfloat16],
                                   rtol=TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ssd_gradients_on_card_match_cpu(cuda, dtype):
    """dx, ddt, da, db and dc through the forward and backward kernels on
    the card against autograd through the plain ``ssd_chunked`` on the CPU,
    with cotangents of y and of the final state, at a ragged S with rows of
    dt = 0, tiny and negative; each within 5e-4 of its largest value in fp32
    (``tests/test_kernels.py::test_ssd_grads``); in bf16 dx, db and dc
    (stored in bf16) within 2e-2, ddt and da (stored in fp32) within
    ``SSD_FP32_STORE_TOL``.  One backward launch; two passes bit-identical."""
    rng = np.random.default_rng(6)
    b, s, h, p, n = 2, 200, 4, 64, 128
    host = [rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.2, size=(b, s, h)),
            -rng.uniform(0.5, 4.0, size=(h,)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n))]
    host[1][:, ::7], host[1][:, 3::11], host[1][:, 5::13] = 0.0, 1e-30, -0.01
    host = [torch.from_numpy(t.astype(np.float32)).to(dtype if i in (0, 3, 4) else torch.float32)
            for i, t in enumerate(host)]
    dy = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32)).to(dtype)
    dh = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(np.float32))
    grads = {}
    wgmma = dtype == torch.bfloat16  # the route bwd_route takes at P 64, N 128
    assert ssd_kernel.bwd_route(dtype, p, n) == ("wgmma" if wgmma else "fma")
    for dev in ("cpu", cuda, cuda):
        leaves = [t.to(dev).requires_grad_() for t in host]
        before = (ssd_kernel.bwd_launches, ssd_kernel.bwd_wgmma_launches)
        y, hf = ssd_ops.ssd(*leaves, chunk=64)
        got = torch.autograd.grad([y, hf], leaves, [dy.to(dev), dh.to(dev)])
        assert ssd_kernel.bwd_launches == before[0] + (dev == cuda)
        assert ssd_kernel.bwd_wgmma_launches == before[1] + (dev == cuda and wgmma)
        grads.setdefault(str(dev), []).append([g.cpu() for g in got])
    assert all(torch.equal(u, v) for u, v in zip(*grads["cuda"]))
    tols = [5e-4] * 5 if dtype == torch.float32 else [TOL[dtype], *[SSD_FP32_STORE_TOL] * 2,
                                                       TOL[dtype], TOL[dtype]]
    for g_card, g_cpu, x, tol in zip(grads["cuda"][0], grads["cpu"][0], host, tols):
        assert g_card.dtype == x.dtype and bool(torch.isfinite(g_card.float()).all())
        scale = g_cpu.float().abs().max()
        torch.testing.assert_close(g_card.float(), g_cpu.float(), atol=tol * scale, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n", [(8, 256, 64, 64, 128), (2, 130, 3, 16, 32),
                                       (2, 130, 4, 8, 16), (2, 100, 3, 12, 20)])
def test_ssd_backward_routes_agree(cuda, b, s, h, p, n):
    """bf16: the backward's route is the one ``bwd_route`` names (wgmma at
    mamba2's train shape and at the edges of its tiles: groups of one head,
    N of one box, P of 8; FMA at P 12, N 20), and its gradients agree with
    the FMA route's on the same inputs, relative to each gradient's largest
    value: dx, db and dc (stored in bf16 by both) within the bf16
    tolerance, ddt and da (stored in fp32) within ``SSD_FP32_STORE_TOL``."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(b, s, h, p, generator=gen, device=cuda).bfloat16()
    dt = torch.rand(b, s, h, generator=gen, device=cuda) * 0.199 + 0.001
    a = -(torch.rand(h, generator=gen, device=cuda) * 3.5 + 0.5)
    bc = [torch.randn(b, s, n, generator=gen, device=cuda).bfloat16() for _ in range(2)]
    dy = torch.randn(b, s, h, p, generator=gen, device=cuda).bfloat16()
    way = ssd_kernel.bwd_route(torch.bfloat16, p, n)
    assert way == ("fma" if p % 8 or n % 8 else "wgmma")
    before = ssd_kernel.bwd_wgmma_launches
    got = ssd_ops._backward(x, dt, a, *bc, dy, None, (True,) * 5)
    assert ssd_kernel.bwd_wgmma_launches == before + (way == "wgmma")
    want = ssd_ops._backward(x, dt, a, *bc, dy, None, (True,) * 5, way="fma")
    tols = [TOL[torch.bfloat16], SSD_FP32_STORE_TOL, SSD_FP32_STORE_TOL, TOL[torch.bfloat16],
            TOL[torch.bfloat16]]
    for g, w, tol in zip(got, want, tols):
        scale = w.float().abs().max()
        torch.testing.assert_close(g.float(), w.float(), atol=tol * scale, rtol=0)


@pytest.mark.gpu
def test_ssm_train_steps_on_card_match_cpu(cuda):
    """fp32 REDUCED mamba2, two Trainer steps from the same params on the
    card (the SSD kernels forward, recompute and backward) and on the CPU:
    losses within 1e-4."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b", reduced=True), compute_dtype="float32")
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=100, global_batch=4)
    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        trainer = Trainer(build_model(cfg, device=dev), AdamWConfig(lr=1e-3, warmup_steps=2))
        params = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(), init)
        opt = adamw_init(params, trainer.opt_cfg)
        before = (ssd_kernel.launches, ssd_kernel.bwd_launches)
        losses[str(dev)] = []
        for i in range(2):
            params, opt, m = trainer.step(params, opt, pipe.global_batch_arrays(i))
            losses[str(dev)].append(float(m["loss"]))
        made = (ssd_kernel.launches - before[0], ssd_kernel.bwd_launches - before[1])
        assert made == ((4 * cfg.n_layers, 2 * cfg.n_layers) if dev == cuda else (0, 0))
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def _record_launches(monkeypatch):
    """(a contiguous, b contiguous) of every grouped matmul launch from now on."""
    seen = []
    launch = gmm_kernel.launch
    monkeypatch.setattr(gmm_kernel, "launch", lambda a, b, out: seen.append(
        (a.is_contiguous(), b.is_contiguous())) or launch(a, b, out))
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_gradients_on_card_match_cpu(cuda, dtype, monkeypatch):
    """dx and dw of ``gmm`` and every gradient of ``expert_ffn`` on the card
    (each product through the kernel) against the same autograd function on
    the CPU (each product the plain version); the backward's transposed
    operands reach the kernel as views, not copies."""
    rng = np.random.default_rng(4)
    e, c, d, f = 8, 72, 256, 128
    host = {"x": rng.normal(size=(e, c, d)), "w": rng.normal(size=(e, d, f)) / np.sqrt(d),
            "cot": rng.normal(size=(e, c, f)), "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
            "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
            "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f), "cot2": rng.normal(size=(e, c, d))}
    host = {k: torch.from_numpy(v.astype(np.float32)).to(dtype) for k, v in host.items()}
    seen = _record_launches(monkeypatch)
    grads = {}
    for dev in ("cpu", cuda):
        t = {k: v.to(dev).requires_grad_() for k, v in host.items()}
        seen.clear()
        g_gmm = torch.autograd.grad(gmm_ops.gmm(t["x"], t["w"]), (t["x"], t["w"]), t["cot"])
        ffn = {k: t[k] for k in ("w_gate", "w_up", "w_down")}
        out = gmm_ops.expert_ffn(ffn, t["x"])
        g_ffn = torch.autograd.grad(out, (t["x"], *ffn.values()), t["cot2"])
        grads[str(dev)] = g_gmm + g_ffn
        if dev == cuda:
            assert seen[:3] == [(True, True), (True, False), (False, True)]
            assert len(seen) == 3 + 9
    tol = 2e-4 if dtype == torch.float32 else 5 * TOL[dtype]
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_card.dtype == dtype
        torch.testing.assert_close(g_card.cpu().float(), g_cpu.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_backward_layouts_match_plain_version(cuda, dtype):
    """The backward's two products, dx = g w^T and dw = x^T g, with the
    transposed operand a view (and on views of larger buffers), against the
    plain version; the forward's tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    tol = 5 * TOL[dtype]
    for e, c, d, f in GMM_SHAPES + [(32, 640, 1024, 512), (32, 640, 512, 1024)]:
        for pad in (0, 2):
            def stored(rows, cols, scale=1.0):
                t = torch.randn(e + pad, rows + pad, cols + 8 * pad, generator=gen, device=cuda)
                return (t * scale).to(dtype)[pad:, pad:, 8 * pad:]
            x, w, g = stored(c, d), stored(d, f, d**-0.5), stored(c, f)
            for a, b in ((g, w.transpose(1, 2)), (x.transpose(1, 2), g)):
                before = gmm_kernel.launches
                out = gmm_ops.gmm(a, b)
                torch.cuda.synchronize()
                assert gmm_kernel.launches == before + 1
                ref = reference_grouped_matmul(a, b)
                torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_moe_train_steps_on_card_match_cpu(cuda):
    """fp32 REDUCED granite-moe, two Trainer steps from the same params on
    the card (flash and grouped matmul kernels, forward and backward) and
    on the CPU: losses within 1e-4."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", reduced=True),
                              compute_dtype="float32")
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=4)
    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        trainer = Trainer(build_model(cfg, device=dev), AdamWConfig(lr=1e-3, warmup_steps=2))
        params = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(), init)
        opt = adamw_init(params, trainer.opt_cfg)
        before = gmm_kernel.launches
        losses[str(dev)] = []
        for i in range(2):
            params, opt, m = trainer.step(params, opt, pipe.global_batch_arrays(i))
            losses[str(dev)].append(float(m["loss"]))
        assert gmm_kernel.launches - before == (2 * 12 * cfg.n_layers if dev == cuda else 0)
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.gpu
def test_train_steps_on_card_match_cpu(cuda):
    """fp32 REDUCED internlm2, two Trainer steps from the same params on the
    card (the flash kernels: forward, remat recompute and backward) and on
    the CPU: losses within 1e-4."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True), compute_dtype="float32")
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=4)
    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        trainer = Trainer(build_model(cfg, device=dev), AdamWConfig(lr=1e-3, warmup_steps=2))
        params = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(), init)
        opt = adamw_init(params, trainer.opt_cfg)
        before = (kernel.launches, kernel.bwd_launches)
        losses[str(dev)] = []
        for i in range(2):
            params, opt, m = trainer.step(params, opt, pipe.global_batch_arrays(i))
            losses[str(dev)].append(float(m["loss"]))
        made = (kernel.launches - before[0], kernel.bwd_launches - before[1])
        assert made == ((4 * cfg.n_layers, 2 * cfg.n_layers) if dev == cuda else (0, 0))
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_reads_fused_qkv_views(cuda, dtype):
    """q, k and v as strided views of one [B, S, H + 2 KV, D] buffer."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for b, s, h, kv, d, causal, window in FUSED_SHAPES:
        qkv = torch.randn(b, s, h + 2 * kv, d, generator=gen, device=cuda).to(dtype)
        q, k, v = qkv.split([h, kv, kv], dim=2)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = reference_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                                  window=window)
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_reads_strided_leading_dims(cuda, dtype):
    """x and w as views of larger buffers: rows, columns and experts at other
    strides, starting off the buffers' first element."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    for e, c, d, f in [(8, 8, 256, 128), (8, 65, 256, 128), (32, 8, 1024, 512), (4, 200, 512, 1024)]:
        x = torch.randn(e + 1, c + 6, d + 48, generator=gen, device=cuda).to(dtype)[1:, 3:3 + c, 24:24 + d]
        w = (torch.randn(e + 1, d + 2, f + 32, generator=gen, device=cuda) / d**0.5).to(dtype)
        w = w[1:, 1:1 + d, 16:16 + f]
        out = gmm_ops.gmm(x, w)
        ref = reference_grouped_matmul(x.contiguous(), w.contiguous())
        tol = 5 * TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain_version(cuda, dtype):
    """Tolerance 5 x the per-kernel one, as the JAX package's gmm sweep."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for e, c, d, f in GMM_SHAPES:
        x = torch.randn(e, c, d, generator=gen, device=cuda).to(dtype)
        w = (torch.randn(e, d, f, generator=gen, device=cuda) / d**0.5).to(dtype)
        before = gmm_kernel.launches
        out = gmm_ops.gmm(x, w)
        torch.cuda.synchronize()
        assert gmm_kernel.launches == before + 1
        ref = reference_grouped_matmul(x, w)
        tol = 5 * TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        # a strided view of the rows reads the same values
        view = gmm_ops.gmm(x[:, : (c + 1) // 2], w)
        torch.testing.assert_close(view, out[:, : (c + 1) // 2], atol=0, rtol=0)


@pytest.mark.gpu
def test_moe_prefill_and_decode_on_card_match_cpu(cuda):
    """fp32 REDUCED granite-moe: the card (both kernels) and the CPU (plain
    versions) give the same greedy tokens and logits within 1e-4."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", reduced=True),
                              compute_dtype="float32")
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (2, 96)))
    runs = []
    for model in (cpu_model, gpu_model):
        p = model.load(params)
        logits, caches = model.prefill(p, toks)
        caches = model.prepare_decode_caches(caches, 128)
        out = [logits[:, 0].cpu()]
        pos = torch.full((2,), 96, device=model.device)
        for _ in range(4):
            tok = out[-1].argmax(-1)[:, None].to(model.device)
            logits, caches = model.decode_step(p, caches, tok, pos, ragged=True)
            out.append(logits[:, 0].cpu())
            pos = pos + 1
        runs.append(torch.stack(out, 1))
    before = gmm_kernel.launches
    gpu_model.prefill(gpu_model.load(params), toks)
    assert gmm_kernel.launches == before + 3 * cfg.n_layers
    torch.testing.assert_close(runs[1], runs[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(runs[1].argmax(-1), runs[0].argmax(-1))


@pytest.mark.gpu
def test_prefill_on_card_matches_cpu(cuda):
    """fp32 REDUCED model: the card (kernel) and the CPU (plain version) give
    the same greedy token and logits within 1e-4 (summation order)."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True), compute_dtype="float32")
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (2, 96)))
    l_cpu, _ = cpu_model.prefill(cpu_model.load(params), toks)
    l_gpu, _ = gpu_model.prefill(gpu_model.load(params), toks)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, atol=1e-4, rtol=1e-4)
    assert torch.equal(l_gpu.argmax(-1).cpu(), l_cpu.argmax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(cuda, dtype):
    """Tolerance 20 x the per-kernel one, as the JAX package's SSD sweep; at
    ragged S also against the sequential recurrence."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    tol = 20 * TOL[dtype]
    for b, s, h, p, n, chunk in SSD_SHAPES:
        x = torch.randn(b, s, h, p, generator=gen, device=cuda).to(dtype)
        dt = torch.rand(b, s, h, generator=gen, device=cuda) * 0.2 + 0.001
        a = -(torch.rand(h, generator=gen, device=cuda) * 3.5 + 0.5)
        bb = torch.randn(b, s, n, generator=gen, device=cuda).to(dtype)
        cc = torch.randn(b, s, n, generator=gen, device=cuda).to(dtype)
        before = ssd_kernel.launches
        y, hf = ssd_ops.ssd(x, dt, a, bb, cc, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_kernel.launches == before + 1
        assert y.dtype == dtype and hf.dtype == torch.float32
        wants = [ssd_chunked(x, dt, a, bb, cc, chunk)]
        if s < 100:
            wants.append(reference_ssd(x, dt, a, bb, cc))
        for yr, hr in wants:
            torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(hf, hr, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(1, 866), (1, 114), (4, 512)])
def test_ssd_bf16_kernel_keeps_the_state_fp32_accurate(cuda, b, s):
    """At mamba2-1.3b's widths the tensor-core route's final state is within
    1e-4 of the fp32 plain version relative to its largest value (two bf16
    terms per fp32 factor; one term would give about 2e-3)."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn(b, s, 64, 64, generator=gen, device=cuda).bfloat16()
    dt = torch.rand(b, s, 64, generator=gen, device=cuda) * 0.2 + 0.001
    a = -(torch.rand(64, generator=gen, device=cuda) * 3.5 + 0.5)
    bb, cc = (torch.randn(b, s, 128, generator=gen, device=cuda).bfloat16() for _ in range(2))
    assert ssd_kernel.route(x.dtype, 64, 128) == "wgmma"
    _, hf = ssd_ops.ssd(x, dt, a, bb, cc)
    _, hr = ssd_chunked(x, dt, a, bb, cc, 256)
    assert ((hf - hr).abs().max() / hr.abs().max()).item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_zero_tiny_and_negative_dt(cuda, dtype):
    """Both routes compute the plain version's function for any dt: rows of
    dt = 0 (as past a ragged S), dt far below bf16's resolution, and dt < 0,
    with finite results."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, s, h, p, n = 2, 200, 4, 64, 128
    x = torch.randn(b, s, h, p, generator=gen, device=cuda).to(dtype)
    dt = torch.rand(b, s, h, generator=gen, device=cuda) * 0.2 + 0.001
    dt[:, ::7] = 0.0
    dt[:, 3::11] = 1e-30
    dt[:, 5::13] = -0.01
    a = -(torch.rand(h, generator=gen, device=cuda) * 3.5 + 0.5)
    bb, cc = (torch.randn(b, s, n, generator=gen, device=cuda).to(dtype) for _ in range(2))
    assert ssd_kernel.route(dtype, p, n) == ("wgmma" if dtype == torch.bfloat16 else "fma")
    y, hf = ssd_ops.ssd(x, dt, a, bb, cc)
    yr, hr = ssd_chunked(x, dt, a, bb, cc, 64)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(hf).all())
    tol = 20 * TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hf, hr, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_mamba2_prefill_and_decode_on_card_match_cpu(cuda):
    """fp32 REDUCED mamba2 at an exact prompt length: the card (the SSD
    kernel in prefill) and the CPU (plain version) give the same greedy
    tokens and logits within 1e-4."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b", reduced=True), compute_dtype="float32")
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (2, 97)))
    runs = []
    for model in (cpu_model, gpu_model):
        p = model.load(params)
        before = ssd_kernel.launches
        logits, caches = model.prefill(p, toks)
        assert ssd_kernel.launches == before + (cfg.n_layers if model is gpu_model else 0)
        out = [logits[:, 0].cpu()]
        pos = torch.full((2,), 97, device=model.device)
        for _ in range(4):
            tok = out[-1].argmax(-1)[:, None].to(model.device)
            logits, caches = model.decode_step(p, caches, tok, pos, ragged=True)
            out.append(logits[:, 0].cpu())
            pos = pos + 1
        runs.append(torch.stack(out, 1))
    torch.testing.assert_close(runs[1], runs[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(runs[1].argmax(-1), runs[0].argmax(-1))


# ---------------------------------------------------------------- jamba-v0.1-52b
JAMBA = get_config("jamba-v0.1-52b")


@pytest.mark.gpu
def test_jamba_shapes_of_each_kernel_match_plain_versions(cuda):
    """jamba-v0.1-52b's full-width shape of each kernel, bf16, against its
    plain version: flash attention at one prompt of 114 tokens (32 heads
    over 8 KV heads of 128, no window); the grouped matmul at the decode
    capacity C 2 of 16 experts, gate/up [16, 2, 4096] x [16, 4096, 14336]
    and down [16, 2, 14336] x [16, 14336, 4096] (one layer's weights, 1.88
    GB a product); the SSD scan at 128 heads of 64, state 16, on its wgmma
    route, the state also within 1e-4 of its largest value."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    bf16, s = torch.bfloat16, 114
    h, kv, d = JAMBA.n_heads, JAMBA.n_kv_heads, JAMBA.head_dim
    q = torch.randn(1, s, h, d, generator=gen, device=cuda).to(bf16)
    k, v = (torch.randn(1, s, kv, d, generator=gen, device=cuda).to(bf16) for _ in range(2))
    before = kernel.launches
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(out.float(), reference_attention(q, k, v, causal=True).float(),
                               atol=TOL[bf16], rtol=TOL[bf16])

    e, dm, f = JAMBA.moe.n_experts, JAMBA.d_model, JAMBA.moe.d_expert_ff
    c = max(int(JAMBA.moe.capacity_factor * 4 * JAMBA.moe.top_k / e), JAMBA.moe.top_k)
    assert c == 2  # 4 decode slots
    for din, dout in ((dm, f), (f, dm)):
        x = torch.randn(e, c, din, generator=gen, device=cuda).to(bf16)
        w = (torch.randn(e, din, dout, generator=gen, device=cuda) / din**0.5).to(bf16)
        before = gmm_kernel.launches
        out = gmm_ops.gmm(x, w)
        torch.cuda.synchronize()
        assert gmm_kernel.launches == before + 1
        tol = 5 * TOL[bf16]
        torch.testing.assert_close(out.float(), reference_grouped_matmul(x, w).float(),
                                   atol=tol, rtol=tol)
        del x, w, out
        torch.cuda.empty_cache()

    ssm = JAMBA.ssm
    nh = ssm.expand * dm // ssm.head_dim
    x = torch.randn(1, s, nh, ssm.head_dim, generator=gen, device=cuda).to(bf16)
    dt = torch.rand(1, s, nh, generator=gen, device=cuda) * 0.2 + 0.001
    a = -(torch.rand(nh, generator=gen, device=cuda) * 3.5 + 0.5)
    bb, cc = (torch.randn(1, s, ssm.state_dim, generator=gen, device=cuda).to(bf16)
              for _ in range(2))
    assert ssd_kernel.route(bf16, ssm.head_dim, ssm.state_dim) == "wgmma"
    before = ssd_kernel.launches
    y, hf = ssd_ops.ssd(x, dt, a, bb, cc)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    yr, hr = ssd_chunked(x, dt, a, bb, cc, ssm.chunk_size)
    tol = 20 * TOL[bf16]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    assert ((hf - hr).abs().max() / hr.abs().max()).item() <= 1e-4


@pytest.mark.gpu
def test_hybrid_prefill_and_decode_on_card_match_cpu(cuda):
    """fp32 REDUCED jamba (8 layers: 7 Mamba-2 and one attention layer, MoE
    on the odd ones): the card (all three kernels) and the CPU (their plain
    versions) give the same greedy tokens and logits within 1e-4, each
    prompt prefilled alone at its exact length."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", reduced=True),
                              compute_dtype="float32")
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (1, 96)))
    runs = []
    for model in (cpu_model, gpu_model):
        p = model.load(params)
        before = (kernel.launches, gmm_kernel.launches, ssd_kernel.launches)
        logits, caches = model.prefill(p, toks)
        made = (kernel.launches - before[0], gmm_kernel.launches - before[1],
                ssd_kernel.launches - before[2])
        assert made == ((1, 12, 7) if model is gpu_model else (0, 0, 0))
        caches = model.prepare_decode_caches(caches, 128)
        out = [logits[:, 0].cpu()]
        pos = torch.full((1,), 96, device=model.device)
        for _ in range(4):
            tok = out[-1].argmax(-1)[:, None].to(model.device)
            logits, caches = model.decode_step(p, caches, tok, pos, ragged=True)
            out.append(logits[:, 0].cpu())
            pos = pos + 1
        runs.append(torch.stack(out, 1))
    torch.testing.assert_close(runs[1], runs[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(runs[1].argmax(-1), runs[0].argmax(-1))


# ------------------------------------------------ phi-3-vision, seamless-m4t, minicpm3
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch,b,s", [("phi-3-vision-4.2b", 2, 832), ("phi-3-vision-4.2b", 8, 256),
                                      ("seamless-m4t-large-v2", 4, 64),
                                      ("seamless-m4t-large-v2", 8, 256)],
                         ids=["phi3v-frontend", "phi3v-train", "seamless-prefill",
                              "seamless-train"])
def test_flash_at_the_new_families_shapes_matches_plain_version(cuda, dtype, arch, b, s):
    """phi-3-vision's (32 heads over 32 KV heads of 96: no grouping, the bf16
    kernel's two 64-column boxes a quarter zero) and seamless's decoder
    (16 over 16 of 64) flash shapes, forward and backward, against the
    plain versions: the forward within the per-kernel tolerance, dq, dk
    and dv against ``attention_backward`` within 1e-4 (fp32) or 2e-2
    (bf16)."""
    cfg = get_config(arch)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=cuda).to(dtype) for n in (h, kv, kv))
    cot = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (kernel.launches, kernel.bwd_launches)
    out = ops.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, cot)
    assert (kernel.launches - before[0], kernel.bwd_launches - before[1]) == (1, 1)
    o_plain, lse_plain = attention_forward(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), o_plain.float(), atol=TOL[dtype], rtol=TOL[dtype])
    want = attention_backward(q, k, v, o_plain, lse_plain, cot, causal=True)
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3-4b", "phi-3-vision-4.2b", "seamless-m4t-large-v2"])
def test_new_families_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """fp32 REDUCED minicpm3 (MLA: no kernel), phi-3-vision with frontend
    rows and seamless with encoder frames (flash in the decoder's
    self-attention): the card and the CPU give the same greedy tokens and
    logits within 1e-4 over a prefill and 4 decode steps."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (2, 40)))}
    if cfg.enc_dec:
        batch["encoder_frames"] = torch.from_numpy(
            rng.normal(size=(2, 50, cfg.frontend.d_frontend)).astype(np.float32))
    elif cfg.frontend is not None:
        batch["frontend_embeds"] = torch.from_numpy(
            rng.normal(size=(2, cfg.frontend.n_tokens, cfg.frontend.d_frontend))
            .astype(np.float32))
    flash = 0 if cfg.attn_type == "mla" else cfg.n_layers
    runs = []
    for model in (cpu_model, gpu_model):
        p = model.load(params)
        before = kernel.launches
        logits, caches = model.prefill(p, {n: t.to(model.device) for n, t in batch.items()})
        assert kernel.launches == before + (flash if model is gpu_model else 0)
        caches = model.prepare_decode_caches(caches, 48)
        out = [logits[:, 0].cpu()]
        pos = torch.full((2,), 40, device=model.device)
        for _ in range(4):
            tok = out[-1].argmax(-1)[:, None].to(model.device)
            logits, caches = model.decode_step(p, caches, tok, pos, ragged=True)
            out.append(logits[:, 0].cpu())
            pos = pos + 1
        runs.append(torch.stack(out, 1))
    torch.testing.assert_close(runs[1], runs[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(runs[1].argmax(-1), runs[0].argmax(-1))


# one key of tests/test_golden_tables.py's GOLDEN_STREAMING, the JAX
# package's numpy streaming engine's frozen table
SIM_KEY = (8, 3, "light", 3, 2)
SIM_TABLE = [
    {"lvl": 1, "max_rds": 3, "avg_rds": 4.05, "max_avg_load": 3.62, "avg_hops": 3.76},
    {"lvl": 2, "max_rds": 1, "avg_rds": 2.0, "max_avg_load": 2.0, "avg_hops": 2.0},
    {"lvl": 3, "max_rds": 1, "avg_rds": 1.0, "max_avg_load": 2.0, "avg_hops": 1.0},
]


@pytest.mark.gpu
def test_streaming_simulator_on_card_reproduces_frozen_table(cuda):
    """The streaming simulator's draws are counter hashes, bit-equal on the
    card; its counts are int64: the frozen table and the CPU run's
    statistics hold exactly."""
    from repro_torch.core import CLEXTopology, simulate_point_to_point_streaming

    m, L, mode, seed, msgs = SIM_KEY
    runs = [simulate_point_to_point_streaming(CLEXTopology(m, L), msgs, mode=mode, seed=seed,
                                              chunk_size=100, device=dev)
            for dev in (cuda, "cpu")]
    assert runs[0].table() == SIM_TABLE
    assert [dataclasses.asdict(s) for s in runs[0].levels.values()] == \
        [dataclasses.asdict(s) for s in runs[1].levels.values()]
    assert np.array_equal(runs[0].lb_phase_histogram, runs[1].lb_phase_histogram)
    assert runs[0].edge_load == runs[1].edge_load
