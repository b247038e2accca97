"""Tests of the port that need a CUDA card; each skips without one.  This
file imports no JAX, so that it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.models import build_model

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SHAPES = [  # b, s, h, kv, d, causal, window
    (2, 256, 4, 2, 64, True, 0),
    (1, 512, 8, 8, 32, True, 0),
    (2, 256, 4, 1, 64, True, 64),
    (1, 128, 2, 2, 128, False, 0),
    (1, 384, 6, 3, 64, True, 128),
    (1, 1000, 16, 8, 128, True, 0),
    (2, 77, 32, 8, 80, True, 64),
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
