"""Plain PyTorch version of the grouped expert matmul: the CPU path of
``ops.gmm`` and the oracle the CUDA kernel is held against on the card.  Same
arithmetic as the JAX package's ``moe_gmm/ref.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reference_grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, C, D] x [E, D, F] -> [E, C, F]: fp32 products and sums, the result
    cast to ``x.dtype``."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def reference_expert_ffn(params: dict, buckets: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU over capacity buckets [E, C, D] -> [E, C, D], with
    the weights cast to the buckets' dtype and the products in it."""
    dt = buckets.dtype
    wg, wu, wd = (params[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("ecd,edf->ecf", buckets, wg)) * torch.einsum(
        "ecd,edf->ecf", buckets, wu
    )
    return torch.einsum("ecf,efd->ecd", h, wd)
