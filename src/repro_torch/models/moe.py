"""Mixture-of-Experts layer on one device.

Counterpart of the JAX package's ``models/moe.py`` single-device path:
top-k routing, capacity-based dispatch into per-expert buckets, the expert
SwiGLU through ``kernels.moe_gmm`` (the hand-written kernel on the card, its
plain version on the CPU), and the weighted combine.  The expert-parallel
paths (all-to-all and replicated experts) wait for the multi-device work.

Routing and dispatch reproduce the reference exactly: the same experts (ties
go to the lower expert index, as ``jax.lax.top_k`` does), the same bucket
slots and the same capacity drops.  Capacity counts every token of the call,
so right-pad positions of a prefill group and the idle slots of a decode
step route and take capacity, as in the reference.  Nothing here uses
atomics or a scatter with repeated indices into values that are read, so a
run on the card repeats bit for bit.  That holds for the backward too: the
two gathers' gradients (a token fills up to k bucket rows; dropped
assignments all read row 0) accumulate through ``index_put_`` with
``accumulate=True``, which PyTorch runs on CUDA by sorting the indices,
deterministically, and the grouped matmul's backward is two more products
of the kernel, which sums in a fixed order.

The load-balancing loss is the reference's Switch loss, differentiable
through the router's probabilities (the top expert's one-hot is constant);
the model adds 0.01 of it, summed over the layers, to the training loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.moe_gmm import ops as gmm_ops
from .layers import dense_init

__all__ = ["moe_init", "capacity", "router_topk", "moe_local", "moe_apply"]


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    """Router [D, E] and expert weights [E, D, F], [E, F, D].  As in the
    reference, ``dense_init`` takes the leading dim (E) as the expert
    weights' fan-in."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_expert_ff, moe.n_experts
    return {
        "router": dense_init(gen, (d, e), dtype, scale=0.02),
        "w_gate": dense_init(gen, (e, d, f), dtype),
        "w_up": dense_init(gen, (e, d, f), dtype),
        "w_down": dense_init(gen, (e, f, d), dtype),
    }


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Bucket rows per expert for a call over ``tokens`` tokens."""
    moe = cfg.moe
    return max(int(moe.capacity_factor * tokens * moe.top_k / moe.n_experts), moe.top_k)


def router_topk(router_w: torch.Tensor, x_flat: torch.Tensor, top_k: int):
    """Returns (weights [T,k], experts [T,k], aux_loss scalar): softmax over
    all experts, the top k renormalised; the Switch load-balancing loss."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps tied experts in index order, as top_k does
    weights, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = weights[:, :top_k], experts[:, :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    e = logits.shape[-1]
    onehot = F.one_hot(experts[:, 0], e).float()
    aux = e * (onehot.mean(0) * probs.mean(0)).mean()
    return weights, experts, aux


def _dispatch_indices(experts: torch.Tensor, cap: int):
    """(flat_e [T*k], slot [T*k]): the bucket row of each (token, k)
    assignment, its rank among the assignments to the same expert in (token,
    k) order; -1 where the rank reaches ``cap`` (dropped)."""
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(flat_e.numel(), device=flat_e.device)
    new_seg = torch.ones_like(sorted_e, dtype=torch.bool)
    new_seg[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), dim=0).values
    rank = (idx - seg_start)[inv]
    slot = torch.where(rank < cap, rank, -1)
    return flat_e, slot


def moe_local(params: dict, x_flat: torch.Tensor, cfg: ModelConfig):
    """MoE over the tokens of one device.  x_flat [T, D] -> ([T, D], aux)."""
    moe = cfg.moe
    t, d = x_flat.shape
    e, k = moe.n_experts, moe.top_k
    weights, experts, aux = router_topk(params["router"], x_flat, k)
    cap = capacity(cfg, t)
    flat_e, slot = _dispatch_indices(experts, cap)
    keep = slot >= 0
    row = torch.where(keep, flat_e * cap + slot, 0)  # bucket row, flattened
    token_of = torch.arange(t, device=x_flat.device).repeat_interleave(k)

    # The buckets as a gather: each bucket row names the token that fills it
    # (or token t, a row of zeros).  Kept assignments own distinct rows; the
    # dropped ones all write one discard entry past the end, which is cut off.
    src = torch.full((e * cap + 1,), t, dtype=torch.long, device=x_flat.device)
    src[torch.where(keep, row, e * cap)] = token_of
    x_pad = torch.cat([x_flat, x_flat.new_zeros(1, d)])
    buckets = x_pad[src[:-1]].view(e, cap, d)

    out_buckets = gmm_ops.expert_ffn(params, buckets)
    gathered = out_buckets.view(e * cap, d)[row]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    w = weights.reshape(-1, 1).to(x_flat.dtype)
    # each token's k contributions, summed in one reduction (no atomics)
    return (gathered * w).view(t, k, d).sum(1), aux


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """[B, S, D] -> ([B, S, D], aux)."""
    b, s, d = x.shape
    out, aux = moe_local(params, x.reshape(b * s, d), cfg)
    return out.reshape(b, s, d), aux
