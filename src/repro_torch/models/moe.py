"""Mixture-of-Experts layer: one device, and expert parallelism on a mesh.

Counterpart of the JAX package's ``models/moe.py``: top-k routing,
capacity-based dispatch into per-expert buckets, the expert SwiGLU through
``kernels.moe_gmm`` (the hand-written kernel on the card, its plain
version on the CPU), and the weighted combine.

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

On a mesh with a ``model`` axis of ``m`` each rank holds ``E/m`` experts
(the sharding rules' ``experts``) and the whole router, and ``moe_apply``
takes the reference's path:

* ``moe_sharded_a2a`` where the call's ``T`` tokens split into ``dp * m``
  blocks of at least ``top_k`` (prefill shapes): the flattened tokens in
  contiguous blocks over ``(pod, data, model)``, row-major; each rank
  routes its block with capacity from the block, fills ``[E, C, D]``
  buckets, and an all-to-all over ``model`` alone (the paper's CLEX level-1
  hop) hands each rank ``[E/m, m C, D]`` of its experts; their FFN, the
  reverse all-to-all and the combine; the blocks are gathered again over
  ``(pod, data, model)``;
* ``moe_replicated_ep`` otherwise (decode shapes): the tokens split over
  the data-parallel axes where they divide, else whole; each rank runs its
  ``E/m`` experts over its tokens and the partial outputs are summed over
  ``model``, then the blocks gathered over the data-parallel axes.

Capacity is reckoned per rank from its tokens, so the output depends on the
mesh's shape, as the reference's does.  Each rank's expert FFN is the
grouped-matmul kernel (the reference computes these two paths with XLA
einsums: the same grouped product).  The reference's Valiant shuffle
(with ``cfg.moe.valiant_shuffle`` and a training key, the all-to-all path
rolls each block of tokens by ``jax.random.randint(key, (), 0, T_block)``
first and rolls the output back) draws its shift with the port's copy of
that draw (``core/threefry.py``) from the key's two uint32 words: every
rank holds the same key and draws the same shift, with no communication.
Serving passes no key, and without one there is no shift.  ``aux`` is
each rank's load-balancing loss, averaged over the ranks.

In training (the model on ``mesh.over("model")``, each rank's rows its
data-parallel block) the backward follows ``core/collectives.py``'s
convention.  On the all-to-all path the whole tokens are read through
``replicate`` before the rank takes its block, and so is the router, which
routes only that block; the all-to-alls go back by the reverse
all-to-all, the gathered output and ``aux`` give each rank its slice of
their gradients, and the experts' dx and dw are the grouped-matmul
kernel's.  On the replicated path every rank routes the same tokens, so
the routing is whole; the tokens that fill the rank's buckets and the
combine weights of its experts are read through ``replicate``, and the
partial outputs' sum passes its gradient through.

The load-balancing loss is the reference's Switch loss, differentiable
through the router's probabilities (the top expert's one-hot is constant);
the model adds 0.01 of it, summed over the layers, to the training loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import collectives as col
from ..core import threefry
from ..kernels.moe_gmm import ops as gmm_ops
from ..runtime.sharding import model_split_dim
from .layers import dense_init
from .layers import model_axis as _model_axis

__all__ = ["moe_init", "capacity", "router_topk", "moe_local", "moe_sharded_a2a",
           "moe_replicated_ep", "moe_apply"]

MOE_AXES = {"router": ("embed", None), "w_gate": ("experts", "embed", "ff"),
            "w_up": ("experts", "embed", "ff"), "w_down": ("experts", "ff", "embed")}


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


def _fill(x_flat: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
          first: int, n: int, cap: int, k: int):
    """Buckets [n, cap, D] of experts ``[first, first + n)`` as a gather:
    each bucket row names the token that fills it (or token T, a row of
    zeros).  Kept assignments own distinct rows; the others all write one
    discard entry past the end, which is cut off.  Returns (buckets, each
    assignment's flattened bucket row, 0 where not kept)."""
    t, d = x_flat.shape
    row = torch.where(keep, (flat_e - first) * cap + slot, 0)
    token_of = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    src = torch.full((n * cap + 1,), t, dtype=torch.long, device=x_flat.device)
    src[torch.where(keep, row, n * cap)] = token_of
    x_pad = torch.cat([x_flat, x_flat.new_zeros(1, d)])
    return x_pad[src[:-1]].view(n, cap, d), row


def _combine(out_rows: torch.Tensor, row, keep, weights, t: int, k: int) -> torch.Tensor:
    """Each token's k weighted expert outputs (0 where dropped), summed in
    one reduction (no atomics)."""
    d = out_rows.shape[-1]
    gathered = out_rows[row]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    w = weights.reshape(-1, 1).to(out_rows.dtype)
    return (gathered * w).view(t, k, d).sum(1)


def _route(params: dict, x_flat: torch.Tensor, cfg: ModelConfig):
    """(weights, flat_e, slot, aux, capacity) of a call over ``x_flat``'s tokens."""
    weights, experts, aux = router_topk(params["router"], x_flat, cfg.moe.top_k)
    cap = capacity(cfg, x_flat.shape[0])
    flat_e, slot = _dispatch_indices(experts, cap)
    return weights, flat_e, slot, aux, cap


def moe_local(params: dict, x_flat: torch.Tensor, cfg: ModelConfig):
    """MoE over the tokens of one device.  x_flat [T, D] -> ([T, D], aux)."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    weights, flat_e, slot, aux, cap = _route(params, x_flat, cfg)
    keep = slot >= 0
    buckets, row = _fill(x_flat, flat_e, slot, keep, 0, e, cap, k)
    out_buckets = gmm_ops.expert_ffn(params, buckets)
    return _combine(out_buckets.view(e * cap, -1), row, keep, weights, x_flat.shape[0], k), aux


def moe_sharded_a2a(params: dict, x_flat: torch.Tensor, cfg: ModelConfig, *,
                    model_axis: str = "model", key=None, mesh):
    """Token-sharded expert parallelism: x_flat [T_local, D] is this rank's
    block of distinct tokens, ``params`` its ``E/m`` experts and the whole
    router.  Local buckets [E, C, D] -> all-to-all over ``model_axis`` ->
    [E/m, m C, D] -> the expert FFN -> the reverse all-to-all -> combine.
    With ``cfg.moe.valiant_shuffle`` and a ``key`` (two uint32 words, the
    reference's key data) the block is rolled by ``randint(key, 0,
    T_local)`` first and the output rolled back.  Returns (out [T_local,
    D], aux [1])."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = x_flat.shape[0]
    m = mesh.axis_size(model_axis)
    shift = 0
    if cfg.moe.valiant_shuffle and key is not None:
        shift = threefry.randint(key, 0, t)
        x_flat = torch.roll(x_flat, shift, 0)
    # the router is whole on every rank, which routes only its block
    params = {**params, "router": col.replicate(params["router"], model_axis, mesh=mesh)}
    weights, flat_e, slot, aux, cap = _route(params, x_flat, cfg)
    keep = slot >= 0
    buckets, row = _fill(x_flat, flat_e, slot, keep, 0, e, cap, k)
    # the CLEX level-1 hop: expert block j of every rank to rank j, which
    # lays the ranks' buckets side by side along capacity
    recv = col.all_to_all(buckets, model_axis, mesh=mesh)  # [m * E/m, C, D], source-major
    mine = recv.view(m, e // m, cap, -1).transpose(0, 1).reshape(e // m, m * cap, -1)
    out_mine = gmm_ops.expert_ffn(params, mine)
    back = out_mine.view(e // m, m, cap, -1).transpose(0, 1).contiguous()
    out_buckets = col.all_to_all(back.view(e, cap, -1), model_axis, mesh=mesh)
    out = _combine(out_buckets.view(e * cap, -1), row, keep, weights, t, k)
    return (torch.roll(out, -shift, 0) if shift else out), aux[None]


def moe_replicated_ep(params: dict, x_flat: torch.Tensor, cfg: ModelConfig, *,
                      model_axis: str = "model", mesh):
    """Replicated-token expert parallelism (decode shapes): every rank of the
    ``model_axis`` slice holds the same tokens x_flat [T_dp, D], runs only
    its ``E/m`` experts over them (capacity from ``T_dp``), and the partial
    outputs are summed over the slice.  Returns (out [T_dp, D], aux [1])."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    m, j = mesh.axis_size(model_axis), mesh.axis_index(model_axis)
    e_local = e // m
    weights, flat_e, slot, aux, cap = _route(params, x_flat, cfg)
    mine = (slot >= 0) & (flat_e >= j * e_local) & (flat_e < (j + 1) * e_local)
    # the routing is whole on every rank; the rank's buckets and combine are its own
    rep = lambda t: col.replicate(t, model_axis, mesh=mesh)  # noqa: E731
    buckets, row = _fill(rep(x_flat), flat_e, slot, mine, j * e_local, e_local, cap, k)
    out_buckets = gmm_ops.expert_ffn(params, buckets)
    partial = _combine(out_buckets.view(e_local * cap, -1), row, mine, rep(weights),
                       x_flat.shape[0], k)
    return col.psum(partial, model_axis, mesh=mesh), aux[None]


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *, key=None, mesh=None,
              rows=None):
    """[B, S, D] -> ([B, S, D], aux).  Without a ``model`` axis above 1 the
    one-device ``moe_local`` on all tokens; otherwise the reference's choice
    between the two expert-parallel paths (see the module's doc).  ``rows``
    is a mesh whose data-parallel ranks each hold their own rows of the
    batch in ``x`` (training where the ``model`` axis is 1): the reference
    routes the rows of all of them as one block, so they are gathered over
    its data-parallel axes, ``moe_local`` runs on them all, and each rank
    keeps the output of its rows (their gradient summed over the ranks, as
    the aux loss reads every rank's rows)."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    m, _ = _model_axis(mesh)
    if m == 1:
        dp_axes = rows.data_parallel_axes if rows is not None else ()
        if not dp_axes or rows.axis_size(dp_axes) == 1:
            out, aux = moe_local(params, x_flat, cfg)
            return out.reshape(b, s, d), aux
        every = col.all_gather(x_flat, dp_axes, tiled=True, mesh=rows, grad="sum")
        out, aux = moe_local(params, every, cfg)
        i = rows.axis_index(dp_axes)
        return out[i * b * s:(i + 1) * b * s].reshape(b, s, d), aux
    moe = cfg.moe
    if model_split_dim(MOE_AXES["w_gate"], (moe.n_experts, d, moe.d_expert_ff), mesh) != 0:
        raise NotImplementedError(f"{cfg.name}: {cfg.moe.n_experts} experts do not split over "
                                  f"a model axis of {m}")
    dp_axes = mesh.data_parallel_axes
    dp = mesh.axis_size(dp_axes) if dp_axes else 1
    every = (*dp_axes, "model")
    tokens = b * s
    if tokens % (dp * m) == 0 and tokens // (dp * m) >= cfg.moe.top_k:
        n = tokens // (dp * m)
        i = mesh.axis_index(every)
        x_flat = col.replicate(x_flat, "model", mesh=mesh)  # each rank takes its block
        out, aux = moe_sharded_a2a(params, x_flat[i * n:(i + 1) * n], cfg, key=key, mesh=mesh)
        out = col.all_gather(out, every, tiled=True, mesh=mesh, grad="slice")
        aux = col.all_gather(aux, every, tiled=True, mesh=mesh, grad="slice")
    else:
        split = dp > 1 and tokens % dp == 0 and tokens >= dp
        n = tokens // dp if split else tokens
        i = mesh.axis_index(dp_axes) if split else 0
        out, aux = moe_replicated_ep(params, x_flat[i * n:(i + 1) * n], cfg, mesh=mesh)
        if split:
            out = col.all_gather(out, dp_axes, tiled=True, mesh=mesh)
            aux = col.all_gather(aux, dp_axes, tiled=True, mesh=mesh)
    return out.reshape(b, s, d), aux.mean()
