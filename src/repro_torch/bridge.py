"""Weights across the bridge between the JAX package and the port.

The JAX package keeps a decoder's layers scan-stacked: ``params["decoder"]``
is a tuple with one dict per pattern position ``j``, and when the pattern
repeats ``r > 1`` times every leaf carries a leading repeat dim (its
``stack_init``).  Layer ``i`` is repeat ``i // p``, position ``i % p``.  The
port keeps one dict per layer.  An encoder-decoder's ``params["encoder"]``
is laid out the same way with a period of 1 (one dict, its leaves stacked
over the encoder layers when there are more than one), and is a list of
layers in the port.  Leaves cross as numpy arrays; fp32 stays bit-exact.
Only numpy is needed, so the port imports nothing of JAX here.

Caches are laid out the same way in the JAX package (a tuple with one
``{"mixer": ...[, "cross": {"k", "v"}]}`` per pattern position, leaves
repeat-stacked when ``r > 1``; ``src/repro/models/transformer.py:256-277``),
while the port keeps one flat dict whose leaves are stacked over the layers
of each mixer kind, an encoder-decoder's cross K/V as ``cross_k`` and
``cross_v`` over all its decoder layers (``models/transformer.py``).
``from_jax_caches`` and ``to_jax_caches`` map one to the other, for the
tests: the serving path never crosses.

On a mesh (``launch/mesh.py``) ``from_jax_params(cfg, tree, mesh)`` hands
the calling rank its block of every leaf, ``runtime/sharding.py``'s
``reshard_params`` of the port's tree under ``Model.param_axes``: the
block the reference's ``reshard_params`` leaves on the device at the
rank's place in a JAX mesh of the same shape.  ``from_jax_opt_state`` does
the same for the reference's AdamW state (``m`` and ``v`` as the
reference's ``opt_state_shardings`` places them, the params' blocks; a
compressed trainer's ``err`` as the rank's row), so that a step on ranks
can start from the reference's state; ``gather_blocks`` puts the blocks of
the ranks of a ``model`` slice back together into whole leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.model import Model
from .models.transformer import CACHE_KEYS, CROSS_KEYS, _kind_index, mixer_kind
from .runtime.sharding import map_blocks, reshard_params
from .tree import tree_map

__all__ = ["from_jax_params", "to_jax_params", "reference_leaves", "port_leaves", "from_jax_caches",
           "to_jax_caches", "from_jax_opt_state", "port_order", "gather_blocks"]


def _period(cfg: ModelConfig, n_pattern: int) -> tuple[int, int]:
    if cfg.n_layers % n_pattern:
        raise ValueError(f"{n_pattern} pattern blocks do not tile {cfg.n_layers} layers")
    return n_pattern, cfg.n_layers // n_pattern


def _stack_rows(layers: list, p: int) -> tuple:
    """One tree per layer -> a tree per pattern position, each leaf stacked
    over the pattern's repeats (when it repeats)."""
    r = len(layers) // p
    return tuple(tree_map(lambda *ts: torch.stack(ts), *layers[j::p]) if r > 1 else layers[j]
                 for j in range(p))


def reference_leaves(cfg: ModelConfig, tree: dict) -> dict:
    """``tree`` (mirroring a model's params: the params, their gradients or
    moments) in the JAX package's layout: ``layers`` as ``decoder`` (and
    ``encoder``, of period 1), scan-stacked; new tensors where layers stack."""
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    if "encoder" in tree:
        out["encoder"] = _stack_rows(tree["encoder"], 1)
    out["decoder"] = _stack_rows(tree["layers"], cfg.pattern_period())
    return out


def _unstack_rows(pattern: tuple, n_layers: int) -> list:
    p = len(pattern)
    r = n_layers // p
    return [tree_map(lambda t, rep=i // p: t[rep], pattern[i % p]) if r > 1 else pattern[i % p]
            for i in range(n_layers)]


def port_leaves(cfg: ModelConfig, tree: dict) -> dict:
    """The inverse of ``reference_leaves``: one tree per layer (views of
    the stacked tensors)."""
    out = {k: v for k, v in tree.items() if k not in ("decoder", "encoder")}
    if "encoder" in tree:
        out["encoder"] = _unstack_rows(tree["encoder"], cfg.n_encoder_layers)
    out["layers"] = _unstack_rows(tree["decoder"], cfg.n_layers)
    return out


def from_jax_params(cfg: ModelConfig, tree: dict, mesh=None) -> dict:
    """JAX params (numpy leaves, or arrays numpy can read) -> port params as
    CPU tensors; ``Model.load`` puts them on the model's device.  Leaves keep
    their dtype.  With ``mesh``, this rank's block of each leaf."""
    _period(cfg, len(tree["decoder"]))
    tensors = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    params = tree_map(torch.clone, port_leaves(cfg, tensors))
    if mesh is None:
        return params
    return reshard_params(Model(cfg, device="cpu").param_axes(), params, mesh)


def port_order(cfg: ModelConfig, tree: dict) -> dict:
    """``tree`` (mirroring a model's params) with its dict entries in the
    order of ``Model.init``'s tree, which the port's optimizer state
    follows (a tree from numpy's side of the bridge has JAX's sorted
    keys)."""
    def walk(axes, t):
        if isinstance(axes, dict):
            return {k: walk(axes[k], t[k]) for k in axes}
        if isinstance(axes, list):
            return [walk(a, x) for a, x in zip(axes, t)]
        return t
    return walk(Model(cfg, device="cpu").param_axes(), tree)


def from_jax_opt_state(cfg: ModelConfig, state: dict, mesh=None) -> dict:
    """The reference's AdamW state (numpy leaves) -> the port's: ``step``
    a Python int, ``m`` and ``v`` as ``from_jax_params`` hands the params
    (with ``mesh``, this rank's blocks) in ``port_order``, and a compressed
    trainer's ``err`` (the reference's ``[dp_total, ...]`` rows of its
    stacked leaves) as the ``[1, ...]`` row at the rank's (pod, data)
    index."""
    out = {"step": int(np.asarray(state["step"]))}
    for name in ("m", "v"):
        out[name] = port_order(cfg, from_jax_params(cfg, state[name], mesh))
    if "err" in state:
        row = 0 if mesh is None else mesh.axis_index(mesh.data_parallel_axes)
        like = reference_leaves(cfg, out["m"])
        out["err"] = tree_map(lambda _, e: torch.from_numpy(np.array(e)[row:row + 1]), like,
                              state["err"])
    return out


def gather_blocks(blocks: list, dims):
    """The whole leaves of ``blocks``, the trees of the ranks of one
    ``model`` slice in rank order: each leaf that ``dims`` (mirroring the
    trees, or a prefix of them; ``Trainer.dims``) names as split over
    ``model`` concatenated along that dim, any other taken from the first
    tree."""
    return map_blocks(lambda d, *bs: torch.cat([torch.as_tensor(b) for b in bs], dim=d), dims,
                      *blocks)


def to_jax_params(cfg: ModelConfig, params: dict) -> dict:
    """Port params -> the JAX package's layout, with numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), reference_leaves(cfg, params))


def _cache_np(a) -> np.ndarray:
    """A cache leaf as numpy; a bf16 tensor as its bits in a uint16 view."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.uint16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def from_jax_caches(cfg: ModelConfig, caches) -> dict:
    """JAX caches (the tuple of pattern positions) -> the port's flat dict,
    each leaf a numpy array stacked over the layers of its mixer kind in
    layer order: ``k``, ``v``, ``pos`` over the attention layers, ``ckv``,
    ``k_rope``, ``pos`` over MLA layers, ``conv_*`` and ``h`` over the SSM
    layers, and an encoder-decoder's ``cross_k``, ``cross_v`` over every
    layer."""
    p, r = _period(cfg, len(caches))
    rows = {}
    for i in range(cfg.n_layers):
        rep, j = divmod(i, p)
        leaves = {n: caches[j]["mixer"][n] for n in CACHE_KEYS[mixer_kind(cfg, i)]}
        if cfg.enc_dec:
            leaves.update({n: caches[j]["cross"][n[len("cross_"):]] for n in CROSS_KEYS})
        for name, leaf in leaves.items():
            leaf = np.asarray(leaf)
            rows.setdefault(name, []).append(leaf[rep] if r > 1 else leaf)
    return {name: np.stack(ls) for name, ls in rows.items()}


def to_jax_caches(cfg: ModelConfig, caches: dict) -> tuple:
    """The port's flat caches (tensors or numpy) -> the JAX package's
    layout, with numpy leaves (bf16 tensors as uint16 views)."""
    p = cfg.pattern_period()
    r = cfg.n_layers // p
    layers = []
    for i, (kind, k) in enumerate(_kind_index(cfg)):
        layer = {"mixer": {n: _cache_np(caches[n][k]) for n in CACHE_KEYS[kind]}}
        if cfg.enc_dec:
            layer["cross"] = {n[len("cross_"):]: _cache_np(caches[n][i]) for n in CROSS_KEYS}
        layers.append(layer)
    pattern = []
    for j in range(p):
        rows = [layers[rep * p + j] for rep in range(r)]
        pattern.append({part: ({n: np.stack([row[part][n] for row in rows]) for n in rows[0][part]}
                               if r > 1 else rows[0][part]) for part in rows[0]})
    return tuple(pattern)
