"""Weights across the bridge between the JAX package and the port.

The JAX package keeps a decoder's layers scan-stacked: ``params["decoder"]``
is a tuple with one dict per pattern position ``j``, and when the pattern
repeats ``r > 1`` times every leaf carries a leading repeat dim (its
``stack_init``).  Layer ``i`` is repeat ``i // p``, position ``i % p``.  The
port keeps one dict per layer.  Leaves cross as numpy arrays; fp32 stays
bit-exact.  Only numpy is needed, so the port imports nothing of JAX here.

Caches are laid out the same way in the JAX package (a tuple with one
``{"mixer": ...}`` per pattern position, leaves repeat-stacked when ``r >
1``; ``src/repro/models/transformer.py:256-277``), while the port keeps one
flat dict whose leaves are stacked over the layers of each mixer kind
(``models/transformer.py``).  ``from_jax_caches`` and ``to_jax_caches`` map
one to the other, for the tests: the serving path never crosses.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.transformer import CACHE_KEYS, _kind_index, mixer_kind
from .tree import tree_map

__all__ = ["from_jax_params", "to_jax_params", "from_jax_caches", "to_jax_caches"]


def _period(cfg: ModelConfig, n_pattern: int) -> tuple[int, int]:
    if cfg.n_layers % n_pattern:
        raise ValueError(f"{n_pattern} pattern blocks do not tile {cfg.n_layers} layers")
    return n_pattern, cfg.n_layers // n_pattern


def from_jax_params(cfg: ModelConfig, tree: dict) -> dict:
    """JAX params (numpy leaves, or arrays numpy can read) -> port params as
    CPU tensors; ``Model.load`` puts them on the model's device.  Leaves keep
    their dtype."""
    to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    p, r = _period(cfg, len(tree["decoder"]))
    layers = []
    for i in range(cfg.n_layers):
        rep, j = divmod(i, p)
        block = tree["decoder"][j]
        layers.append(tree_map(lambda a: to_t(np.asarray(a)[rep] if r > 1 else a), block))
    out = {k: to_t(v) for k, v in tree.items() if k != "decoder"}
    out["layers"] = layers
    return out


def to_jax_params(cfg: ModelConfig, params: dict) -> dict:
    """Port params -> the JAX package's layout, with numpy leaves."""
    p = cfg.pattern_period()
    r = cfg.n_layers // p
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    pattern = []
    for j in range(p):
        rows = [params["layers"][rep * p + j] for rep in range(r)]
        if r > 1:
            pattern.append(tree_map(lambda *ts: np.stack([to_np(t) for t in ts]), *rows))
        else:
            pattern.append(tree_map(to_np, rows[0]))
    out = {k: to_np(v) for k, v in params.items() if k != "layers"}
    out["decoder"] = tuple(pattern)
    return out


def _cache_np(a) -> np.ndarray:
    """A cache leaf as numpy; a bf16 tensor as its bits in a uint16 view."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.uint16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def from_jax_caches(cfg: ModelConfig, caches) -> dict:
    """JAX caches (the tuple of pattern positions) -> the port's flat dict,
    each leaf a numpy array stacked over the layers of its mixer kind in
    layer order: ``k``, ``v``, ``pos`` over the attention layers, ``conv_*``
    and ``h`` over the SSM layers."""
    p, r = _period(cfg, len(caches))
    rows = {}
    for i in range(cfg.n_layers):
        rep, j = divmod(i, p)
        mixer = caches[j]["mixer"]
        for name in CACHE_KEYS[mixer_kind(cfg, i)]:
            leaf = np.asarray(mixer[name])
            rows.setdefault(name, []).append(leaf[rep] if r > 1 else leaf)
    return {name: np.stack(ls) for name, ls in rows.items()}


def to_jax_caches(cfg: ModelConfig, caches: dict) -> tuple:
    """The port's flat caches (tensors or numpy) -> the JAX package's
    layout, with numpy leaves (bf16 tensors as uint16 views)."""
    p = cfg.pattern_period()
    r = cfg.n_layers // p
    layers = [{n: _cache_np(caches[n][k]) for n in CACHE_KEYS[kind]}
              for kind, k in _kind_index(cfg)]
    pattern = []
    for j in range(p):
        rows = [layers[rep * p + j] for rep in range(r)]
        mixer = ({n: np.stack([row[n] for row in rows]) for n in rows[0]} if r > 1 else rows[0])
        pattern.append({"mixer": mixer})
    return tuple(pattern)
