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
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.transformer import CACHE_KEYS, CROSS_KEYS, _kind_index, mixer_kind
from .tree import tree_map

__all__ = ["from_jax_params", "to_jax_params", "from_jax_caches", "to_jax_caches"]


def _period(cfg: ModelConfig, n_pattern: int) -> tuple[int, int]:
    if cfg.n_layers % n_pattern:
        raise ValueError(f"{n_pattern} pattern blocks do not tile {cfg.n_layers} layers")
    return n_pattern, cfg.n_layers // n_pattern


def _unstack(pattern, n_layers: int) -> list:
    """A scan-stacked JAX stack (a tuple of pattern positions) -> one dict
    of CPU tensors per layer."""
    p, r = len(pattern), n_layers // len(pattern)

    def layer(i):
        rep = i // p
        return tree_map(lambda a: torch.from_numpy(np.array(np.asarray(a)[rep] if r > 1 else a)),
                        pattern[i % p])

    return [layer(i) for i in range(n_layers)]


def _stack(layers: list, p: int) -> tuple:
    """One dict per layer -> the JAX layout of period ``p``, numpy leaves."""
    r = len(layers) // p
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    pattern = []
    for j in range(p):
        rows = [layers[rep * p + j] for rep in range(r)]
        if r > 1:
            pattern.append(tree_map(lambda *ts: np.stack([to_np(t) for t in ts]), *rows))
        else:
            pattern.append(tree_map(to_np, rows[0]))
    return tuple(pattern)


def from_jax_params(cfg: ModelConfig, tree: dict) -> dict:
    """JAX params (numpy leaves, or arrays numpy can read) -> port params as
    CPU tensors; ``Model.load`` puts them on the model's device.  Leaves keep
    their dtype."""
    _period(cfg, len(tree["decoder"]))
    out = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()
           if k not in ("decoder", "encoder")}
    if "encoder" in tree:
        out["encoder"] = _unstack(tree["encoder"], cfg.n_encoder_layers)
    out["layers"] = _unstack(tree["decoder"], cfg.n_layers)
    return out


def to_jax_params(cfg: ModelConfig, params: dict) -> dict:
    """Port params -> the JAX package's layout, with numpy leaves."""
    out = {k: v.detach().cpu().numpy() for k, v in params.items()
           if k not in ("layers", "encoder")}
    if "encoder" in params:
        out["encoder"] = _stack(params["encoder"], 1)
    out["decoder"] = _stack(params["layers"], cfg.pattern_period())
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
