"""Checkpoints of the port's trees: atomic, self-validating, keep-N, async.

Counterpart of the JAX package's ``checkpoint/checkpointing.py``, on its
on-disk format: ``<dir>/step_%010d`` directories written through
``<dir>/tmp.<step>`` and one atomic rename, each holding ``arrays.npz`` (a
full array per leaf) and ``manifest.json`` (each leaf's shape, dtype and
sha256, and a whole-tree checksum made from the leaf digests); pruning keeps
the newest ``keep`` steps; ``restore_checkpoint(step=None)`` walks back to
the newest intact step, and an explicit damaged step raises.

Leaves are named as ``jax.tree_util.keystr`` names them (``['m']['layers']
[0]['wq']``; a tuple ``(params, opt)`` gives ``[0]['embed']``), so a tree of
dicts, lists and tuples written by either package passes the other's
``verify_checkpoint`` and restores there.  A leaf is a tensor, a numpy array
or a Python number (AdamW's ``step`` is a Python int and comes back as one).
numpy has no bfloat16: a bf16 tensor is stored as its raw 2-byte words (the
npz type ``|V2``, the manifest's dtype ``bfloat16``), as the JAX package
stores a bf16 array, and comes back bit for bit; a tensor of another type
numpy lacks is refused.

The port's ``Trainer`` updates params and moments in place, so a tree
handed to ``AsyncCheckpointer.save`` is copied to the host before ``save``
returns (a CPU tensor's ``numpy()`` would alias the live storage); and
``restore_checkpoint`` builds fresh tensors on ``tree_like``'s device and
dtype, requiring grad where its leaf did.

With a ``mesh`` (``launch/mesh.py``; every rank calls) rank 0 writes and
every rank returns once the step is on disk.  The caller names the subtree
whose leaves are each rank's ``[1, ...]`` row (``rows``, its path from the
root: for the trainer's ``(params, opt)`` with a compressed sync,
``(1, "err")``, the error-feedback residuals); those leaves are gathered
over the mesh's data-parallel axes to the reference's ``[dp_total, ...]``
layout, and on restore every rank takes its own row back.  On a ``model``
axis above 1 the caller also names the leaves that are the rank's blocks
(``dims``: a tree mirroring ``tree``, or a prefix of it, whose leaves give
the dim each leaf is split at over ``model``, None or a missing entry where
it is whole; ``Trainer.checkpoint_dims``, which a mesh with such an axis
requires); those blocks are gathered over ``model`` into the reference's
whole leaves before rank 0 writes, and on restore every rank takes its
block of each.  Every other leaf is the same on every rank.
"""

from __future__ import annotations

import collections
import concurrent.futures
import hashlib
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from ..core.collectives import all_gather
from ..runtime.sharding import model_blocks, whole_leaves

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "latest_intact_step",
    "verify_checkpoint",
    "AsyncCheckpointer",
]

_MANIFEST = "manifest.json"
_DATA = "arrays.npz"
_BF16_WORDS = np.dtype("V2")  # how numpy stores a bf16 array it cannot name


def _paths(tree, prefix: str = ""):
    """(keystr name, leaf) of every leaf, as ``jax.tree_util.keystr`` names
    them: ``['key']`` for a dict entry, ``[i]`` for a list or tuple item."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _host_array(leaf, copy: bool) -> tuple[np.ndarray, str]:
    """(the array written for ``leaf``, the manifest's dtype).  With
    ``copy`` the array owns its memory; without it a CPU tensor's array
    aliases the tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.to("cpu", copy=True) if copy else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORDS), "bfloat16"
        try:
            arr = t.numpy()
        except TypeError as e:
            raise TypeError(f"a {t.dtype} leaf has no numpy type to be written as") from e
        return arr, str(arr.dtype)
    if isinstance(leaf, (bool, int, float, np.ndarray, np.generic)):
        arr = np.array(leaf) if copy else np.asarray(leaf)
        return arr, str(arr.dtype)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _flatten(tree, copy: bool = False) -> tuple[dict, dict]:
    """({name: array}, {name: manifest dtype})."""
    arrays, dtypes = {}, {}
    for name, leaf in _paths(tree):
        if name in arrays:
            raise ValueError(f"two leaves named {name}")
        arrays[name], dtypes[name] = _host_array(leaf, copy)
    return arrays, dtypes


def _leaf_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _tree_digest(leaf_digests: dict) -> str:
    """Whole-checkpoint checksum derived from the per-leaf digests, so every
    byte is hashed exactly once."""
    digest = hashlib.sha256()
    for k in sorted(leaf_digests):
        digest.update(k.encode())
        digest.update(leaf_digests[k].encode())
    return digest.hexdigest()


def _check_digests(data, manifest) -> list[str]:
    """Names of damaged/missing/spurious leaves ([] when intact); ``data``
    maps leaf names to arrays (an open npz, or the arrays read from one)."""
    leaves = manifest["leaves"]
    bad = sorted(set(data) ^ set(leaves))
    for k in sorted(set(data) & set(leaves)):
        if _leaf_digest(data[k]) != leaves[k]["sha256"]:
            bad.append(k)
    if not bad and _tree_digest({k: v["sha256"] for k, v in leaves.items()}) != (
        manifest["checksum"]
    ):
        bad.append("<manifest checksum>")
    return bad


def _rows_prefix(rows, mesh) -> str | None:
    """The leaf-name prefix of the ``rows`` subtree (None: no rows)."""
    if rows is None:
        return None
    if mesh is None:
        raise ValueError("rows name each rank's leaves of a mesh: pass the mesh too")
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in rows)


def _gather_rows(tree, mesh, prefix: str, name: str = ""):
    """``tree`` with each leaf under ``prefix`` gathered to ``[dp_total, ...]``."""
    if isinstance(tree, dict):
        return {k: _gather_rows(v, mesh, prefix, f"{name}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather_rows(v, mesh, prefix, f"{name}[{i}]")
                          for i, v in enumerate(tree))
    if not name.startswith(prefix):
        return tree
    return all_gather(tree, mesh.data_parallel_axes, tiled=True, mesh=mesh)


def _check_dims(mesh, dims) -> None:
    """On a ``model`` axis above 1 the ranks hold blocks, which a
    checkpoint without ``dims`` would write as if they were whole leaves."""
    if dims is None and mesh is not None and mesh.axis_sizes().get("model", 1) > 1:
        raise ValueError(f"a model axis of {mesh.axis_sizes()['model']}: pass dims, the split "
                         f"dim of each leaf (Trainer.checkpoint_dims(); {{}} where none is)")


def save_checkpoint(directory: str, step: int, tree, keep: int = 3, *, mesh=None,
                    rows=None, dims=None) -> str:
    """Writes ``tree`` as step ``step``; returns the step's directory.  With
    a ``mesh`` every rank calls, the leaves under the path ``rows`` are
    gathered over the data-parallel axes, the blocks ``dims`` names over
    ``model``, and rank 0 writes."""
    prefix = _rows_prefix(rows, mesh)
    if mesh is None:
        return _write_arrays(directory, step, *_flatten(tree), keep)
    _check_dims(mesh, dims)
    tree = whole_leaves(tree, dims, mesh)
    if prefix is not None:
        tree = _gather_rows(tree, mesh, prefix)
    final = os.path.join(directory, f"step_{step:010d}")
    if mesh.rank == 0:
        final = _write_arrays(directory, step, *_flatten(tree), keep)
    if mesh.size > 1:
        dist.barrier()
    return final


def _write_arrays(directory: str, step: int, arrays: dict, dtypes: dict, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _DATA), **arrays)
    leaf_digests = {k: _leaf_digest(v) for k, v in arrays.items()}
    leaves = {
        k: {"shape": list(v.shape), "dtype": dtypes[k], "sha256": leaf_digests[k]}
        for k, v in arrays.items()
    }
    manifest = {"step": step, "checksum": _tree_digest(leaf_digests), "leaves": leaves}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def _prune(directory: str, keep: int) -> None:
    steps = _steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def verify_checkpoint(directory: str, step: int) -> bool:
    """True iff the checkpoint at ``step`` exists and every leaf passes its
    manifest digest (detects truncation, bit flips, and missing files)."""
    path = os.path.join(directory, f"step_{step:010d}")
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, _DATA)) as data:
            return not _check_digests(data, manifest)
    except Exception:  # noqa: BLE001 - any damage means "not intact"
        return False


def latest_intact_step(directory: str) -> int | None:
    """Newest step that passes integrity validation (None when none do)."""
    for s in reversed(_steps(directory)):
        if verify_checkpoint(directory, s):
            return s
    return None


def _leaf_like(arr: np.ndarray, dtype: str, like, key: str):
    """The stored ``arr`` as a leaf of ``like``'s kind: a fresh tensor on
    ``like``'s device and dtype (requiring grad where ``like`` does), a
    numpy array of its dtype, or a Python number of its type."""
    shape = tuple(like.shape) if isinstance(like, (torch.Tensor, np.ndarray)) else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape drift at {key}: {arr.shape} vs {shape}")
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        out = t.to(device=like.device, dtype=like.dtype, copy=True)
        return out.requires_grad_() if like.requires_grad else out
    if isinstance(like, np.ndarray):
        if dtype == "bfloat16":
            return t.float().numpy().astype(like.dtype)
        return arr.astype(like.dtype)
    return type(like)(t.item())


def _unflatten_like(tree_like, values: dict, prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten_like(v, values, f"{prefix}[{k!r}]") for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten_like(v, values, f"{prefix}[{i}]")
                               for i, v in enumerate(tree_like))
    return values[prefix]


def _read(directory: str, step: int) -> tuple[dict, dict]:
    """(manifest, {name: array}) of the checkpoint at ``step``, each leaf
    read from disk once and checked against its digest; raises when the
    checkpoint is damaged."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, _DATA)) as data:
        arrays = {k: data[k] for k in data.files}
    bad = _check_digests(arrays, manifest)
    if bad:
        raise IOError(f"checkpoint {path} failed integrity validation at: {', '.join(bad[:5])}")
    return manifest, arrays


def restore_checkpoint(directory: str, tree_like, step: int | None = None, *, mesh=None,
                       rows=None, dims=None):
    """Restore into the structure of ``tree_like`` (shape validated; each
    leaf takes ``tree_like``'s leaf's kind, dtype and device).  With a
    ``mesh`` each rank takes its own row of the gathered leaves under the
    path ``rows``, and its block of each whole leaf that ``dims`` names.

    Returns (tree, step).  With an explicit ``step`` any damage raises; with
    ``step=None`` the newest *intact* checkpoint is restored, silently
    skipping damaged newer ones (the crash that truncated them is exactly
    why we are restoring).  Raises when no intact checkpoint exists.  The
    checkpoint restored is read and hashed once.
    """
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        for step in reversed(steps):
            try:
                manifest, arrays = _read(directory, step)
                break
            except Exception:  # noqa: BLE001 - any damage: walk back to an older step
                continue
        else:
            raise IOError(f"no intact checkpoint under {directory} (all damaged)")
    else:
        manifest, arrays = _read(directory, step)
    prefix = _rows_prefix(rows, mesh)
    row = None if prefix is None else mesh.axis_index(mesh.data_parallel_axes)
    _check_dims(mesh, dims)
    values = {}
    for key, _ in _paths(tree_like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays.pop(key)
        values[key] = arr[row:row + 1] if row is not None and key.startswith(prefix) else arr
    if mesh is not None:  # this rank's block of each whole leaf that dims names
        values = dict(_paths(model_blocks(_unflatten_like(tree_like, values), dims, mesh)))
    out = {key: _leaf_like(values[key], manifest["leaves"][key]["dtype"], like, key)
           for key, like in _paths(tree_like)}
    return _unflatten_like(tree_like, out), step


class AsyncCheckpointer:
    """Double-buffered background checkpoint writer.

    ``save`` copies the tree to host memory synchronously (every leaf into
    memory of its own: the only part that must see a consistent step
    boundary, since the port's trainer then updates the tensors in place)
    and hands the disk write to a single worker thread.  At most
    ``max_in_flight`` (default 2: the double buffer) writes may be pending;
    a further ``save`` blocks on the oldest, so a slow filesystem applies
    back-pressure instead of accumulating host snapshots.  Write errors
    surface on the *next* ``save``/``wait`` call, never silently.
    """

    def __init__(self, max_in_flight: int = 2):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: collections.deque = collections.deque()
        self._max = max_in_flight

    def save(self, directory: str, step: int, tree, keep: int = 3) -> None:
        arrays, dtypes = _flatten(tree, copy=True)
        while len(self._pending) >= self._max:
            self._pending.popleft().result()
        self._pending.append(
            self._pool.submit(_write_arrays, directory, step, arrays, dtypes, keep)
        )

    def wait(self) -> None:
        """Drain all pending writes (re-raising any write error)."""
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
