"""Meshes over the ranks of ``torch.distributed``'s default group.

Counterpart of the JAX package's ``launch/mesh.py``.  A mesh names its axes
(``model`` the innermost, ``data`` the intra-pod data-parallel axis,
``pod`` the scarce top level: the CLEX hierarchy), gives each rank its
coordinates in row-major order (rank ``r`` of a ``(P, D, M)`` mesh sits at
``(r // (D*M), r // M % D, r % M)``, as ``jax.make_mesh`` lays out its
devices) and holds one process group for each slice of each axis and of the
data-parallel axes together (``("pod", "data")``) and of the
data-parallel axes with ``model`` (``("pod", "data", "model")``, the
token blocks of the expert-parallel MoE path), so that a collective over
``"pod"`` alone, over ``"model"`` alone or over a set of them runs on the
group of the ranks that share this rank's other coordinates.

The mesh is a small dataclass of named groups, not
``torch.distributed.device_mesh.DeviceMesh``: a ``DeviceMesh`` over CUDA
binds each rank to card ``LOCAL_RANK`` (or ``rank % device_count``) unless
the caller set the device first, and several ranks sharing one card (the
only way to run ranks on a one-card machine, under gloo) need every rank on
card 0.  Here the caller picks the device and the backend
(``launch/train.py``); the mesh only groups ranks.

Every rank makes the same ``new_group`` calls in the same order (group
creation is collective): one group per distinct set of ranks of those
slices, the default
group where a slice spans the world, none where it is one rank (the
collectives are then the identity).  A mesh whose size differs from the
world size raises, naming both.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math

import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "make_production_mesh",
    "make_elastic_mesh",
    "parse_mesh_flag",
    "dp_axes",
    "mesh_axis_sizes",
]


@dataclasses.dataclass
class Mesh:
    """Named axes over the ranks of the default group, and this rank's place
    in them.  ``groups`` maps a tuple of axis names (in mesh order: each
    axis alone, ``data_parallel_axes`` together and with ``model``) to the
    process group
    of this rank's slice over those axes (None for a slice of one rank);
    ``sent`` counts the bytes this rank sent in the collectives
    of ``core/collectives.py`` by axis set (``"pod,data"``)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    groups: dict
    backend: str
    sent: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> tuple[int, ...]:
        """This rank's coordinate on each axis, row-major."""
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    @property
    def data_parallel_axes(self) -> tuple[str, ...]:
        """The axes the batch is split over: ``pod`` and ``data``, those of
        them the mesh has, in mesh order."""
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def ordered_axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or names) in mesh order; raises on an unknown name."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh's {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes) -> int:
        """The number of ranks in a slice over ``axes``."""
        sizes = self.axis_sizes()
        return math.prod(sizes[a] for a in self.ordered_axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index in its slice over ``axes``: its coordinates on
        them flattened row-major (for ``("pod", "data")``,
        ``pod * n_data + data``), which is its rank in ``group(axes)``."""
        sizes, coords = self.axis_sizes(), dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in self.ordered_axes(axes):
            idx = idx * sizes[a] + coords[a]
        return idx

    def over(self, axes) -> "Mesh":
        """This rank's slice over ``axes`` as a mesh of its own: those axes
        only, the groups over them, and the same ``sent`` counter.  A
        training rank's model runs on ``over("model")``: its rows are
        already its data-parallel block, so the MoE layer splits them over
        ``model`` alone."""
        axes = self.ordered_axes(axes)
        sizes = self.axis_sizes()
        return Mesh(axes, tuple(sizes[a] for a in axes), self.axis_index(axes),
                    {k: g for k, g in self.groups.items() if set(k) <= set(axes)},
                    self.backend, self.sent)

    def group(self, axes):
        """The process group of this rank's slice over ``axes`` (None when
        the slice is this rank alone)."""
        axes = self.ordered_axes(axes)
        if axes not in self.groups:
            raise NotImplementedError(f"no process group over {axes}: the mesh holds groups "
                                      f"over {sorted(self.groups)} only")
        return self.groups[axes]


def _slice_ranks(shape: tuple[int, ...], axes: tuple[int, ...]) -> list[list[int]]:
    """Every slice over the axes at positions ``axes``: the ranks sharing
    the other coordinates, ordered row-major over ``axes``."""
    others = [i for i in range(len(shape)) if i not in axes]
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    slices = []
    for fixed in itertools.product(*(range(shape[i]) for i in others)):
        base = sum(c * strides[i] for c, i in zip(fixed, others))
        slices.append([base + sum(c * strides[i] for c, i in zip(free, axes))
                       for free in itertools.product(*(range(shape[i]) for i in axes))])
    return slices


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` named ``axis_names`` over the default group's
    ranks; a collective call on every rank.  A one-rank mesh needs no
    process group."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names {axis_names}")
    if min(shape) < 1:
        raise ValueError(f"mesh shape {shape} has an empty axis")
    size = math.prod(shape)
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if size != world:
        raise ValueError(f"a mesh of {size} ranks {dict(zip(axis_names, shape))} over a world "
                         f"of {world} ranks: the sizes must be equal")
    rank = dist.get_rank() if initialized else 0
    made = {}  # ranks -> group: one group per distinct set of ranks
    groups = {}
    sets = [(i,) for i in range(len(shape))]
    dp = tuple(i for i, a in enumerate(axis_names) if a in ("pod", "data"))
    if len(dp) > 1:
        sets.append(dp)
    if dp and "model" in axis_names:
        sets.append(tuple(sorted(dp + (axis_names.index("model"),))))
    for axes in sets:
        mine = None
        for ranks in _slice_ranks(shape, axes):
            key = tuple(ranks)
            if key not in made:
                if len(ranks) == 1:
                    made[key] = None
                elif len(ranks) == world:
                    made[key] = dist.group.WORLD
                else:
                    made[key] = dist.new_group(ranks)
            if rank in ranks:
                mine = made[key]
        groups[tuple(axis_names[i] for i in axes)] = mine
    backend = str(dist.get_backend()) if initialized else "none"
    return Mesh(axis_names, shape, rank, groups, backend)


def parse_mesh_flag(value: str) -> Mesh:
    """Parse the launchers' ``--mesh`` knob: ``DxM`` (data x model) or
    ``PxDxM`` (pod x data x model, the CLEX hierarchy); raises
    ``SystemExit`` with the usage message on malformed input."""
    try:
        dims = tuple(int(x) for x in value.split("x"))
    except ValueError:
        dims = ()
    if len(dims) == 2:
        return make_mesh(dims, ("data", "model"))
    if len(dims) == 3:
        return make_mesh(dims, ("pod", "data", "model"))
    raise SystemExit(f"--mesh must be DxM or PxDxM, got {value!r}")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16 x 16 single-pod and 2 x 16 x 16 multi-pod meshes
    (256 and 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_elastic_mesh(n_devices: int | None = None, model_parallel: int | None = None) -> Mesh:
    """Elastic re-mesh after node loss: keep the model axis fixed and shrink
    the data axis to the surviving ranks.  An explicit ``model_parallel``
    must divide ``n_devices``; with None the largest power-of-two degree up
    to 16 that fits is picked.  Invalid counts raise ``ValueError``, as in
    the reference; a count other than the world size raises in
    ``make_mesh``."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_devices is not None and n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    n = n_devices or world
    if n > world:
        raise ValueError(f"n_devices={n} exceeds the {world} ranks of the default group")
    if model_parallel is not None:
        if model_parallel <= 0:
            raise ValueError(f"model_parallel must be positive, got {model_parallel}")
        if n % model_parallel:
            raise ValueError(
                f"{n} surviving devices are not divisible by model_parallel="
                f"{model_parallel}; shrinking the model axis would orphan parameter shards")
        mp = model_parallel
    else:
        mp = 16
        while mp > 1 and n % mp:
            mp //= 2
    return make_mesh((n // mp, mp), ("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    return mesh.data_parallel_axes


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return mesh.axis_sizes()
