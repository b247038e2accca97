"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
JAX package's, on the pytest process's 8 virtual CPU devices.

Every leaf of ``param_axes`` of the ten REDUCED configs, on meshes (pod 2,
data 2, model 2), (data 4, model 2), (2, 2) and (1, 4), with and without
``fsdp_axis="data"``: the port's spec equals the reference's
``PartitionSpec`` entry for entry (a scanned leaf of the reference has one
more dim, its leading ``layers``, which the port's per-layer list has not).
``param_axes`` itself is the reference's tree after the bridge's mapping.
``batch_shardings`` and ``cache_shardings`` on the caches of ``init_cache``
of dense, SSM, hybrid and MLA configs: the port's rules on the reference's
cache tree give its entries, and on the port's own stacked caches the
same entry per layer.  ``reshard_params``' block on each rank is
bit-equal to the reference's ``addressable_shards`` on the device at the
rank's place in the mesh.  The mesh of the rules is ``launch/mesh.py``'s
dataclass, built directly (the rules read its axis names, sizes and this
rank's coordinates; no process group)."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jax_get_config
from repro.launch.jax_compat import make_mesh as jax_make_mesh
from repro.models import build_model as jax_build_model
from repro.runtime import sharding as ref
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import CACHE_KEYS, mixer_kind
from repro_torch.runtime import sharding
from repro_torch.tree import tree_leaves

MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")), "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model"))}


def _jmesh(name):
    shape, names = MESHES[name]
    return jax_make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])


def _mesh(name, rank=0):
    shape, names = MESHES[name]
    return Mesh(names, shape, rank, {}, "none")


def _is_axes(t):
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None))) for a in t)


def _per_layer(cfg, pattern, strip):
    """The reference's per-pattern-position tree -> one entry per layer,
    ``strip`` applied to each leaf where the pattern repeats."""
    p = len(pattern)
    r = cfg.n_layers // p
    return [jax.tree.map(strip, pattern[i % p], is_leaf=_is_axes) if r > 1 else pattern[i % p]
            for i in range(cfg.n_layers)]


def _ref_axes_as_port(cfg, axes, drop=lambda t: t[1:]):
    """The reference's axes in the port's tree: ``decoder`` (and an
    encoder's stack) a list of layers, the leading ``layers`` dropped
    (``drop`` of a leaf that repeats)."""
    out = {k: v for k, v in axes.items() if k not in ("decoder", "encoder")}
    if "encoder" in axes:
        out["encoder"] = _per_layer(dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers),
                                    axes["encoder"], drop)
    out["layers"] = _per_layer(cfg, axes["decoder"], drop)
    return out


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCH_IDS:
        jm = jax_build_model(jax_get_config(arch, reduced=True))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        out[arch] = (jm, shapes, build_model(get_config(arch, reduced=True), device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_are_the_references_after_the_bridge(models, arch):
    jm, _, model = models[arch]
    assert model.param_axes() == _ref_axes_as_port(model.cfg, jm.param_axes())


CASES = [(a, m, f) for a in ARCH_IDS for m in MESHES for f in (None, "data")]


@pytest.mark.parametrize("arch,mesh,fsdp", CASES,
                         ids=[f"{a}-{m}-{f or 'nofsdp'}" for a, m, f in CASES])
def test_param_specs_equal_the_references(models, arch, mesh, fsdp):
    jm, shapes, model = models[arch]
    want = ref.param_shardings(jm.param_axes(), _jmesh(mesh), shapes, fsdp_axis=fsdp)
    want = jax.tree.map(lambda s, a: tuple(s.spec)[1:] if a[:1] == ("layers",) else
                        tuple(s.spec), want, jm.param_axes(), is_leaf=_is_axes)
    keep = lambda t: t  # noqa: E731 - the leading dim is gone already
    want = _ref_axes_as_port(model.cfg, want, keep)
    port_like = _ref_axes_as_port(model.cfg, jax.tree.map(
        lambda s, a: np.empty(s.shape[1:] if a[:1] == ("layers",) else s.shape, np.int8),
        shapes, jm.param_axes(), is_leaf=_is_axes), keep)
    got = sharding.param_shardings(model.param_axes(), _mesh(mesh), port_like, fsdp_axis=fsdp)
    assert got == want
    # without shapes, the rules alone (no divisibility test)
    bare = ref.param_shardings(jm.param_axes(), _jmesh(mesh))
    assert jax.tree.leaves(jax.tree.map(lambda s: tuple(s.spec), bare), is_leaf=_is_axes) == \
        [sharding.spec_for_axes(a, _mesh(mesh))
         for a in jax.tree.leaves(jm.param_axes(), is_leaf=_is_axes)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_model_split_dim_is_where_the_references_spec_names_model(models, mesh):
    """The one question the port's layers ask of the rules (which dim of a
    leaf, if any, is split over ``model``), answered from the axes and the
    whole shape, on every leaf of every REDUCED config."""
    for arch in ARCH_IDS:
        jm, shapes, _ = models[arch]
        specs = ref.param_shardings(jm.param_axes(), _jmesh(mesh), shapes)
        for a, sh, sp in zip(jax.tree.leaves(jm.param_axes(), is_leaf=_is_axes),
                             jax.tree.leaves(shapes), jax.tree.leaves(
                                 jax.tree.map(lambda x: tuple(x.spec), specs),
                                 is_leaf=_is_axes)):
            sp = tuple(sp) + (None,) * (len(a) - len(sp))
            want = sp.index("model") if "model" in sp else None
            assert sharding.model_split_dim(a, sh.shape, _mesh(mesh)) == want, (arch, a)
    assert sharding.model_split_dim(("embed", "ff"), (8, 8), None) is None


CACHE_ARCHS = ["internlm2-1.8b", "mamba2-1.3b", "jamba-v0.1-52b", "minicpm3-4b",
               "h2o-danube-1.8b"]
CACHE_CASES = [(a, m) for a in CACHE_ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CACHE_CASES, ids=[f"{a}-{m}" for a, m in CACHE_CASES])
def test_cache_and_batch_specs_equal_the_references(models, arch, mesh):
    jm, _, model = models[arch]
    batch = 8
    caches = jax.tree.map(np.asarray, jm.init_cache(batch, 16))
    want = jax.tree.map(lambda s: tuple(s.spec),
                        ref.cache_shardings(caches, _jmesh(mesh), jm.cfg, batch))
    assert sharding.cache_shardings(caches, _mesh(mesh), model.cfg, batch) == want
    # the port's stacked caches: each leaf's entry is the reference's per layer
    flat = sharding.cache_shardings(model.init_cache(batch, 16), _mesh(mesh), model.cfg, batch)
    p = len(want)
    r = model.cfg.n_layers // p
    for i in range(model.cfg.n_layers):
        for name in CACHE_KEYS[mixer_kind(model.cfg, i)]:
            entry = want[i % p]["mixer"][name]
            assert flat[name] == (None,) + (entry[1:] if r > 1 else entry), (i, name)
    inputs = {"tokens": np.zeros((batch, 16), np.int32), "odd": np.zeros((3, 2), np.float32)}
    assert sharding.batch_shardings(inputs, _mesh(mesh)) == jax.tree.map(
        lambda s: tuple(s.spec), ref.batch_shardings(inputs, _jmesh(mesh)))


def test_rules_and_optimizer_specs_are_the_references():
    assert sharding.LOGICAL_RULES == ref.LOGICAL_RULES
    assert sharding.opt_state_shardings({"w": ("model", None)}, _mesh("2x2")) == {
        "step": (), "m": {"w": ("model", None)}, "v": {"w": ("model", None)}}
    want = ref.opt_state_shardings({"w": "x"}, _jmesh("2x2"))
    assert set(want) == {"step", "m", "v"} and tuple(want["step"].spec) == ()


RESHARD = [(a, m) for a in ("internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-1.3b",
                            "jamba-v0.1-52b") for m in MESHES]


@pytest.mark.parametrize("arch,mesh", RESHARD, ids=[f"{a}-{m}" for a, m in RESHARD])
def test_each_ranks_block_is_the_references_shard(models, arch, mesh):
    """The bridge's block (``from_jax_params(cfg, tree, mesh)``, which is
    ``reshard_params`` of the port's tree) on every rank against the
    reference's ``reshard_params`` shard on the device at that place."""
    jm, _, model = models[arch]
    params = jm.init(jax.random.PRNGKey(0))
    jmesh = _jmesh(mesh)
    placed = ref.reshard_params(jm.param_axes(), params, jmesh)
    tree = jax.tree.map(np.asarray, params)
    for rank, device in enumerate(jmesh.devices.flat):
        shard = jax.tree.map(lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                                       if s.device == device)), placed)
        want = tree_leaves(from_jax_params(model.cfg, shard))
        got = tree_leaves(from_jax_params(model.cfg, tree, mesh=_mesh(mesh, rank)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w), f"rank {rank}"
