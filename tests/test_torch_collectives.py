"""The port's collectives (``repro_torch.core.collectives``) on 4 gloo ranks
against the JAX package's under ``shard_map`` on a (pod 2, data 2, model 1)
mesh of 4 of the pytest process's 8 virtual CPU devices, on the same numpy
inputs, a block per rank: the staged all-reduce and its flat equivalent, a
leaf padded to the low axis, the int8 psum and two steps of error
feedback, and the two-stage all-to-all against the flat one.  Tolerance
1e-6 (the port's sums are the reference's, two terms at a time).

The ranks are spawned once for the module (``tests/torch_ranks.py``,
which loads no JAX) and every case reads their results; the mesh, the
quantiser and the cost model are checked in this process."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from repro.core import collectives as jax_col
from repro.launch.jax_compat import make_mesh as jax_make_mesh
from repro.launch.jax_compat import shard_map
from repro_torch.core import collectives as col
from repro_torch.core.cost_model import CollectiveCostModel
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(2)

TOL = 1e-6
DP = ("pod", "data")


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"g": f(4, 16, 6), "odd": f(4, 5, 3), "seven": f(4, 7), "c": f(4, 8, 4),
            "x": f(4, 8, 3), "x2": f(4, 2, 8, 3)}


def _jax_ref(inputs):
    """{name: [4, ...] per-rank output} of the JAX package's collectives."""
    mesh = jax_make_mesh((2, 2, 1), ("pod", "data", "model"), devices=jax.devices()[:4])
    spec = P(DP)

    def run(fn, *names, n_out=1):
        args = [jnp.asarray(inputs[k].reshape((-1,) + inputs[k].shape[2:])) for k in names]
        outs = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                                 out_specs=(spec,) * n_out if n_out > 1 else spec,
                                 axis_names=set(DP)))(*args)
        outs = outs if n_out > 1 else (outs,)
        return [np.asarray(o).reshape((4, -1) + o.shape[1:]) for o in outs]

    def hier(g, odd):
        out, _ = jax_col.hierarchical_all_reduce({"g": g, "h": [odd]}, low_axes=("data",),
                                                 high_axis="pod", average=True)
        return out["g"], out["h"][0]

    def ef(g):
        res = jax_col.error_feedback_slots({"g": g}, 2)
        outs = []
        for step in (0, 1):
            red, res = jax_col.hierarchical_all_reduce({"g": g * (1 + step)}, compress_high=True,
                                                       residuals=res)
            outs += [red["g"], res["g"]]
        return tuple(outs)

    ref = {}
    ref["hier_g"], ref["hier_odd"] = run(hier, "g", "odd", n_out=2)
    ref["flat_g"], = run(lambda g: jax.lax.pmean(g, DP), "g")
    ref["pad"], = run(lambda s: jax_col.hierarchical_all_reduce({"g": s}, average=False)[0]["g"],
                      "seven")
    ref["comp_total"], ref["comp_err"] = run(lambda c: jax_col.compressed_psum(c, "pod"), "c",
                                             n_out=2)
    ref["ef0_g"], ref["ef0_err"], ref["ef1_g"], ref["ef1_err"] = run(ef, "g", n_out=4)
    ref["a2a_flat"], = run(lambda x: jax.lax.all_to_all(x, DP, 0, 0, tiled=True), "x")
    ref["a2a_staged"], = run(lambda x: jax_col.two_stage_all_to_all(x, "data", "pod"), "x")
    ref["a2a_axis1"], = run(lambda x: jax_col.two_stage_all_to_all(
        x, "data", "pod", split_axis=1, concat_axis=1), "x2")
    return ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(workdir / "inputs.npz", **inputs)
    ranks = torch_ranks.spawn("collectives", workdir)
    return inputs, ranks, _jax_ref(inputs)


CASES = ["hier_g", "hier_odd", "flat_g", "pad", "comp_total", "comp_err", "ef0_g", "ef0_err",
         "ef1_g", "ef1_err", "a2a_flat", "a2a_staged", "a2a_axis1"]


@pytest.mark.parametrize("name", CASES)
def test_collective_equals_the_reference(results, name):
    _, ranks, ref = results
    for r, out in enumerate(ranks):
        got = out[name].numpy()
        want = ref[name][r].reshape(got.shape)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"rank {r}")


def test_ranks_sit_row_major_on_the_mesh(results):
    _, ranks, _ = results
    assert [out["coords"] for out in ranks] == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]


def test_mesh_groups_only_the_axis_sets_the_data_parallel_path_uses(results):
    """One group per slice of each axis, of (pod, data) and of (pod, data,
    model) (the expert-parallel MoE path's token blocks): no other set of
    axes has a group."""
    _, ranks, _ = results
    for out in ranks:
        assert out["group sets"] == [("data",), ("model",), ("pod",), ("pod", "data"),
                                     ("pod", "data", "model")]
    with pytest.raises(NotImplementedError, match="no process group over"):
        mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model")).group(("data", "model"))


def test_staged_sum_equals_the_flat_one_and_pads(results):
    inputs, ranks, _ = results
    for out in ranks:
        np.testing.assert_allclose(out["hier_g"].numpy(), inputs["g"].mean(0), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out["pad"].numpy(), inputs["seven"].sum(0), rtol=1e-6,
                                   atol=1e-6)


def test_error_feedback_is_exact_and_nonzero(results):
    """total + the pods' residuals == the exact sum; the residuals are not 0."""
    inputs, ranks, _ = results
    exact = inputs["c"][[0, 2]].sum(0), inputs["c"][[1, 3]].sum(0)  # by data coordinate
    for r, out in enumerate(ranks):
        data = r % 2
        partner = ranks[r ^ 2]  # the same data coordinate in the other pod
        got = out["comp_total"].numpy() + out["comp_err"].numpy() + partner["comp_err"].numpy()
        np.testing.assert_allclose(got, exact[data], atol=1e-5)
        assert np.abs(out["ef1_err"].numpy()).sum() > 0


def test_bytes_sent_follow_the_schedule(results):
    """The flat sum moves the whole leaf over the (pod, data) group; the
    staged one half of it (one shard) across the pods."""
    _, ranks, _ = results
    leaf = 16 * 6 * 4
    odd_shard = 8 * 4  # 15 elements padded to 16, halved
    for out in ranks:
        assert out["bytes_flat"] == {"pod,data": int(2 * 3 / 4 * leaf)}
        assert out["bytes_hier"] == {
            "data": int(0.5 * leaf) + int(0.5 * 2 * odd_shard) + int(leaf / 2) + odd_shard,
            "pod": int(2 * 0.5 * leaf / 2) + int(2 * 0.5 * odd_shard)}


def test_quantize_matches_the_reference():
    x = np.random.default_rng(5).normal(size=(33,)).astype(np.float32) * 3
    q, s = col.quantize_int8(torch.from_numpy(x))
    qj, sj = jax_col.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert float(s) == float(sj)
    back = col.dequantize_int8(q, s)
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(s)


@pytest.mark.parametrize("method,args", [
    ("flat_all_reduce", (1e9, 16, 2)), ("flat_all_reduce", (1e6, 4, 1)),
    ("hierarchical_all_reduce", (1e9, 16, 2)), ("hierarchical_all_reduce", (1e9, 16, 2, 0.25)),
    ("hierarchical_all_reduce", (1e6, 2, 1)), ("grad_sync_cost", (1e9, 16, 2)),
    ("grad_sync_cost", (1e9, 16, 2, True)), ("grad_sync_cost", (1e9, 16, 1, True)),
    ("migration_cost", (2e9,)), ("migration_cost", (2e9, 0.5)),
    ("flat_all_to_all", (1e6, 16, 2)), ("two_stage_all_to_all", (1e6, 16, 2)),
])
def test_cost_model_equals_the_reference(method, args):
    got = getattr(CollectiveCostModel(), method)(*args)
    want = getattr(jax_col.CollectiveCostModel(), method)(*args)
    assert got == pytest.approx(want, rel=1e-12)
    port, ref = CollectiveCostModel().degraded(0.25), jax_col.CollectiveCostModel().degraded(0.25)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(ValueError):
        CollectiveCostModel().degraded(0.0)


def test_collectives_reexport_the_cost_model():
    assert col.CollectiveCostModel is CollectiveCostModel
    cm = CollectiveCostModel()
    assert cm.hierarchical_all_reduce(1e9, 16, 2) < cm.flat_all_reduce(1e9, 16, 2)


def test_one_rank_mesh_and_size_mismatch():
    """Without a process group a one-rank mesh needs no group and its
    collectives are the identity; a mesh of another size raises, naming
    both sizes."""
    m = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert m.coords == (0, 0, 0) and m.group(DP) is None and mesh_mod.dp_axes(m) == DP
    x = torch.arange(6.0)
    red, err = col.hierarchical_all_reduce({"x": x}, mesh=m)
    assert torch.equal(red["x"], x) and err["x"].shape == (6,)
    with pytest.raises(ValueError, match="mesh of 4 ranks.*world of 1"):
        mesh_mod.make_mesh((2, 2, 1), ("pod", "data", "model"))
    with pytest.raises(SystemExit, match="DxM or PxDxM"):
        mesh_mod.parse_mesh_flag("banana")
    assert mesh_mod.mesh_axis_sizes(mesh_mod.parse_mesh_flag("1x1")) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="exceeds"):
        mesh_mod.make_elastic_mesh(2)
    assert mesh_mod.make_elastic_mesh().axis_sizes() == {"data": 1, "model": 1}
