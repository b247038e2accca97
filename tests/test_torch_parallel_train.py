"""Data-parallel training across ranks: the port's flat, hierarchical and
compressed train steps on 4 gloo ranks (pod 2 x data 2 x model 1) against
the JAX package's ``Trainer`` on the same mesh of 4 virtual CPU devices,
from the same params (made by the JAX package, across the bridge) and the
same two batches, with ``tests/test_runtime.py``'s model (REDUCED
internlm2 in fp32, 2 layers, no remat) and bars: flat and hierarchical
params within 1e-5 of the reference's and of each other, the loss within
1e-5 relative; the compressed step within 2e-3 of the uncompressed one,
with nonzero residuals.  Beside those bars, which a step of AdamW meets
whatever the gradient's size, the synced gradient itself is held at each
step: its norm, the first moment (its direction) and, compressed, every
rank's ``err`` row against the reference's.  Every rank ends with the same params; ``jitted_step
(donate=False)`` leaves the caller's tensors bit-identical; a checkpoint
of the compressed state crosses between the packages with ``err`` in the
reference's ``[dp_total, ...]`` layout; and the launcher runs 3 steps on 4
ranks under ``torchrun``.

The ranks are spawned once for the module (``tests/torch_ranks.py``, no
JAX); the JAX side runs in the pytest process."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.checkpoint import checkpointing as jax_ckpt
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.configs.base import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM
from repro.launch.jax_compat import make_mesh as jax_make_mesh
from repro.launch.jax_compat import use_mesh
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.bridge import from_jax_params, reference_leaves, to_jax_params
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import get_config
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MODES = ("flat", "hier", "comp")
JAX_PCFG = {"flat": JaxParallelConfig(hierarchical_grad_sync=False),
            "hier": JaxParallelConfig(hierarchical_grad_sync=True),
            "comp": JaxParallelConfig(compress_cross_pod=True)}


def _cfgs():
    kw = dict(compute_dtype="float32", remat=False, n_layers=2)
    return (dataclasses.replace(jax_get_config("internlm2-1.8b", reduced=True), **kw),
            dataclasses.replace(get_config("internlm2-1.8b", reduced=True), **kw))


def _np_tree(tree):
    return tree_map(lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else t, tree)


def _jax_run(cfg_j, batches):
    """The reference's params before the steps, and two steps of each mode:
    each step's params, first moment, metrics and, compressed, ``err``."""
    mesh = jax_make_mesh((2, 2, 1), ("pod", "data", "model"), devices=jax.devices()[:4])
    model = jax_build_model(cfg_j)
    out = {}
    with use_mesh(mesh):
        for mode in MODES:
            trainer = JaxTrainer(model, JaxAdamWConfig(lr=1e-3), JAX_PCFG[mode], mesh=mesh)
            params, opt = trainer.init(jax.random.PRNGKey(2))
            step = trainer.jitted_step(donate=False)
            p1, opt1, m1 = step(params, opt, batches[0])
            p2, opt2, m2 = step(p1, opt1, batches[1])
            out[mode] = [{"params": jax.tree.map(np.asarray, p), "m": jax.tree.map(np.asarray, o["m"]),
                          "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "err": jax.tree.map(np.asarray, o.get("err"))}
                         for p, o, m in ((p1, opt1, m1), (p2, opt2, m2))]
    return jax.tree.map(np.asarray, params), out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel_train")
    cfg_j, cfg_t = _cfgs()
    pipe = SyntheticLM(vocab=cfg_j.vocab, seq_len=32, global_batch=8, seed=2)
    batches = [pipe.global_batch_arrays(i) for i in range(2)]
    params_j, ref = _jax_run(cfg_j, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    model = build_model(cfg_t, device="cpu")
    # the bridged params in the order of the port's own tree (its optimizer
    # state is made from that tree)
    params_t = tree_map(lambda _, t: t, model.init(torch.Generator().manual_seed(0)),
                        from_jax_params(cfg_t, params_j))
    torch.save(params_t, workdir / "params.pt")
    np.savez(workdir / "inputs.npz", **{k: np.stack([b[k] for b in batches])
                                        for k in ("tokens", "targets")})
    # a checkpoint of (params, opt) in the port's layout written by the JAX
    # package, with the reference's err after its first compressed step:
    # [dp_total, ceil(size / 2)] rows of the reference's (stacked) leaves
    zeros = tree_map(lambda t: np.zeros(t.shape, np.float32), params_t)
    err = ref["comp"][0]["err"]
    jax_tree = (_np_tree(params_t), {"step": np.asarray(1, np.int32), "m": zeros, "v": zeros,
                                     "err": err})
    jax_ckpt.save_checkpoint(str(workdir / "jax_ckpt"), 1, jax_tree)
    ranks = torch_ranks.spawn("train", workdir, timeout=240)
    # one process's full-batch first step from the same params
    single = Trainer(model, AdamWConfig(lr=1e-3))
    p = tree_map(lambda t: t.clone().requires_grad_(), params_t)
    p1, o1, m1 = single.step(p, adamw_init(p, single.opt_cfg), batches[0])
    return dict(cfg=cfg_t, ref=ref, ranks=ranks, workdir=workdir, jax_err=err,
                single={"params": _np_tree(p1), "m": _np_tree(o1["m"]), "loss": float(m1["loss"]),
                        "grad_norm": float(m1["grad_norm"])},
                params_t=params_t)


def _max_diff(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32))))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _port_as_jax(run, params):
    return to_jax_params(run["cfg"], params)


def _leaf_rel(a, b) -> float:
    """The largest leaf difference over that leaf's largest value."""
    return max(float(np.max(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32))))
               / max(float(np.max(np.abs(np.asarray(y, np.float32)))), 1e-30)
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _key(name: str, mode: str, step: int) -> str:
    return f"{name}_{mode}" if step == 1 else f"{name}_{mode}{step}"


@pytest.mark.parametrize("mode", ["flat", "hier"])
def test_step_matches_the_reference_trainer(run, mode):
    """At each of two steps, the reference's bar for its own
    hierarchical-vs-auto test: params within 1e-5, loss within 1e-5
    relative.  And the synced gradient itself: its norm within 1e-5
    relative (a sync that summed instead of averaging is 4 times off), and
    the first moment (at the first step ``(1 - b1)`` times the clipped
    gradient, so its direction) within 1e-5 of each leaf's largest value."""
    for step in (1, 2):
        want = run["ref"][mode][step - 1]
        for r, out in enumerate(run["ranks"]):
            got = _port_as_jax(run, out[_key("params", mode, step)])
            assert _max_diff(got, want["params"]) < 1e-5, (step, r, _max_diff(got, want["params"]))
            m = _leaf_rel(_port_as_jax(run, out[_key("m", mode, step)]), want["m"])
            assert m < 1e-5, (step, r, m)
            metrics = out[_key("metrics", mode, step)]
            assert metrics["loss"] == pytest.approx(want["loss"], rel=1e-5)
            assert metrics["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)


def test_flat_and_hierarchical_agree_and_equal_one_full_batch_step(run):
    """Against one process's first step on the whole batch: params within
    1e-4 of each leaf's largest value, the first moment within 1e-5 of it,
    the loss and the grad norm within 1e-5 relative."""
    single = run["single"]
    for out in run["ranks"]:
        assert _max_diff(_np_tree(out["params_flat"]), _np_tree(out["params_hier"])) < 1e-5
        for mode in ("flat", "hier"):
            for a, b in zip(tree_leaves(_np_tree(out[f"params_{mode}"])),
                            tree_leaves(single["params"])):
                assert np.max(np.abs(a - b)) <= 1e-4 * max(np.max(np.abs(b)), 1e-30)
            assert _leaf_rel(tree_leaves(_np_tree(out[f"m_{mode}"])),
                             tree_leaves(single["m"])) < 1e-5
            assert out[f"metrics_{mode}"]["loss"] == pytest.approx(single["loss"], rel=1e-5)
            assert out[f"metrics_{mode}"]["grad_norm"] == pytest.approx(single["grad_norm"],
                                                                        rel=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_ranks_end_with_the_same_params_and_metrics(run, mode):
    first = run["ranks"][0]
    for out in run["ranks"][1:]:
        for step in (1, 2):
            key = _key("params", mode, step)
            assert all(np.array_equal(a, b) for a, b in zip(
                tree_leaves(_np_tree(out[key])), tree_leaves(_np_tree(first[key]))))
            key = _key("metrics", mode, step)
            assert out[key] == first[key]


@pytest.mark.parametrize("mode", MODES)
def test_undonated_step_leaves_the_callers_tensors_bit_identical(run, mode):
    assert all(out[f"untouched_{mode}"] for out in run["ranks"])


def _synced_grad(out, mode: str) -> list[torch.Tensor]:
    """The gradient a rank's first step synced, read back from its first
    moment: ``m = (1 - b1) * min(1, clip / grad_norm) * g`` (the moments
    start at 0), in the reference's leaves, flattened."""
    cfg = AdamWConfig(lr=1e-3)
    clip = min(1.0, cfg.clip_norm / out[f"metrics_{mode}"]["grad_norm"])
    m = reference_leaves(_cfgs()[1], out[f"m_{mode}"])
    return [t.reshape(-1) / ((1 - cfg.betas[0]) * clip) for t in tree_leaves(m)]


def _mostly_within(got, want, tol: float, few: float = 1e-3) -> bool:
    """All but ``ceil(few * size)`` elements of ``got`` within ``tol`` of ``want``."""
    off = np.abs(np.asarray(got) - np.asarray(want)) > tol
    return int(off.sum()) <= int(np.ceil(few * off.size))


def test_compressed_step_is_close_and_error_fed(run):
    """Against the reference's compressed trainer, at each of two steps (the
    first step's residuals fed into the second): the loss and the grad norm
    within 1e-5 relative; every rank's ``err`` row against the reference's
    row at its (pod, data) index, all but one element in a thousand within
    a thousandth of a quantum (two of the row's largest residual), the rest
    within one quantum; the first moment, all but one element in a thousand
    of each leaf within 1e-5 of its largest value.  The few are the
    elements on a rounding edge: the two packages sum a shard in different
    orders, so such an element's int8 value may move by one, its residual
    by one quantum the other way.  At the first step, the identity of error
    feedback on the trainer's own outputs: the int8-synced sum plus the
    pods' residuals equals the exact (staged) sum within 1e-5 of each
    leaf's largest value.  Residuals nonzero.  And the reference's own bar:
    params within 2e-3 of the uncompressed step's."""
    by_name = lambda tree: dict(ckpt._paths(tree))  # noqa: E731
    ranks = run["ranks"]
    for step in (1, 2):
        want = run["ref"]["comp"][step - 1]
        theirs = by_name(want["err"])
        for r, out in enumerate(ranks):
            metrics = out[_key("metrics", "comp", step)]
            assert metrics["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
            assert metrics["loss"] == pytest.approx(want["loss"], rel=1e-5)
            mine = by_name(_np_tree(out["err" if step == 1 else "err2"]))
            assert mine.keys() == theirs.keys()
            for k, row in mine.items():
                assert row.shape == (1,) + theirs[k].shape[1:], k
                half = float(np.max(np.abs(theirs[k][r])))
                assert _mostly_within(row[0], theirs[k][r], 2e-3 * half), (step, r, k)
                assert np.max(np.abs(row[0] - theirs[k][r])) <= 2 * half * (1 + 1e-3), (step, r, k)
            assert sum(float(np.abs(e).sum()) for e in mine.values()) > 0
            got = jax.tree.leaves(_port_as_jax(run, out[_key("m", "comp", step)]))
            for a, b in zip(got, jax.tree.leaves(want["m"])):
                assert _mostly_within(a, b, 1e-5 * float(np.max(np.abs(b)))), (step, r)
    # total + the pods' residuals = the exact sum, shard d from ranks (0, d) and (1, d)
    errs = [[e.reshape(-1) for e in tree_leaves(out["err"])] for out in ranks]
    for i, (comp, exact) in enumerate(zip(_synced_grad(ranks[0], "comp"),
                                          _synced_grad(ranks[0], "hier"))):
        back = torch.cat([comp, comp.new_zeros(comp.numel() % 2)]) * 4
        c = back.numel() // 2
        for d in range(2):
            back[d * c:(d + 1) * c] += errs[d][i] + errs[2 + d][i]
        gap = float((back[:comp.numel()] - 4 * exact).abs().max())
        assert gap <= 1e-5 * float((4 * exact).abs().max()), (i, gap)
    want_ref = run["ref"]["hier"][0]["params"]
    comp_ref = run["ref"]["comp"][0]["params"]
    for out in ranks:
        got = _port_as_jax(run, out["params_comp"])
        assert _max_diff(got, want_ref) < 2e-3
        assert _max_diff(got, comp_ref) < 2e-3
        assert _max_diff(_np_tree(out["params_comp"]), _np_tree(out["params_hier"])) < 2e-3
    assert sum(np.abs(e).sum() for e in jax.tree.leaves(run["ref"]["comp"][0]["err"])) > 0


def _psum_bytes(numel: int, n: int, elem: int = 4) -> int:
    """What ``psum`` counts for ``numel`` elements over ``n`` ranks: a
    reduce-scatter and an all-gather of the leaf padded to a multiple of n."""
    padded = -(-numel // n) * n
    return int((n - 1) / n * padded * elem) + (n - 1) * (padded // n) * elem


def test_each_mode_sends_its_schedules_bytes(run):
    """Flat: 1.5 x the gradient over the (pod, data) group; staged: half of
    it (the data shard) summed across the pods; int8: a quarter of that
    and a scale per leaf.  The metrics' pmean adds 24 bytes over (pod,
    data)."""
    out = run["ranks"][0]
    sizes = [t.numel() for t in tree_leaves(run["params_t"])]
    shards = [-(-n // 2) for n in sizes]
    # the int8 sync's leaves are the reference's (the layers stacked)
    comp = [-(-a.size // 2) for a in jax.tree.leaves(_port_as_jax(run, run["params_t"]))]
    assert out["bytes_flat"] == {"pod,data": sum(_psum_bytes(n, 4) for n in sizes)
                                 + _psum_bytes(2, 4)}
    assert out["bytes_hier"]["pod"] == sum(_psum_bytes(c, 2) for c in shards)
    assert out["bytes_comp"]["pod"] == sum(c + 4 for c in comp)
    assert out["bytes_hier"]["data"] == sum(int(0.5 * 4 * 2 * c) + 4 * c for c in shards)
    assert out["bytes_comp"]["data"] == sum(int(0.5 * 4 * 2 * c) + 4 * c for c in comp)
    assert out["bytes_hier"]["pod,data"] == out["bytes_comp"]["pod,data"] == _psum_bytes(2, 4)
    grad = 4 * sum(sizes)
    assert abs(out["bytes_flat"]["pod,data"] / grad - 1.5) < 1e-3
    assert abs(out["bytes_hier"]["pod"] / grad - 0.5) < 1e-3


def test_checkpoint_with_err_crosses_the_packages(run):
    """Rank 0 wrote the compressed state with ``err`` gathered to
    ``[dp_total, ...]``; the JAX package restores it and finds each rank's
    row; each rank restored its own row, and its own row of a checkpoint
    the JAX package wrote."""
    ranks = run["ranks"]
    like_err = tree_map(lambda t: np.zeros((4,) + tuple(t.shape[1:]), np.float32),
                        ranks[0]["err"])
    like = (_np_tree(ranks[0]["params_comp"]),
            {"step": np.asarray(0, np.int32),
             "m": tree_map(np.zeros_like, _np_tree(ranks[0]["params_comp"])),
             "v": tree_map(np.zeros_like, _np_tree(ranks[0]["params_comp"])), "err": like_err})
    (_, opt), step = jax_ckpt.restore_checkpoint(str(run["workdir"] / "ckpt"), like)
    assert step == 1 and int(opt["step"]) == 1
    by_name = lambda tree: dict(ckpt._paths(tree))  # noqa: E731 - JAX sorts dict keys
    saved, theirs = by_name(opt["err"]), by_name(run["jax_err"])
    for r, out in enumerate(ranks):
        assert out["restored_step"] == 1
        mine, back, from_jax = (by_name(out[k]) for k in ("err", "err_back", "err_from_jax"))
        assert mine.keys() == saved.keys() == theirs.keys()
        for k, whole in saved.items():
            assert mine[k].shape[0] == 1
            np.testing.assert_array_equal(np.asarray(whole)[r], mine[k][0].numpy())
            assert torch.equal(back[k], mine[k])
            np.testing.assert_array_equal(from_jax[k].numpy(), theirs[k][r:r + 1])


def test_a_model_axis_and_moe_wait_for_the_next_slice(run):
    """What this file's first slice refused now runs (the model axis is
    tested on ranks in ``tests/test_torch_train_mesh.py``): a trainer on a
    model axis knows the dim each leaf is split at when it is made; an MoE
    config trains on the mesh, taking the flat sync though the config asks
    for the staged one (as the reference does), every rank ending with the
    same params."""
    first = run["ranks"][0]["moe"]
    for out in run["ranks"]:
        dims = out["model_axis_dims"]
        assert dims["layers"][0]["mixer"]["w_q"] == 1 and dims["final_norm"] is None
        assert set(out["moe"]["bytes"]) == {"pod,data"}
        assert out["moe"]["sums"] == first["sums"] and np.isfinite(out["moe"]["loss"])


def test_launcher_runs_on_four_ranks_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.train", "--mesh", "2x2x1", "--hierarchical-sync",
           "--compress", "--device", "cpu", "--reduced", "--steps", "3", "--batch", "4",
           "--seq", "32", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck"),
           "--ckpt-every", "2"]
    # a session of its own: torchrun's signals to its workers stay there
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=240, cwd=tmp_path,
                          start_new_session=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("backend gloo (ranks on the CPU), mesh {'pod': 2, 'data': 2, "
                               "'model': 1}, 4 ranks"), lines[:2]
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 3 and all(np.isfinite(float(ln.split()[3])) for ln in steps)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_0000000000", "step_0000000002"]
    assert jax_ckpt.verify_checkpoint(str(tmp_path / "ck"), 2)
