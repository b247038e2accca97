"""Training on a ``model`` axis: the port's trainer on gloo ranks against
the JAX package's ``Trainer`` on a JAX mesh of the same shape (8 virtual
CPU devices), REDUCED configs in fp32 without remat, the batch
``SyntheticLM(seed=2)`` of 8 x 32, params from ``PRNGKey(2)`` handed across
by the bridge, and PR 31's bars: at each of two steps, each started from
the reference's params and optimizer state, the loss and the grad norm
within 1e-5 relative and the first moment (the synced gradient) within
1e-5 of each leaf's largest value once the ranks' blocks are gathered.
The cases: internlm2 on pod 2 x data 2 x model 2 with the flat,
hierarchical and compressed syncs (``tests/test_runtime.py``'s shape) and
on data 1 x model 4 (2 KV heads over 4 ranks); mamba2 on 2 x 1 x 2,
hierarchical; granite-moe on 2 x 2 and 1 x 2 (the MoE loss depends on the
mesh's shape: capacity is reckoned per token block) and on pod 2 x data 2
x model 1 with the hierarchical sync asked for (the reference routes its
global batch as one block there, and takes the flat sync); jamba cut to 5
layers (its SSM, attention and MoE layers) on 2 x 2.  Leaves that are
whole over ``model`` stay bit-identical on every rank.  Beside those: the
port's threefry draw against ``jax.random``, the Valiant shuffle's loss and
gradients against the reference's on 2 x 2 at capacity 0.5, checkpoints of
the ranks' blocks across the packages, the bytes each rank sends by group,
and the train launcher on 2 x 1 x 2 under ``torchrun``.

The ranks (``tests/torch_ranks.py``'s ``train_mesh`` case, no JAX) are
spawned while the JAX side computes; they run their first steps from the
initial params and wait for the reference's state after its first step,
which the test writes as it comes."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses
import json
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
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
from repro_torch.bridge import (from_jax_params, gather_blocks, port_order, reference_leaves,
                                to_jax_params)
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.core import threefry
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
# name: (arch, mesh, layers, syncs, extras)
CASES = {
    "dense-2x2x2": ("internlm2-1.8b", "2x2x2", 2, ("flat", "hier", "comp"), {"checkpoint": True}),
    "dense-1x4": ("internlm2-1.8b", "1x4", 2, ("flat",), {}),
    "ssm-2x1x2": ("mamba2-1.3b", "2x1x2", 2, ("hier",), {}),
    "moe-2x2": ("granite-moe-1b-a400m", "2x2", 2, ("flat",), {"valiant": True}),
    "moe-1x2": ("granite-moe-1b-a400m", "1x2", 2, ("flat",), {}),
    # a model axis of 1: the reference routes the global batch as one block
    # and takes the flat sync though the config asks for the staged one
    "moe-2x2x1": ("granite-moe-1b-a400m", "2x2x1", 2, ("hier",), {}),
    "hybrid-2x2": ("jamba-v0.1-52b", "2x2", 5, ("flat",), {}),
}
STEPS = [(c, s) for c, (_, _, _, syncs, _) in CASES.items() for s in syncs if s != "comp"]
JAX_PCFG = {"flat": JaxParallelConfig(hierarchical_grad_sync=False),
            "hier": JaxParallelConfig(hierarchical_grad_sync=True),
            "comp": JaxParallelConfig(compress_cross_pod=True)}


def _shape(mesh: str) -> tuple[int, ...]:
    return tuple(int(n) for n in mesh.split("x"))


def _names(mesh: str) -> tuple[str, ...]:
    return ("pod", "data", "model") if mesh.count("x") == 2 else ("data", "model")


def _jax_cfg(arch, layers):
    return dataclasses.replace(jax_get_config(arch, reduced=True), compute_dtype="float32",
                               remat=False, n_layers=layers)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _write(path: Path, obj) -> None:
    """Pickle ``obj`` to ``path`` in one rename: a rank polling for it
    never reads half a file."""
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _port_tree(cfg_t, jax_tree):
    """A reference tree in the port's layout and leaf order, numpy leaves."""
    return tree_map(lambda t: t.numpy(), port_order(cfg_t, from_jax_params(cfg_t, jax_tree)))


def _reference(name, unit, params, batches, workdir):
    """The reference's part ``unit`` of case ``name`` on its mesh: two
    steps of a sync, the state after the first written for the ranks as
    soon as it is made (the compressed state also as a checkpoint in the
    port's layout, for the ranks to restore); or ("valiant") the Valiant
    runs."""
    arch, mesh, layers, _, extras = CASES[name]
    shape = _shape(mesh)
    jm = jax_make_mesh(shape, _names(mesh), devices=jax.devices()[:int(np.prod(shape))])
    cfg = _jax_cfg(arch, layers)
    out = {}
    with use_mesh(jm):
        if unit == "valiant":
            vcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, valiant_shuffle=True, capacity_factor=0.5))
            vmodel = jax_build_model(vcfg)
            for label, key in (("keyed", jax.random.PRNGKey(7)), ("keyless", None)):
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p, b, key=key: vmodel.train_loss(p, b, key=key, mesh=jm)[0]))(
                    params, batches[0])
                out[f"valiant {label}"] = {"loss": float(loss), "grads": _np(grads)}
            return out
        trainer = JaxTrainer(jax_build_model(cfg), JaxAdamWConfig(lr=1e-3), JAX_PCFG[unit],
                             mesh=jm)
        p0, o0 = trainer.init(jax.random.PRNGKey(2))
        step = trainer.jitted_step(donate=False)
        p1, o1, m1 = step(p0, o0, batches[0])
        if extras.get("checkpoint") and unit == "comp":  # before the state the ranks wait for
            cfg_t = torch_ranks.train_cfg(arch, layers)
            m, v = _port_tree(cfg_t, o1["m"]), _port_tree(cfg_t, o1["v"])
            err = tree_map(lambda _, e: np.asarray(e),
                           reference_leaves(cfg_t, tree_map(torch.as_tensor, m)), o1["err"])
            tree = (_port_tree(cfg_t, p1), {"step": np.asarray(1, np.int32), "m": m, "v": v,
                                            "err": err})
            jax_ckpt.save_checkpoint(str(workdir / "jax_ckpt"), 1, tree)
        _write(workdir / f"ref_{unit}.pkl", {"params": _np(p1), "opt": _np(o1)})
        p2, o2, m2 = step(p1, o1, batches[1])
        out[unit] = [{"m": _np(o["m"]), "err": _np(o.get("err")), "loss": float(mm["loss"]),
                      "grad_norm": float(mm["grad_norm"])} for o, mm in ((o1, m1), (o2, m2))]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    archs = {(arch, layers) for arch, _, layers, _, _ in CASES.values()}
    params = {a: jax_build_model(_jax_cfg(*a)).init(jax.random.PRNGKey(2)) for a in archs}
    batches_np = {}
    pending, dirs = {}, {}
    for name, (arch, mesh, layers, syncs, extras) in CASES.items():
        cfg = _jax_cfg(arch, layers)
        pipe = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=2)
        batches_np[name] = [pipe.global_batch_arrays(i) for i in range(2)]
        work = dirs[name] = tmp_path_factory.mktemp(f"train_mesh_{name}")
        np.savez(work / "inputs.npz", **{k: np.stack([b[k] for b in batches_np[name]])
                                         for k in ("tokens", "targets")})
        (work / "train_mesh.json").write_text(json.dumps(
            {"arch": arch, "layers": layers, "syncs": list(syncs), **extras}))
        with open(work / "params.pkl", "wb") as f:
            pickle.dump(_np(params[arch, layers]), f)
        pending[name] = torch_ranks.spawn("train_mesh", work, world=int(np.prod(_shape(mesh))),
                                          timeout=600.0, mesh=mesh, wait=False)
    units = [(name, unit) for name, (_, _, _, syncs, extras) in CASES.items()
             for unit in syncs + (("valiant",) if extras.get("valiant") else ())]
    with ThreadPoolExecutor(len(units)) as pool:  # one a sync: their compiles overlap
        parts = [(name, pool.submit(
            _reference, name, unit, params[CASES[name][0], CASES[name][2]],
            [{k: jnp.asarray(v) for k, v in b.items()} for b in batches_np[name]], dirs[name]))
            for name, unit in units]
        ref = {name: {} for name in CASES}
        for name, part in parts:
            ref[name].update(part.result())
    ranks = {name: wait() for name, wait in pending.items()}
    return {"ref": ref, "ranks": ranks, "dirs": dirs,
            "params": {a: _np(p) for a, p in params.items()}}


def _cfg_t(name):
    arch, _, layers, _, _ = CASES[name]
    return torch_ranks.train_cfg(arch, layers)


def _slices(name, ranks):
    """The ranks grouped by ``model`` slice, each in model order."""
    m = _shape(CASES[name][1])[-1]
    return [ranks[i:i + m] for i in range(0, len(ranks), m)]


def _whole(name, outs, key, part):
    """The whole leaves of ``part`` (``m``, ``params``...) of the result
    ``key`` on each ``model`` slice, in the reference's layout."""
    dims = outs[0]["dims"]
    return [to_jax_params(_cfg_t(name), gather_blocks([o[key][part] for o in sl], dims))
            for sl in _slices(name, outs)]


def _leaf_rels(a, b) -> dict:
    """Each leaf's largest difference over that leaf's largest value, by
    leaf name."""
    return {jax.tree_util.keystr(k): float(np.max(np.abs(np.asarray(x, np.float32)
                                                         - np.asarray(y, np.float32))))
            / max(float(np.max(np.abs(np.asarray(y, np.float32)))), 1e-30)
            for (k, x), y in zip(jax.tree_util.tree_leaves_with_path(a), jax.tree.leaves(b))}


def _leaf_rel(a, b) -> float:
    """The largest leaf difference over that leaf's largest value."""
    return max(_leaf_rels(a, b).values())


def _mostly_within(got, want, tol: float, few: float = 1e-3) -> bool:
    """All but ``ceil(few * size)`` elements of ``got`` within ``tol`` of ``want``."""
    off = np.abs(np.asarray(got) - np.asarray(want)) > tol
    return int(off.sum()) <= int(np.ceil(few * off.size))


@pytest.mark.parametrize("t", [1, 7, 16, 32, 64, 128, 12345])
def test_threefry_randint_equals_jax(t):
    """The Valiant shift's draw, ``jax.random.randint(key, (), 0, t)``,
    repeated without JAX for 200 keys at each token-block size."""
    keys = jnp.stack([jax.random.PRNGKey(k) for k in range(200)])
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, t))(keys))
    got = [threefry.randint(np.asarray(jax.random.key_data(k)), 0, t) for k in keys]
    assert got == want.tolist()


def test_threefry_key_split_and_bits_equal_jax():
    for seed in (0, 7, 2**31 + 5):
        key = jax.random.PRNGKey(seed)
        words = threefry.prng_key(seed)
        np.testing.assert_array_equal(words, np.asarray(jax.random.key_data(key)))
        np.testing.assert_array_equal(threefry.split(words, 4),
                                      np.asarray(jax.random.key_data(jax.random.split(key, 4))))
        assert int(threefry.random_bits32(words)) == int(jax.random.bits(key, (), jnp.uint32))


# The SSM mixer's gradient leaves against the reference's: the bar of the
# one-device SSM train test (tests/test_torch_train_ssm.py), whose fp32
# chunked scan sums in another order than the reference's without any mesh
# (jamba's a_log came to 1.05e-5 of its largest value here).
SSM_TOL = 1e-4


def _ssm_leaf(name: str, key: str) -> bool:
    arch = CASES[name][0]
    cfg = jax_get_config(arch, reduced=True)
    if cfg.ssm is None or "['mixer']" not in key:
        return False
    j = int(key.split("['decoder'][")[1].split("]")[0])  # the pattern position
    return not cfg.layer_is_attention(j)


@pytest.mark.parametrize("name,sync", STEPS, ids=[f"{c}-{s}" for c, s in STEPS])
def test_step_matches_the_reference_trainer(run, name, sync):
    """Every rank's loss and grad norm within 1e-5 relative of the
    reference's at both steps, and each ``model`` slice's first moment,
    its blocks gathered, within 1e-5 of each leaf's largest value (an SSM
    mixer's leaves within ``SSM_TOL``)."""
    ranks = run["ranks"][name]
    for step in (1, 2):
        want = run["ref"][name][sync][step - 1]
        for r, out in enumerate(ranks):
            metrics = out[f"step{step} {sync}"]["metrics"]
            assert metrics["loss"] == pytest.approx(want["loss"], rel=1e-5), (step, r)
            assert metrics["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5), (step, r)
        for i, m in enumerate(_whole(name, ranks, f"step{step} {sync}", "m")):
            rels = _leaf_rels(m, want["m"])
            off = {k: v for k, v in rels.items() if v >= (SSM_TOL if _ssm_leaf(name, k) else 1e-5)}
            assert not off, (step, i, off)


def test_compressed_step_matches_the_reference_trainer(run):
    """The int8 cross-pod sync on 2 x 2 x 2 at each of two steps, PR 31's
    bars: loss and grad norm within 1e-5 relative; the first moment, all but
    one element in a thousand of each leaf within 1e-5 of its largest value
    (elements on a rounding edge may move by a quantum); every rank's
    ``err`` row, in the whole leaves' layout, against the reference's row
    at its (pod, data) index, all but one in a thousand within a thousandth
    of a quantum and all within one."""
    name = "dense-2x2x2"
    ranks = run["ranks"][name]
    by_name = lambda tree: dict(ckpt._paths(tree))  # noqa: E731
    for step in (1, 2):
        want = run["ref"][name]["comp"][step - 1]
        theirs = by_name(want["err"])
        for r, out in enumerate(ranks):
            rec = out[f"step{step} comp"]
            assert rec["metrics"]["loss"] == pytest.approx(want["loss"], rel=1e-5)
            assert rec["metrics"]["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
            mine = by_name(tree_map(lambda t: t.numpy(), rec["err"]))
            assert mine.keys() == theirs.keys()
            row = r // 2  # the rank's (pod, data) index
            for k, e in mine.items():
                half = float(np.max(np.abs(theirs[k][row])))
                assert _mostly_within(e[0], theirs[k][row], 2e-3 * half), (step, r, k)
                assert np.max(np.abs(e[0] - theirs[k][row])) <= 2 * half * (1 + 1e-3)
        for m in _whole(name, ranks, f"step{step} comp", "m"):
            for a, b in zip(jax.tree.leaves(m), jax.tree.leaves(want["m"])):
                assert _mostly_within(a, b, 1e-5 * float(np.max(np.abs(b)))), step


@pytest.mark.parametrize("name", list(CASES))
def test_whole_leaves_stay_bit_identical_on_every_rank(run, name):
    """After two steps every rank holds the same bits of each leaf that is
    whole over ``model`` (params and first moment), and the ranks of the
    data-parallel axes the same blocks."""
    ranks = run["ranks"][name]
    m = _shape(CASES[name][1])[-1]
    dims = ranks[0]["dims"]  # None on a model axis of 1: every leaf whole
    flags = ([True] * len(tree_leaves(ranks[0]["step2 " + CASES[name][3][0]]["params"]))
             if dims is None else [d is None for d in tree_leaves(dims)])
    for sync in CASES[name][3]:
        for part in ("params", "m"):
            first = [tree_leaves(o[f"step2 {sync}"][part]) for o in ranks]
            for r, leaves in enumerate(first):
                same = ranks[r % m]  # the rank of the first data-parallel slice, same blocks
                for i, (a, whole) in enumerate(zip(leaves, flags)):
                    ref = first[0][i] if whole else tree_leaves(same[f"step2 {sync}"][part])[i]
                    assert torch.equal(a, ref), (sync, part, r, i)


def test_moe_loss_depends_on_the_mesh_as_the_reference_does(run):
    """granite's losses on 2 x 2, 1 x 2 and 2 x 2 x 1 (its token blocks:
    four, two, and the global batch as one) differ from each other in the
    reference, and the port follows each."""
    names = ("moe-2x2", "moe-1x2", "moe-2x2x1")
    losses = {n: run["ref"][n][CASES[n][3][0]][0]["loss"] for n in names}
    assert min(abs(losses[a] - losses[b]) for a in names for b in names if a < b) > 1e-3
    for n, want in losses.items():
        got = run["ranks"][n][0][f"step1 {CASES[n][3][0]}"]["metrics"]["loss"]
        assert got == pytest.approx(want, rel=1e-5)


def test_valiant_shuffle_matches_the_reference(run):
    """granite on 2 x 2 with ``valiant_shuffle`` at capacity 0.5, keyed by
    ``PRNGKey(7)`` (its two words): the loss within 1e-5 relative and every
    gradient within 1e-5 of its leaf's largest value of the reference's
    ``jax.value_and_grad(train_loss(key=...))``, keyed and keyless."""
    name = "moe-2x2"
    cfg = _cfg_t(name)
    ranks = run["ranks"][name]
    for label in ("keyed", "keyless"):
        want = run["ref"][name][f"valiant {label}"]
        for out in ranks:
            assert out[f"valiant {label}"]["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for sl in _slices(name, ranks):
            trees = []
            for out in sl:
                it = iter(out[f"valiant {label}"]["grads"])
                trees.append(tree_map(lambda _: next(it), out["step1 flat"]["m"]))
            got = to_jax_params(cfg, gather_blocks(trees, ranks[0]["dims"]))
            assert _leaf_rel(got, want["grads"]) < 1e-5, label


def test_valiant_shift_changes_the_loss_as_in_the_reference(run):
    ref = run["ref"]["moe-2x2"]
    got = run["ranks"]["moe-2x2"][0]
    assert abs(ref["valiant keyed"]["loss"] - ref["valiant keyless"]["loss"]) > 1e-4
    assert abs(got["valiant keyed"]["loss"] - got["valiant keyless"]["loss"]) > 1e-4


def _np_tree(tree):
    return tree_map(lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else t, tree)


def test_checkpoint_of_ranks_restores_in_one_process_and_in_the_reference(run):
    """The compressed state after the 2 x 2 x 2 ranks' first step, written
    by them (blocks gathered over ``model``, ``err`` rows over the
    data-parallel axes): restored in one process by the port and by the
    JAX package, it equals the ranks' blocks put together, bit for bit."""
    name = "dense-2x2x2"
    ranks = run["ranks"][name]
    dims = ranks[0]["dims"]
    rec = [o["step1 comp"] for o in ranks[:2]]  # one model slice
    whole = {part: _np_tree(gather_blocks([r[part] for r in rec], dims))
             for part in ("params", "m", "v")}
    err = tree_map(lambda *rows: np.concatenate(rows), *[_np_tree(o["step1 comp"]["err"])
                                                         for o in ranks[::2]])
    like = (whole["params"], {"step": 0, "m": whole["m"], "v": whole["v"], "err": err})
    directory = str(run["dirs"][name] / "ckpt")
    (p, o), step = ckpt.restore_checkpoint(directory, tree_map(torch.as_tensor, like))
    assert step == 1 and o["step"] == 1
    for a, b in zip(tree_leaves((p, o)), tree_leaves(like)):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a.numpy(), b)
    jax_like = (like[0], {**like[1], "step": np.asarray(0, np.int32)})
    (jp, jo), step = jax_ckpt.restore_checkpoint(directory, jax_like)
    assert step == 1 and int(jo["step"]) == 1
    by_name = lambda tree: dict(ckpt._paths(tree))  # noqa: E731 - JAX sorts dict keys
    theirs, mine = by_name((jp, jo)), by_name(jax_like)
    assert theirs.keys() == mine.keys()
    for k, v in mine.items():
        if k != "[1]['step']":
            np.testing.assert_array_equal(np.asarray(theirs[k]), v, err_msg=k)


def test_reference_checkpoint_restores_on_the_ranks(run):
    """A checkpoint the JAX package wrote after its first compressed step
    (whole leaves, ``err`` in ``[dp_total, ...]`` rows) restores on each
    of the 2 x 2 x 2 ranks into its blocks and row, bit for bit equal to
    what the bridge hands it from the same state."""
    for out in run["ranks"]["dense-2x2x2"]:
        assert out["from jax ckpt step"] == 1
        assert out["from jax ckpt"] is True


def test_each_sync_sends_its_bytes_by_group(run):
    """On 2 x 2 x 2: flat and hierarchical syncs send each rank's blocks
    over the data-parallel axes, so the bytes there are about half the
    whole-leaf figures of PR 31's sync over (pod, data) (the leaves split
    over ``model`` halve, the whole ones do not); the compressed sync
    gathers the split gradients over ``model`` first, so its ``model``
    bytes exceed the others' by at least those blocks; the forward and
    backward collectives send over ``model`` alone."""
    out = run["ranks"]["dense-2x2x2"][0]
    dims = out["dims"]
    blocks = tree_leaves(out["step1 flat"]["params"])
    split = sum(4 * t.numel() for t, d in zip(blocks, tree_leaves(dims)) if d is not None)
    whole = sum(4 * t.numel() for t, d in zip(blocks, tree_leaves(dims)) if d is None)
    flat, hier, comp = (out[f"bytes {s}"] for s in ("flat", "hier", "comp"))
    assert set(flat) == {"model", "pod,data"}
    grad = split + whole  # a rank's gradient blocks
    assert 1.5 * grad <= flat["pod,data"] <= 1.5 * grad * 1.01 + 64
    assert hier["pod"] < flat["pod,data"] / 2 and "data" in hier
    assert comp["model"] - hier["model"] >= split
    assert flat["model"] == hier["model"] > 0


def test_train_launcher_runs_on_a_model_axis_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.train", "--mesh", "2x1x2", "--hierarchical-sync",
           "--compress", "--device", "cpu", "--reduced", "--steps", "3", "--batch", "4",
           "--seq", "32", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck"),
           "--ckpt-every", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=240, cwd=tmp_path,
                          start_new_session=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("backend gloo (ranks on the CPU), mesh {'pod': 2, 'data': 1, "
                               "'model': 2}, 4 ranks"), lines[:2]
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 3 and all(np.isfinite(float(ln.split()[3])) for ln in steps)
    assert any(ln.startswith("bytes rank 0 sent in the last step, by group: {'model': ")
               for ln in lines), lines
    assert jax_ckpt.verify_checkpoint(str(tmp_path / "ck"), 2)
