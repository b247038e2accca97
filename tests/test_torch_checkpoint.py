"""The port's checkpoints and restarts (``repro_torch.checkpoint``,
``repro_torch.runtime.fault_tolerance``, the train launcher's ``--ckpt-dir``
and ``--resume``) against the JAX package's: the counterparts of its
checkpoint and fault-tolerance tests, each package's checkpoint verified and
restored by the other, AdamW's Python-int step, bf16 leaves, and the
pitfalls of a trainer that updates its params and moments in place (the
asynchronous save's snapshot, the restart loop's copy of its initial state,
fresh restored tensors that require grad).  Resumed runs of a small
``Trainer`` on the CPU end bit-identical to uninterrupted ones.  The
straggler monitor runs on a fake clock: nothing here sleeps."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jax_ckpt
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.checkpoint.checkpointing import (AsyncCheckpointer, latest_intact_step,
                                                  latest_step, restore_checkpoint,
                                                  save_checkpoint, verify_checkpoint)
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import StragglerMonitor, plan_remesh, run_with_restarts
from repro_torch.runtime.trainer import Trainer, value_and_grads
from repro_torch.tree import tree_leaves

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


# ---------------------------------------------------------------- the format
def test_checkpoint_roundtrip_and_validation(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": {"c": torch.ones(4)}}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, tree)
    save_checkpoint(d, 7, tree)
    assert latest_step(d) == 7
    restored, step = restore_checkpoint(d, tree)
    assert step == 7
    assert torch.equal(restored["a"], tree["a"]) and restored["a"] is not tree["a"]
    # keep-N pruning
    for s in (9, 11, 13):
        save_checkpoint(d, s, tree, keep=2)
    assert latest_step(d) == 13
    assert len([s for s in os.listdir(d) if s.startswith("step_")]) == 2
    # shape drift detection
    with pytest.raises(ValueError, match="shape drift"):
        restore_checkpoint(d, {"a": torch.zeros(3, 3), "b": {"c": torch.ones(4)}})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(d, {"a": tree["a"], "b": {"d": torch.ones(4)}})


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.ones(8)}
    path = save_checkpoint(d, 1, tree)
    data_file = os.path.join(path, "arrays.npz")
    blob = bytearray(open(data_file, "rb").read())
    blob[-20] ^= 0xFF
    open(data_file, "wb").write(bytes(blob))
    assert not verify_checkpoint(d, 1)
    with pytest.raises(Exception):
        restore_checkpoint(d, tree)


def test_restore_step_none_skips_damaged_newest(tmp_path):
    """step=None restores the newest intact checkpoint: a crash-truncated
    newest step is skipped, an explicit step= still raises."""
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.ones(8)}
    for s in (1, 2, 3):
        save_checkpoint(d, s, {"w": tree["w"] * s})
    data_file = os.path.join(d, "step_0000000003", "arrays.npz")
    blob = open(data_file, "rb").read()
    open(data_file, "wb").write(blob[: len(blob) // 2])
    assert latest_step(d) == 3
    assert not verify_checkpoint(d, 3)
    assert verify_checkpoint(d, 2)
    assert latest_intact_step(d) == 2
    restored, step = restore_checkpoint(d, tree)
    assert step == 2
    assert torch.equal(restored["w"], tree["w"] * 2)
    with pytest.raises(Exception):
        restore_checkpoint(d, tree, step=3)


def test_restore_raises_when_no_intact_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.ones(4)}
    path = save_checkpoint(d, 0, tree)
    os.remove(os.path.join(path, "arrays.npz"))
    with pytest.raises(IOError):
        restore_checkpoint(d, tree)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nowhere"), tree)


def test_checkpoint_pruning_drops_oldest_first(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.zeros(2)}
    for s in (5, 1, 9, 3, 7):  # out-of-order saves
        save_checkpoint(d, s, tree, keep=3)
    kept = sorted(int(n[5:]) for n in os.listdir(d) if n.startswith("step_"))
    assert kept == [5, 7, 9]
    assert latest_step(d) == 9


def _plain_tree(seed=0):
    """A tree of dicts, lists and tuples of fp32 and int leaves, as numpy."""
    rng = np.random.default_rng(seed)
    return {"embed": rng.normal(size=(5, 3)).astype(np.float32),
            "layers": [{"wq": rng.normal(size=(3, 3)).astype(np.float32),
                        "ln": rng.normal(size=(3,)).astype(np.float32)} for _ in range(2)],
            "pair": (rng.normal(size=(2,)).astype(np.float32),
                     rng.integers(0, 9, (4,)).astype(np.int32))}


def test_leaf_names_are_the_reference_keystr_names(tmp_path):
    """The port's leaf names are ``jax.tree_util.keystr``'s, and both
    packages write the same manifest for the same tree (up to the order of
    its entries: the JAX package sorts dict keys)."""
    tree = _plain_tree()
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 1, tree)
    save_checkpoint(str(tmp_path / "t"), 1, tree)
    read = lambda who: json.loads((tmp_path / who / "step_0000000001" / "manifest.json")  # noqa: E731
                                  .read_text())
    assert read("t") == read("j")
    assert {"['layers'][1]['wq']", "['pair'][1]"} <= set(read("t")["leaves"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_verifies_and_restores_the_others_checkpoint(tmp_path, writer):
    tree = _plain_tree(1)
    d = str(tmp_path / "ckpt")
    if writer == "jax":
        jax_ckpt.save_checkpoint(d, 4, tree)
        assert verify_checkpoint(d, 4) and latest_intact_step(d) == 4
        like = tree_map_np(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype), tree)
        got, step = restore_checkpoint(d, like)
        got = tree_map_np(lambda t: t.numpy(), got)
    else:
        save_checkpoint(d, 4, tree_map_np(torch.from_numpy, tree))
        assert jax_ckpt.verify_checkpoint(d, 4) and jax_ckpt.latest_intact_step(d) == 4
        got, step = jax_ckpt.restore_checkpoint(d, tree_map_np(np.zeros_like, tree))
    assert step == 4
    got, want = dict(ckpt._paths(got)), dict(ckpt._paths(tree))  # by name: JAX sorts keys
    assert got.keys() == want.keys()
    for k, a in got.items():
        assert a.dtype == want[k].dtype and np.array_equal(a, want[k]), k


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("arch", ["minicpm3-4b", "seamless-m4t-large-v2"])
def test_each_package_restores_the_others_model_checkpoint(tmp_path, arch, writer):
    """REDUCED params of the MLA model and of the encoder-decoder, in the
    JAX package's layout (the scan-stacked ``decoder`` tuple, seamless's
    ``encoder`` beside it, the MLA and cross-attention leaves): written by
    one package, restored by the other, and across the bridge the same
    port params bit for bit."""
    import jax

    from repro.configs.base import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.bridge import from_jax_params, to_jax_params

    cfg = get_config(arch, reduced=True)
    d = str(tmp_path / "ckpt")
    if writer == "jax":
        tree = jax.tree.map(np.array, jax_build_model(jax_get_config(arch, reduced=True))
                            .init(jax.random.PRNGKey(0)))
        jax_ckpt.save_checkpoint(d, 3, tree)
        like = tree_map_np(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype), tree)
        got, step = restore_checkpoint(d, like)
        got, want = from_jax_params(cfg, tree_map_np(lambda t: t.numpy(), got)), \
            from_jax_params(cfg, tree)
    else:
        mine = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        tree = to_jax_params(cfg, mine)
        save_checkpoint(d, 3, tree_map_np(torch.from_numpy, tree))
        assert jax_ckpt.verify_checkpoint(d, 3)
        got, step = jax_ckpt.restore_checkpoint(d, tree_map_np(np.zeros_like, tree))
        got, want = from_jax_params(cfg, jax.tree.map(np.asarray, got)), mine
    assert step == 3
    got, want = dict(ckpt._paths(got)), dict(ckpt._paths(want))  # by name: JAX sorts keys
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def tree_map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_np(fn, v) for v in tree)
    return fn(tree)


def test_adamw_step_comes_back_a_python_int(tmp_path):
    d = str(tmp_path / "ckpt")
    opt = {"step": 7, "m": {"w": torch.ones(3)}, "v": {"w": torch.full((3,), 2.0)}}
    save_checkpoint(d, 7, opt)
    got, _ = restore_checkpoint(d, {"step": 0, "m": {"w": torch.zeros(3)},
                                    "v": {"w": torch.zeros(3)}})
    assert type(got["step"]) is int and got["step"] == 7
    assert _equal_trees(got, opt)


def test_bf16_leaves_round_trip_bit_exactly(tmp_path):
    """numpy has no bf16: a bf16 leaf is written as its raw 2-byte words, as
    the JAX package writes one, and restores bit for bit, also from a
    checkpoint the JAX package wrote; a type numpy lacks and the port cannot
    store is refused by name."""
    import jax.numpy as jnp

    bits = torch.from_numpy(np.array([0x3F80, 0x0001, 0x7F7F, 0xFF80, 0x7FC1, 0x8000],
                                     np.uint16).view(np.int16))
    w = bits.view(torch.bfloat16)  # 1, a subnormal, max, -inf, a NaN, -0
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 0, {"w": w, "f": torch.ones(2)})
    got, _ = restore_checkpoint(d, {"w": torch.zeros(6, dtype=torch.bfloat16),
                                    "f": torch.zeros(2)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"].view(torch.int16), bits)
    assert jax_ckpt.verify_checkpoint(d, 0)
    dj = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(dj, 0, {"w": jnp.asarray(bits.numpy()).view(jnp.bfloat16)})
    got, _ = restore_checkpoint(dj, {"w": torch.zeros(6, dtype=torch.bfloat16)})
    assert torch.equal(got["w"].view(torch.int16), bits)
    with pytest.raises(TypeError, match="Float8_e4m3fn|float8"):
        save_checkpoint(str(tmp_path / "f8"), 0, {"w": torch.zeros(2, dtype=torch.float8_e4m3fn)})


# ------------------------------------------------------- in-place pitfalls
def test_async_save_holds_the_values_from_before_an_in_place_update(tmp_path, monkeypatch):
    """The worker is held until the tree has been updated in place: the
    checkpoint still holds the values ``save`` was given."""
    gate = threading.Event()
    write = ckpt._write_arrays
    monkeypatch.setattr(ckpt, "_write_arrays", lambda *a: gate.wait(10) and write(*a))
    d = str(tmp_path / "ckpt")
    params = {"w": torch.arange(4.0).requires_grad_(), "layers": [{"s": torch.ones(3)}]}
    opt = {"step": 1, "m": {"w": torch.zeros(4)}}
    before = [t.detach().clone() for t in tree_leaves(params)] + [opt["m"]["w"].clone()]
    with AsyncCheckpointer() as saver:
        saver.save(d, 1, (params, opt))
        with torch.no_grad():
            for t in tree_leaves(params) + [opt["m"]["w"]]:
                t.add_(1)
        opt["step"] = 2
        gate.set()
        saver.wait()
        assert verify_checkpoint(d, 1)
    (p, o), _ = restore_checkpoint(d, (params, opt))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p) + [o["m"]["w"]], before))
    assert o["step"] == 1


def test_async_checkpointer_surfaces_write_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = AsyncCheckpointer(max_in_flight=1)
    saver.save(str(blocker), 0, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.close()
    with pytest.raises(ValueError):
        AsyncCheckpointer(max_in_flight=0)


def test_restore_builds_fresh_tensors_that_require_grad_where_the_tree_did(tmp_path):
    cfg = _small_cfg()
    model = build_model(cfg, device="cpu")
    trainer = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 0, (params, opt))
    (p2, o2), _ = restore_checkpoint(d, (params, opt))
    assert all(a is not b and b.requires_grad and torch.equal(a, b.detach())
               for a, b in zip(tree_leaves(params), tree_leaves(p2)))
    assert not any(t.requires_grad for t in tree_leaves(o2["m"]))
    grads, _ = value_and_grads(model, p2, _pipe(cfg).global_batch_arrays(0))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


# ---------------------------------------------------------------- restarts
def test_run_with_restarts_recovers(tmp_path):
    """Failures at steps 4 and 9: the same final state as an uninterrupted
    run (pure-function steps + skip-ahead)."""
    fails = {4: False, 9: False}

    def step_fn(state, step):
        if step in fails and not fails[step]:
            fails[step] = True
            raise RuntimeError(f"injected failure at {step}")
        return {"x": state["x"] + step}

    state, restarts = run_with_restarts(step_fn, {"x": torch.zeros(())}, n_steps=12,
                                        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
    assert restarts == 2
    assert float(state["x"]) == sum(range(12))


def test_run_with_restarts_falls_back_to_its_own_copy_of_the_initial_state(tmp_path):
    """A step that updates the state in place and fails before the first
    checkpoint: the loop restarts from the state it was first given, not
    from the updated tensors."""
    failed = []

    def step_fn(state, step):
        state["x"].add_(step + 1)  # in place, as the port's trainer updates
        if step == 0 and not failed:
            failed.append(step)
            raise RuntimeError("injected failure before the first checkpoint")
        return state

    init = {"x": torch.zeros(3)}
    state, restarts = run_with_restarts(step_fn, init, n_steps=4, ckpt_dir=str(tmp_path / "c"),
                                        ckpt_every=2)
    assert restarts == 1 and torch.equal(state["x"], torch.full((3,), 10.0))


def test_run_with_restarts_gives_up_after_max_restarts(tmp_path):
    def step_fn(state, step):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="always"):
        run_with_restarts(step_fn, {"x": torch.zeros(())}, 3, str(tmp_path / "c"),
                          max_restarts=2)


def test_straggler_monitor_flags_outliers_on_a_fake_clock():
    now = [0.0]
    mon = StragglerMonitor(window=16, threshold=2.0, clock=lambda: now[0])
    for _ in range(10):
        mon.step_start()
        now[0] += 0.001
        assert not mon.step_end()
    mon.step_start()
    now[0] += 0.05
    assert mon.step_end()  # 50x the median
    assert mon.median == pytest.approx(0.001)
    short = StragglerMonitor(clock=lambda: now[0])
    for _ in range(7):  # fewer than 8 steps never flag
        short.step_start()
        now[0] += 1.0
        assert not short.step_end()


def test_plan_remesh_preserves_global_batch():
    from repro.runtime.fault_tolerance import plan_remesh as jax_plan_remesh

    plan = plan_remesh(surviving_devices=192, model_parallel=16, global_batch=256, prev_dp=16)
    assert plan.model_parallel == 16
    assert plan.data_parallel * plan.model_parallel <= 192
    assert 256 % plan.data_parallel == 0
    assert plan.microbatches * plan.data_parallel >= 16
    for args in ((192, 16, 256, 16), (6, 1, 64, 8, 2), (7, 1, 24, 4), (32, 4, 256, 2, 4)):
        assert dataclasses.asdict(plan_remesh(*args)) == dataclasses.asdict(jax_plan_remesh(*args))
    with pytest.raises(ValueError):
        plan_remesh(8, 16, 256, 16)


# ------------------------------------------------------ the trainer resumed
def _small_cfg():
    return dataclasses.replace(get_config("granite-moe-1b-a400m", reduced=True),
                               compute_dtype="float32", n_layers=2)


def _pipe(cfg):
    # 64 tokens: the CPU's embedding backward sums in one thread (in no fixed
    # order across threads once tokens x d_model passes about 32768), so
    # two runs of a step repeat bit for bit
    return SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=0)


def _trainer_run(tmp_path, n_steps, fail_at=(), split=None):
    """n_steps Trainer steps of the small MoE config from seed 0: straight,
    through ``run_with_restarts`` with failures injected after the step
    bodies of ``fail_at`` (once each), or (``split``) stopped after that
    many steps, saved, restored and run on.  Returns (params, opt, losses by
    step, restarts)."""
    cfg = _small_cfg()
    model = build_model(cfg, device="cpu")
    trainer = Trainer(model, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=n_steps))
    pipe = _pipe(cfg)
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    losses = {}
    pending = set(fail_at)

    def step_fn(state, step):
        p, o, m = trainer.step(*state, pipe.global_batch_arrays(step))
        losses[step] = float(m["loss"])
        if step in pending:
            pending.discard(step)
            raise RuntimeError(f"injected failure after step {step}")
        return p, o

    if fail_at:
        (params, opt), restarts = run_with_restarts(step_fn, (params, opt), n_steps,
                                                    str(tmp_path / "restarts"), ckpt_every=2)
        return params, opt, losses, restarts
    state = (params, opt)
    for step in range(n_steps if split is None else split):
        state = step_fn(state, step)
    if split is not None:
        d = str(tmp_path / "split")
        save_checkpoint(d, split - 1, state)
        fresh = trainer.init(torch.Generator().manual_seed(1))
        state, last = restore_checkpoint(d, fresh)
        for step in range(last + 1, n_steps):
            state = step_fn(state, step)
    return *state, losses, 0


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    return _trainer_run(tmp_path_factory.mktemp("straight"), 6)


def test_resumed_trainer_is_bit_identical_to_a_straight_run(tmp_path, straight):
    """Six steps straight against three, a save, a restore into a tree of
    other values, and three more: params, moments, step and losses equal
    bit for bit."""
    p, o, losses, _ = _trainer_run(tmp_path, 6, split=3)
    sp, so, slosses, _ = straight
    assert o["step"] == so["step"] == 6 and type(o["step"]) is int
    assert _equal_trees(p, sp) and _equal_trees(o, so) and losses == slosses


def test_restarted_trainer_is_bit_identical_to_a_straight_run(tmp_path, straight):
    """``run_with_restarts`` with checkpoints every 2 steps and failures
    after step 0's update (before its checkpoint: the loop falls back to
    its copy of the initial state) and after step 3 (back to step 2's
    checkpoint): params, moments and losses equal the straight run's bit for
    bit."""
    p, o, losses, restarts = _trainer_run(tmp_path, 6, fail_at=(0, 3))
    sp, so, slosses, _ = straight
    assert restarts == 2
    assert _equal_trees(p, sp) and _equal_trees(o, so) and losses == slosses


def test_train_launcher_resume_prints_the_same_step_lines(tmp_path, capsys):
    """--ckpt-dir every 2 steps (--resume into an empty directory starts
    afresh); with the last checkpoint lost, as after a crash, --resume
    restarts after step 2 and prints the straight run's lines for steps 3
    and 4."""
    d = tmp_path / "ckpt"
    argv = ["--reduced", "--device", "cpu", "--steps", "5", "--batch", "2", "--seq", "32",
            "--log-every", "1", "--ckpt-dir", str(d), "--ckpt-every", "2", "--resume"]
    train_launcher.main(argv)
    out = capsys.readouterr()
    straight_lines = [l for l in out.out.splitlines() if l.startswith("step ")]
    assert len(straight_lines) == 5 and "resumed" not in out.err
    assert sorted(os.listdir(d)) == ["step_0000000000", "step_0000000002", "step_0000000004"]
    os.rename(d / "step_0000000004", tmp_path / "lost")
    train_launcher.main(argv)
    out = capsys.readouterr()
    resumed = [l for l in out.out.splitlines() if l.startswith("step ")]
    assert resumed == straight_lines[3:]
    assert "resumed from step 2" in out.err


def test_mesh_checkpoint_slices_only_the_rows_the_caller_names(tmp_path):
    """With a mesh, only the leaves under the caller's ``rows`` path are a
    rank's rows (gathered on save, sliced on restore); a params entry that
    happens to be named ``err`` is an ordinary leaf.  ``rows`` without a
    mesh raises.  A one-rank mesh needs no process group."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    tree = ({"err": torch.arange(3.0)}, {"step": 1, "err": {"w": torch.ones(1, 4)}})
    save_checkpoint(str(tmp_path), 1, tree, mesh=mesh, rows=(1, "err"))
    like = ({"err": torch.zeros(3)}, {"step": 0, "err": {"w": torch.zeros(1, 4)}})
    (params, opt), step = restore_checkpoint(str(tmp_path), like, mesh=mesh, rows=(1, "err"))
    assert step == 1 and opt["step"] == 1
    assert torch.equal(params["err"], torch.arange(3.0))
    assert torch.equal(opt["err"]["w"], torch.ones(1, 4))
    with pytest.raises(ValueError, match="mesh"):
        save_checkpoint(str(tmp_path), 2, tree, rows=(1, "err"))


def test_mesh_checkpoint_on_a_model_axis_needs_the_split_dims(tmp_path):
    """On a model axis above 1 each rank holds blocks, which a checkpoint
    without ``dims`` would write (and restore) as if they were whole
    leaves: save and restore refuse, before any collective, and ``{}``
    says that no leaf is split.  On rank 1 of a model axis of 2 a restore
    hands the rank its block of each leaf ``dims`` names, in tensors and
    in numpy leaves."""
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(("data", "model"), (1, 2), 1, {}, "gloo")
    whole = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.arange(3.0),
             "n": np.arange(6.0).reshape(2, 3)}
    save_checkpoint(str(tmp_path), 1, whole)
    with pytest.raises(ValueError, match="dims"):
        save_checkpoint(str(tmp_path), 2, whole, mesh=mesh)
    like = {"w": torch.zeros(3, 2), "b": torch.zeros(3), "n": np.zeros((2, 3))}
    with pytest.raises(ValueError, match="dims"):
        restore_checkpoint(str(tmp_path), like, mesh=mesh)
    got, step = restore_checkpoint(str(tmp_path), like, mesh=mesh, dims={"w": 1, "b": None})
    assert step == 1
    assert torch.equal(got["w"], whole["w"][:, 2:]) and torch.equal(got["b"], whole["b"])
    np.testing.assert_array_equal(got["n"], whole["n"])
    like["n"] = np.zeros((1, 3))
    got, _ = restore_checkpoint(str(tmp_path), like, mesh=mesh, dims={"w": 1, "n": 0})
    np.testing.assert_array_equal(got["n"], whole["n"][1:])
    got, _ = restore_checkpoint(str(tmp_path), {"b": torch.zeros(3)}, mesh=mesh, dims={})
    assert torch.equal(got["b"], whole["b"])
