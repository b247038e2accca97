"""The port's three examples at short settings on the CPU: the quickstart's
simulator lines equal the reference's (the JAX package's numpy engine on
the same run) and its training loss stays finite; the serving example
gives every request its budget through both engines; the end-to-end
example's restored run (a failure, then a restore of its last checkpoint)
ends with the params of a straight run, bit for bit."""

import dataclasses
import io
import math
import runpy
from contextlib import redirect_stdout
from pathlib import Path

import torch

from repro.core import CLEXTopology as JaxTopology
from repro.core import derive_comparison as jax_derive
from repro.core import simulate_point_to_point as jax_simulate
from repro_torch.configs.base import get_config
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    return runpy.run_path(str(EXAMPLES / f"torch_{name}.py"), run_name="example")["main"]


def test_quickstart_simulator_lines_equal_the_reference(capsys):
    losses = _example("quickstart")(["--device", "cpu"], steps=3)
    lines = capsys.readouterr().out.splitlines()
    topo = JaxTopology(m=16, L=3)
    res = jax_simulate(topo, msgs_per_node=14, mode="dense", seed=0)
    d = jax_derive(res)
    want = io.StringIO()
    with redirect_stdout(want):  # the reference example's print statements
        print(f"CLEX C(1/3,3) with {topo.n} nodes, dense traffic:")
        for row in res.table():
            print("  ", row)
        print(f"vs 3D torus: bandwidth x{d.bandwidth_gain:.1f}, "
              f"hop-delay x{d.hop_delay_reduction:.1f}, "
              f"propagation within {d.propagation_competitive_ratio:.2f}x of physical optimum\n")
    want = want.getvalue().splitlines()
    assert lines[:len(want)] == want
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == ["0", "2"]


def test_serve_batched_gives_every_request_its_budget(capsys):
    out = _example("serve_batched")(["--device", "cpu"], n_req=4, slots=2, prompt_len=16,
                                    new_tokens=8)
    vocab = get_config("olmoe-1b-7b", reduced=True).vocab
    assert [len(o) for o in out["outputs"]] == out["budgets"]
    assert all(0 <= int(t) < vocab for o in out["outputs"] for t in o)
    assert 0 < out["slot_utilization"] <= 1
    text = capsys.readouterr().out
    assert "one-shot batches:" in text and "slot utilization" in text


def test_train_end_to_end_restores_to_the_straight_run(capsys):
    cfg = dataclasses.replace(get_config("qwen3-32b", reduced=True), n_layers=2,
                              compute_dtype="float32", remat=False)
    main = _example("train_end_to_end")
    kw = dict(cfg=cfg, seq_len=32, global_batch=4)
    straight = main(["--steps", "5", "--fail-at", "99", "--device", "cpu"], **kw)
    restored = main(["--steps", "5", "--fail-at", "3", "--device", "cpu"], **kw)
    assert (straight["restarts"], restored["restarts"]) == (0, 1)
    assert "!! injected node failure" in capsys.readouterr().out
    assert straight["losses"] == restored["losses"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(straight["params"]),
                                                 tree_leaves(restored["params"])))
