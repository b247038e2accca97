"""One rank of the port's multi-rank CPU tests (gloo), run as a script:

  python tests/torch_ranks.py <case> <workdir> <rank> <world>

The ranks join through ``file://<workdir>/init``, build a (pod 2, data 2,
model 1) mesh, run every check of ``<case>`` on the inputs the test wrote
to ``<workdir>`` and save what they got to ``<workdir>/<case>.<rank>.pt``
for the test to compare with the JAX package's results.  This file imports
torch, numpy and ``repro_torch`` only: the ranks load no JAX.

Cases: ``collectives`` (each collective of ``core/collectives.py``) and
``train`` (the flat, hierarchical and compressed train steps, and the
checkpoints of the compressed state with a mesh).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointing import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ParallelConfig, get_config
from repro_torch.core import collectives as col
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map

MESH = ((2, 2, 1), ("pod", "data", "model"))
ROWS = (1, "err")  # in (params, opt): each rank's error-feedback row


def case_collectives(mesh, inputs: dict) -> dict:
    """Each collective on this rank's block of the test's global inputs."""
    r = mesh.rank
    own = {k: torch.from_numpy(v[r]) for k, v in inputs.items()}
    out = {}
    mesh.sent.clear()
    red, _ = col.hierarchical_all_reduce({"g": own["g"], "h": [own["odd"]]}, mesh=mesh)
    out["hier_g"], out["hier_odd"] = red["g"], red["h"][0]
    out["bytes_hier"] = dict(mesh.sent)
    mesh.sent.clear()
    out["flat_g"] = col.pmean(own["g"], ("pod", "data"), mesh=mesh)
    out["bytes_flat"] = dict(mesh.sent)
    pad, _ = col.hierarchical_all_reduce({"g": own["seven"]}, average=False, mesh=mesh)
    out["pad"] = pad["g"]
    out["comp_total"], out["comp_err"] = col.compressed_psum(own["c"], "pod", mesh=mesh)
    # two steps of the compressed staged sync, the first step's residuals fed in
    res = tree_map(lambda e: e, col.error_feedback_slots({"g": own["g"]}, 2))
    for step in (0, 1):
        red, res = col.hierarchical_all_reduce({"g": own["g"] * (1 + step)}, compress_high=True,
                                               residuals=res, mesh=mesh)
        out[f"ef{step}_g"], out[f"ef{step}_err"] = red["g"], res["g"]
    out["a2a_flat"] = col.all_to_all(own["x"], ("pod", "data"), mesh=mesh)
    out["a2a_staged"] = col.two_stage_all_to_all(own["x"], "data", "pod", mesh=mesh)
    out["a2a_axis1"] = col.two_stage_all_to_all(own["x2"], "data", "pod", split_axis=1,
                                                concat_axis=1, mesh=mesh)
    return out


def _tiny(**changes):
    cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True),
                              compute_dtype="float32", remat=False, n_layers=2, **changes)
    return build_model(cfg, device="cpu")


def case_train(mesh, inputs: dict, workdir: str) -> dict:
    """Two steps of each sync mode from the test's bridged params, through
    ``jitted_step(donate=False)``, keeping each step's params, first moment
    (``(1 - b1)`` times the clipped synced gradient at the first step),
    metrics and, compressed, ``err`` rows; then the compressed state's
    checkpoints."""
    model = _tiny()
    params = tree_map(lambda t: t.requires_grad_(), torch.load(os.path.join(workdir,
                                                                           "params.pt")))
    batches = [{k: inputs[k][i] for k in ("tokens", "targets")} for i in range(2)]
    out = {}
    modes = {"flat": ParallelConfig(hierarchical_grad_sync=False),
             "hier": ParallelConfig(hierarchical_grad_sync=True),
             "comp": ParallelConfig(compress_cross_pod=True)}
    for name, pcfg in modes.items():
        trainer = Trainer(model, AdamWConfig(lr=1e-3), pcfg, mesh=mesh)
        _, opt = trainer.init(torch.Generator().manual_seed(0))
        before = [t.clone() if isinstance(t, torch.Tensor) else t
                  for t in tree_leaves((params, opt))]
        step = trainer.jitted_step(donate=False)
        mesh.sent.clear()
        p1, opt1, m1 = step(params, opt, batches[0])
        out[f"bytes_{name}"] = dict(mesh.sent)
        out[f"untouched_{name}"] = all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(before, tree_leaves((params, opt))))
        p2, opt2, m2 = step(p1, opt1, batches[1])
        for i, (p, o, m) in enumerate(((p1, opt1, m1), (p2, opt2, m2)), 1):
            suffix = name if i == 1 else f"{name}{i}"
            out[f"params_{suffix}"] = tree_map(lambda t: t.detach(), p)
            out[f"m_{suffix}"] = o["m"]
            out[f"metrics_{suffix}"] = {k: float(v) for k, v in m.items()}
        if name == "comp":
            out["err"], out["err2"] = opt1["err"], opt2["err"]
            save_checkpoint(os.path.join(workdir, "ckpt"), 1, (p1, opt1), mesh=mesh,
                            rows=ROWS)
            like = tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t,
                            (p1, opt1))
            (_, back), step = restore_checkpoint(os.path.join(workdir, "ckpt"), like, mesh=mesh,
                                                rows=ROWS)
            out["err_back"], out["restored_step"] = back["err"], step
            # a checkpoint the JAX package wrote, [dp_total, ...] rows
            (_, jax_opt), _ = restore_checkpoint(os.path.join(workdir, "jax_ckpt"), like,
                                                 mesh=mesh, rows=ROWS)
            out["err_from_jax"] = jax_opt["err"]
    for name, arg in (("model_axis", "mesh"), ("moe", "moe")):
        try:
            if arg == "moe":
                moe = get_config("granite-moe-1b-a400m", reduced=True)
                Trainer(_tiny(moe=moe.moe, family="moe"), AdamWConfig(), mesh=mesh)
            else:
                Trainer(model, AdamWConfig(), mesh=dataclasses.replace(
                    mesh, shape=(1, 2, 2)))
            out[f"raises_{name}"] = ""
        except NotImplementedError as e:
            out[f"raises_{name}"] = str(e)
    return out


def spawn(case: str, workdir: Path, world: int = 4, timeout: float = 120.0) -> list[dict]:
    """Run ``case`` on ``world`` ranks (this file as a script, two threads
    each) and return each rank's saved results.  A rank that fails or does
    not finish within ``timeout`` seconds fails the call, with every rank's
    stderr; no rank is left running."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "2"}
    logs = [open(workdir / f"{case}.{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, case, str(workdir), str(r), str(world)],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        text = "\n".join((workdir / f"{case}.{r}.log").read_text()[-3000:] for r in range(world))
        raise RuntimeError(f"ranks of {case!r} failed or timed out after {timeout} s "
                           f"(exit codes {codes}):\n{text}")
    return [torch.load(workdir / f"{case}.{r}.pt", weights_only=False) for r in range(world)]


def main() -> None:
    case, workdir, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/init", rank=rank,
                            world_size=world)
    mesh = make_mesh(*MESH)
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    out = case_collectives(mesh, inputs) if case == "collectives" else case_train(
        mesh, inputs, workdir)
    out["coords"] = mesh.coords
    out["group sets"] = sorted(mesh.groups)
    torch.save(out, os.path.join(workdir, f"{case}.{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
