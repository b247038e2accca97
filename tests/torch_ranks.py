"""One rank of the port's multi-rank CPU tests (gloo), run as a script:

  python tests/torch_ranks.py <case> <workdir> <rank> <world> [<mesh>]

The ranks join through ``file://<workdir>/init``, build a mesh (``<mesh>``
as the launchers' ``--mesh`` takes it, ``DxM`` or ``PxDxM``; by default pod
2 x data 2 x model 1), run every check of ``<case>`` on the inputs the
test wrote to ``<workdir>`` and save what they got to
``<workdir>/<case>.<rank>.pt`` for the test to compare with the JAX
package's results.  This file imports torch, numpy and ``repro_torch``
only: the ranks load no JAX.

Cases: ``collectives`` (each collective of ``core/collectives.py``),
``train`` (the flat, hierarchical and compressed train steps, and the
checkpoints of the compressed state with a mesh), ``serve`` (the runs
``serve.json`` lists on a mesh with a ``model`` axis: the engines' token
streams, a prefill's logits and single layers, from the JAX package's
params, which the bridge hands each rank as its block) and ``train_mesh``
(``train_mesh.json``'s train steps on a mesh with a ``model`` axis, each
step from the JAX package's params and optimizer state, the second step's
written by the test while the ranks run the first; the Valiant shuffle's
loss and gradients; the checkpoints of the ranks' blocks).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import from_jax_opt_state, from_jax_params, port_order
from repro_torch.checkpoint.checkpointing import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ParallelConfig, get_config
from repro_torch.core import collectives as col
from repro_torch.core.threefry import prng_key
from repro_torch.launch.mesh import make_mesh, parse_mesh_flag
from repro_torch.models import attention as attn_mod
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.serving import ContinuousBatchingEngine, ServingEngine
from repro_torch.runtime.trainer import Trainer, local_rows
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
    # what this trainer once refused: a model axis (the split dims known
    # when it is made, from the shapes alone) and an MoE config on a mesh
    # (flat sync)
    tp = Trainer(model, AdamWConfig(), mesh=dataclasses.replace(mesh, shape=(1, 2, 2)))
    out["model_axis_dims"] = tp.dims
    moe = get_config("granite-moe-1b-a400m", reduced=True)
    moe_model = _tiny(moe=moe.moe, family="moe")
    moe_trainer = Trainer(moe_model, AdamWConfig(lr=1e-3), modes["hier"], mesh=mesh)
    mp, mo = moe_trainer.init(torch.Generator().manual_seed(0))
    mesh.sent.clear()
    _, _, mm = moe_trainer.step(mp, mo, batches[0])
    out["moe"] = {"loss": float(mm["loss"]), "bytes": dict(mesh.sent),
                  "sums": [float(t.detach().double().sum()) for t in tree_leaves(mp)]}
    return out


def serve_cfg(arch: str, layers: int):
    """The serve case's configs: REDUCED, fp32 compute, cut to ``layers``."""
    return dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32",
                               n_layers=layers)


def case_serve(mesh, inputs: dict, workdir: str) -> dict:
    """Each run of ``serve.json`` on this rank's block of the JAX package's
    params (pickled numpy trees, ``params_<arch>.pkl``, handed across by
    ``from_jax_params(cfg, tree, mesh)``).  ``continuous``: the prompts
    through ``ContinuousBatchingEngine`` (3 slots, capacity 40), then the
    logits of a ``Model.prefill`` of the first two prompts right-padded to
    16; ``one_shot``: ``ServingEngine.generate`` of the prompts cut to the
    shortest; ``open_loop``: the prompts submitted with the run's arrival
    times and deadlines, run on a virtual clock that each rank skews by
    ``skew`` times its rank (``open_loop``); ``moe``, ``ssm`` and ``attn``:
    layer 0's FFN or mixer on the test's inputs (and, for ``moe``, the
    layer with the Valiant shuffle keyed by the reference's key 7)."""
    out = {}
    prompts = [inputs[f"prompt{i}"] for i in range(int(inputs["n_prompts"]))]
    for run in json.loads(Path(workdir, "serve.json").read_text()):
        arch, kind = run["arch"], run["kind"]
        cfg = serve_cfg(arch, run["layers"])
        model = build_model(cfg, device="cpu")
        with open(os.path.join(workdir, f"params_{arch}.pkl"), "rb") as f:
            block = from_jax_params(cfg, pickle.load(f), mesh=mesh)
        name = f"{kind} {arch}"
        if kind == "continuous":
            engine = ContinuousBatchingEngine(model, block, n_slots=3, max_len=40, mesh=mesh)
            out[name] = [o.tolist() for o in engine.generate(prompts, 6)]
            toks = np.zeros((2, 16), np.int64)
            for i, p in enumerate(prompts[:2]):
                toks[i, :len(p)] = p
            last = torch.as_tensor([len(p) - 1 for p in prompts[:2]])
            with torch.no_grad():
                logits, _ = model.prefill(engine.params, torch.as_tensor(toks), mesh=mesh,
                                          last_pos=last)
            out[f"logits {arch}"] = logits
        elif kind == "open_loop":
            engine = ContinuousBatchingEngine(model, block, n_slots=3, max_len=40, mesh=mesh)
            out[name] = open_loop(engine, prompts, run["arrivals"], run["deadlines"],
                                  run["skew"] * mesh.rank)
        elif kind == "one_shot":
            short = min(len(p) for p in prompts)
            batch = np.stack([p[:short] for p in prompts])
            out[name] = ServingEngine(model, block, max_len=40, mesh=mesh).generate(batch, 6)
        else:
            layer = model.load(block)["layers"][0]
            x = torch.from_numpy(inputs[run["input"]])
            with torch.no_grad():
                if kind == "moe":
                    mesh.sent.clear()
                    out[name + " " + run["input"]] = moe_mod.moe_apply(layer["ffn"], x, cfg,
                                                                        mesh=mesh)[0]
                    out[f"bytes {run['input']}"] = dict(mesh.sent)
                    vcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                        cfg.moe, valiant_shuffle=True))
                    out[f"valiant {run['input']}"] = moe_mod.moe_apply(
                        layer["ffn"], x, vcfg, key=prng_key(7), mesh=mesh)[0]
                elif kind == "ssm":
                    y, cache = ssm_mod.ssm_apply(layer["mixer"], x[:, :-1], cfg,
                                                 update_cache=True, mesh=mesh)
                    step, _ = ssm_mod.ssm_apply(layer["mixer"], x[:, -1:], cfg, cache=cache,
                                                mesh=mesh)
                    out[name] = torch.cat([y, step], dim=1)
                else:
                    b, s, _ = x.shape
                    pos = torch.arange(s).expand(b, s)
                    y, cache = attn_mod.attention_apply(layer["mixer"], x[:, :-1], cfg,
                                                        positions=pos[:, :-1],
                                                        update_cache=True, mesh=mesh)
                    ring = {k: torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
                            for k, v in cache.items()}
                    ring["pos"][:, -1] = -1
                    step, _ = attn_mod.attention_apply(layer["mixer"], x[:, -1:], cfg,
                                                       positions=pos[:, -1:], cache=ring,
                                                       ragged=True, mesh=mesh)
                    out[name] = torch.cat([y, step], dim=1)
                    out["kv heads"] = attn_mod.head_plan(cfg, mesh)
    return out


SYNCS = {"flat": ParallelConfig(hierarchical_grad_sync=False),
         "hier": ParallelConfig(hierarchical_grad_sync=True),
         "comp": ParallelConfig(compress_cross_pod=True)}


def train_cfg(arch: str, layers: int):
    """The train_mesh case's configs: REDUCED, fp32 compute, no remat, cut
    to ``layers``."""
    return dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32",
                               remat=False, n_layers=layers)


def valiant_cfg(cfg):
    """``cfg`` with the Valiant shuffle on and a tight capacity (0.5)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, valiant_shuffle=True,
                                                            capacity_factor=0.5))


def _wait_for(path: Path, timeout: float = 600.0):
    """The pickle at ``path``, once the test has written it."""
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written within {timeout} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def case_train_mesh(mesh, inputs: dict, workdir: str) -> dict:
    """For each sync of the spec (``train_mesh.json``: arch, layers, syncs,
    and the optional ``valiant`` and ``checkpoint`` runs): a step from the
    reference's initial params and state on batch 0, then a step from the
    reference's params and state after its own first step (``ref_<sync>.pkl``,
    which the test writes while the ranks run) on batch 1; of each, the
    metrics, the first moment and the rank's blocks, its leaves that are
    whole over ``model`` kept whole.  ``valiant``: the loss and gradient of
    the shuffled MoE config with the reference's key 7 and without a key,
    averaged over the data-parallel axes.  ``checkpoint``: the compressed
    state after step 1 written by the ranks, and a checkpoint the JAX
    package wrote restored on them."""
    work = Path(workdir)
    spec = json.loads((work / "train_mesh.json").read_text())
    cfg = train_cfg(spec["arch"], spec["layers"])
    model = build_model(cfg, device="cpu")
    with open(work / "params.pkl", "rb") as f:
        ref_params = pickle.load(f)
    batches = [{k: inputs[k][i] for k in ("tokens", "targets")} for i in range(2)]
    out = {}

    def blocks(tree):
        return port_order(cfg, from_jax_params(cfg, tree, mesh=mesh))

    for sync in spec["syncs"]:
        trainer = Trainer(model, AdamWConfig(lr=1e-3), SYNCS[sync], mesh=mesh)
        _, opt = trainer.init(torch.Generator().manual_seed(0))  # zero moments and err rows
        out["dims"] = trainer.dims
        params = tree_map(lambda t: t.requires_grad_(), blocks(ref_params))
        mesh.sent.clear()
        p1, o1, m1 = trainer.step(params, opt, batches[0])
        out[f"bytes {sync}"] = dict(mesh.sent)
        out[f"step1 {sync}"] = {"metrics": {k: float(v) for k, v in m1.items()},
                                "m": o1["m"], "v": o1["v"], "err": o1.get("err"),
                                "params": tree_map(lambda t: t.detach(), p1)}
        if spec.get("checkpoint") and sync == "comp":
            dims = trainer.checkpoint_dims()
            save_checkpoint(str(work / "ckpt"), 1, (p1, o1), mesh=mesh, rows=ROWS, dims=dims)
        ref = _wait_for(work / f"ref_{sync}.pkl")
        p1 = tree_map(lambda t: t.requires_grad_(), blocks(ref["params"]))
        o1 = from_jax_opt_state(cfg, ref["opt"], mesh=mesh)
        if spec.get("checkpoint") and sync == "comp":
            like = tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t,
                            (p1, o1))
            (bp, bo), step = restore_checkpoint(str(work / "jax_ckpt"), like, mesh=mesh,
                                                rows=ROWS, dims=dims)
            out["from jax ckpt"] = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                                       for a, b in zip(tree_leaves((bp, bo)),
                                                       tree_leaves((p1, o1))))
            out["from jax ckpt step"] = step
        p2, o2, m2 = trainer.step(p1, o1, batches[1])
        out[f"step2 {sync}"] = {"metrics": {k: float(v) for k, v in m2.items()},
                                "m": o2["m"], "params": tree_map(lambda t: t.detach(), p2),
                                "err": o2.get("err")}
    if spec.get("valiant"):
        vmodel = build_model(valiant_cfg(cfg), device="cpu")
        params = tree_map(lambda t: t.requires_grad_(), blocks(ref_params))
        dp = mesh.data_parallel_axes
        rows = local_rows({k: torch.as_tensor(v) for k, v in batches[0].items()}, mesh)
        for name, key in (("keyed", prng_key(7)), ("keyless", None)):
            loss, _ = vmodel.train_loss(params, rows, key=key, mesh=mesh)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            n = mesh.axis_size(dp)
            out[f"valiant {name}"] = {
                "loss": float(col.pmean(loss.detach(), dp, mesh=mesh)),
                "grads": [col.psum(g, dp, mesh=mesh) / n for g in grads]}
    return out


def open_loop(engine, prompts, arrivals, deadlines, skew: float) -> list:
    """[state, tokens] of each of ``prompts`` (6 new tokens each) submitted
    with ``arrivals`` and ``deadlines`` (None for closed loop or none) and
    run on a virtual clock of one unit an engine step, plus ``skew``."""
    rids = [engine.submit(p, 6, arrival_time=a, deadline=d)
            for p, a, d in zip(prompts, arrivals, deadlines)]
    got = engine.run(clock=lambda: engine.metrics.steps + skew)
    return [[engine.requests[r].state, [int(t) for t in got.get(r, [])]] for r in rids]


def spawn(case: str, workdir: Path, world: int = 4, timeout: float = 120.0,
          mesh: str | None = None, wait: bool = True):
    """Run ``case`` on ``world`` ranks (this file as a script, two threads
    each, on ``mesh`` where given) and return each rank's saved results.  A
    rank that fails or does not finish within ``timeout`` seconds fails the
    call, with every rank's stderr; no rank is left running.  With ``wait``
    False, return a function that waits and returns them, so that the
    caller can work while the ranks run."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "2"}
    logs = [open(workdir / f"{case}.{r}.log", "w") for r in range(world)]
    extra = [mesh] if mesh else []
    procs = [subprocess.Popen([sys.executable, __file__, case, str(workdir), str(r), str(world),
                               *extra], env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    collect = lambda: _collect(case, workdir, world, timeout, procs, logs)  # noqa: E731
    return collect() if wait else collect


def _collect(case, workdir, world, timeout, procs, logs) -> list[dict]:
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
    mesh = parse_mesh_flag(sys.argv[5]) if len(sys.argv) > 5 else make_mesh(*MESH)
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    cases = {"collectives": lambda: case_collectives(mesh, inputs),
             "train": lambda: case_train(mesh, inputs, workdir),
             "serve": lambda: case_serve(mesh, inputs, workdir),
             "train_mesh": lambda: case_train_mesh(mesh, inputs, workdir)}
    out = cases[case]()
    out["coords"] = mesh.coords
    out["group sets"] = sorted(mesh.groups)
    torch.save(out, os.path.join(workdir, f"{case}.{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
