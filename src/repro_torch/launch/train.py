"""Training launcher of the port, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 8 --batch 8 --seq 256

  # small config on the CPU; --arch granite-moe-1b-a400m (MoE), --arch
  # mamba2-1.3b (SSM), --arch jamba-v0.1-52b (hybrid), --arch minicpm3-4b
  # (MLA) and --arch phi-3-vision-4.2b (on text) train the same way
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 3

  # checkpoints every 2 steps and at the last; --resume restarts after the
  # newest intact one; --trace writes a Chrome/Perfetto trace (and a .jsonl
  # beside it), --metrics prints the metrics registry
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 6 \
      --ckpt-dir build/run1 --ckpt-every 2 --resume --trace build/run1.json --metrics

  # data-parallel ranks (pod 2 x data 2 x model 1) under torchrun, the
  # gradients synced CLEX-staged with the cross-pod shard in int8
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2x1 \
      --hierarchical-sync --compress --device cpu --reduced --steps 3

  # pod 2 x data 1 x model 2: tensor- and expert-parallel over model
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x1x2 \
      --hierarchical-sync --compress --device cpu --reduced --steps 3

Random weights (seed 0), ``SyntheticLM`` batches (seed 0): tokens and
targets only, as the JAX launcher's, so an encoder-decoder
(``seamless-m4t-large-v2``), whose loss reads ``encoder_frames``, fails
here as it does there.  ``--mesh DxM`` or ``PxDxM`` runs the step on the
ranks ``torchrun`` starts (its environment names them; the mesh's size
must be the world's), each on the global batch's rows of its ``(pod,
data)`` index, the gradients synced flat, or CLEX-staged with
``--hierarchical-sync`` (a no-op without a pod axis, as in the reference),
the cross-pod shard in int8 with ``--compress`` (an MoE config takes the
flat sync, as in the reference).  On a ``model`` axis above 1 every rank
draws the whole params from the seed and keeps its blocks, and the ranks
of a ``model`` slice compute their rows tensor- and expert-parallel; MLA,
a frontend and an encoder-decoder refuse such an axis (ROADMAP A11d).  The
backend is NCCL when each rank on a host has a card of its own, and gloo
otherwise (the CPU, or ranks sharing a card); the first line says which.
Rank 0 prints, with the bytes a rank sent in the last step by group of
ranks, and writes the checkpoints (the blocks gathered into whole
leaves).  The JAX launcher's orchestrator flags wait for
the elastic runtime (ROADMAP A12).  It prints the reference's ``step N
loss ... gnorm ... lr ...`` lines (`` [straggler]`` after a step slower
than twice the running median), then the median step time (host clock,
each step ending in a device sync), tokens/s and the peak device memory.
``--ckpt-dir`` saves ``(params, optimizer state)`` at every step that
``--ckpt-every`` divides and at the last step; with ``--resume`` the run
starts after the newest intact checkpoint there.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import obs as obslib
from ..checkpoint.checkpointing import restore_checkpoint, save_checkpoint
from ..configs.base import ARCH_IDS, ParallelConfig, get_config
from ..device import resolve_device
from ..data.pipeline import SyntheticLM
from ..models import build_model
from ..obs import log
from ..optim.adamw import AdamWConfig
from ..runtime.fault_tolerance import StragglerMonitor
from ..runtime.trainer import Trainer
from ..tree import tree_leaves
from .mesh import parse_mesh_flag


def finish_obs(ob, trace_path: str, want_metrics: bool) -> None:
    """The launcher's epilogue, as the JAX package's: export the trace
    (Chrome/Perfetto JSON at the given path, lossless JSONL next to it) and
    dump the metrics registry + calibration summary to stdout."""
    if trace_path:
        chrome = ob.tracer.export_chrome(trace_path)
        jsonl = ob.tracer.export_jsonl(os.path.splitext(trace_path)[0] + ".jsonl")
        log.info(f"trace written: {chrome} (+ {jsonl})")
    if want_metrics:
        print(ob.registry.to_json())
        print(json.dumps({"calibration": ob.calibration.summary()}, indent=2))


def init_ranks(device) -> tuple[torch.device, str]:
    """Join the default process group of the ranks ``torchrun`` started (a
    group of one without ``torchrun``'s environment) and pick this rank's
    device.  Returns (device, what the backend choice rests on).  NCCL
    when each rank on the host has a card of its own; gloo for the CPU and
    for ranks sharing a card (NCCL refuses two ranks on one device)."""
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    rank, local_rank = int(env.get("RANK", "0")), int(env.get("LOCAL_RANK", "0"))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= cards else "gloo"
        why = (f"{local_world} ranks on {cards} card(s) of this host: "
               + ("one card each" if backend == "nccl" else "ranks share a card"))
    else:
        backend, why = "gloo", "ranks on the CPU"
    if "MASTER_ADDR" in env:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    else:  # a world of one: a free port on this host
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                world_size=1)
    return dev, why


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", type=str, default="",
                    help="DxM e.g. 4x1, or PxDxM e.g. 2x2x1 for a pod axis (ranks from torchrun)")
    ap.add_argument("--hierarchical-sync", action="store_true")
    ap.add_argument("--compress", action="store_true", help="int8 cross-pod grad sync")
    ap.add_argument("--ckpt-dir", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", type=str, default="",
                    help="write a Chrome/Perfetto trace_event JSON here (plus a .jsonl next to it)")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the metrics registry and calibration summary after the run")
    args = ap.parse_args(argv)

    # --trace/--metrics install an enabled observability bundle process-wide;
    # the default stays NULL_OBS
    ob = obslib.get_obs()
    if args.trace or args.metrics:
        ob = obslib.set_obs(obslib.Obs())

    device, mesh, say = args.device, None, print
    if args.mesh:
        device, why = init_ranks(args.device)
        mesh = parse_mesh_flag(args.mesh)
        if mesh.rank:
            say = lambda *a, **k: None  # noqa: E731 - rank 0 speaks for the ranks
        say(f"backend {mesh.backend} ({why}), mesh {mesh.axis_sizes()}, "
            f"{mesh.size} ranks, rank 0 on {device}")
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=device)
    if mesh is not None:
        model.check_mesh(mesh)  # what a model axis does not run yet raises here
    pcfg = ParallelConfig(hierarchical_grad_sync=args.hierarchical_sync,
                          compress_cross_pod=args.compress)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    trainer = Trainer(model, opt_cfg, pcfg, mesh=mesh, microbatches=args.microbatches)
    params, opt = trainer.init(torch.Generator(device=model.device).manual_seed(0))
    rows = (1, "err") if "err" in opt else None  # each rank's error-feedback row
    dims = trainer.checkpoint_dims()  # each rank's blocks on a model axis
    n_params = sum(t.numel() for t in tree_leaves(params))
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M {cfg.compute_dtype} on {model.device}")
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(model.device)

    start = 0
    if args.resume and args.ckpt_dir:
        try:  # the newest intact checkpoint, read once
            (params, opt), last = restore_checkpoint(args.ckpt_dir, (params, opt), mesh=mesh,
                                                    rows=rows, dims=dims)
            start = last + 1
            log.info(f"resumed from step {last}")
        except OSError:  # none there, or none intact: start afresh
            pass

    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    monitor = StragglerMonitor()
    walls = []
    for step in range(start, args.steps):
        if ob.enabled:
            ob.tracer.step = step
        batch = pipe.global_batch_arrays(step)
        monitor.step_start()
        if mesh is not None:
            mesh.sent.clear()
        t0 = time.perf_counter()
        with ob.span("train_step", "train"):
            params, opt, metrics = trainer.step(params, opt, batch)
            if on_card:
                torch.cuda.synchronize(model.device)
            straggler = monitor.step_end()
        walls.append(time.perf_counter() - t0)
        sent = dict(mesh.sent) if mesh is not None else {}
        if ob.enabled:
            ob.registry.histogram("train.step_ms").observe(1e3 * walls[-1])
            ob.registry.counter("train.straggler_steps").inc(int(straggler))
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e}"
                  f"{' [straggler]' if straggler else ''}")
        if args.ckpt_dir and (step % args.ckpt_every == 0 or step == args.steps - 1):
            with ob.span("ckpt", "train"):
                save_checkpoint(args.ckpt_dir, step, (params, opt), mesh=mesh, rows=rows,
                                dims=dims)
    if walls:  # none when a resumed run's checkpoint is its last step
        median = float(np.median(walls))
        peak = (f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.2f} GiB" if on_card
                else "not measured (cpu)")
        say(f"median step {1e3 * median:.1f} ms over {len(walls)} steps, "
              f"{args.batch * args.seq / median:.0f} tokens/s, peak device memory {peak}")
        if mesh is not None:
            say(f"bytes rank 0 sent in the last step, by group: {sent}")
    if mesh is None or mesh.rank == 0:
        finish_obs(ob, args.trace, args.metrics)
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
