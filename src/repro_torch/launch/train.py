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

One device, random weights (seed 0), ``SyntheticLM`` batches (seed 0):
tokens and targets only, as the JAX launcher's, so an encoder-decoder
(``seamless-m4t-large-v2``), whose loss reads ``encoder_frames``, fails
here as it does there.  The
JAX launcher's mesh, sync and orchestrator flags wait for the multi-device
work (ROADMAP A11, A12).  It prints the reference's ``step N loss ...
gnorm ... lr ...`` lines (`` [straggler]`` after a step slower than twice
the running median), then the median step time (host clock, each step
ending in a device sync), tokens/s and the peak device memory.
``--ckpt-dir`` saves ``(params, optimizer state)`` at every step that
``--ckpt-every`` divides and at the last step; with ``--resume`` the run
starts after the newest intact checkpoint there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import obs as obslib
from ..checkpoint.checkpointing import restore_checkpoint, save_checkpoint
from ..configs.base import ARCH_IDS, get_config
from ..data.pipeline import SyntheticLM
from ..models import build_model
from ..obs import log
from ..optim.adamw import AdamWConfig
from ..runtime.fault_tolerance import StragglerMonitor
from ..runtime.trainer import Trainer
from ..tree import tree_leaves


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
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

    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    trainer = Trainer(model, opt_cfg, microbatches=args.microbatches)
    params, opt = trainer.init(torch.Generator(device=model.device).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M {cfg.compute_dtype} on {model.device}")
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(model.device)

    start = 0
    if args.resume and args.ckpt_dir:
        try:  # the newest intact checkpoint, read once
            (params, opt), last = restore_checkpoint(args.ckpt_dir, (params, opt))
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
        t0 = time.perf_counter()
        with ob.span("train_step", "train"):
            params, opt, metrics = trainer.step(params, opt, batch)
            if on_card:
                torch.cuda.synchronize(model.device)
            straggler = monitor.step_end()
        walls.append(time.perf_counter() - t0)
        if ob.enabled:
            ob.registry.histogram("train.step_ms").observe(1e3 * walls[-1])
            ob.registry.counter("train.straggler_steps").inc(int(straggler))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e}"
                  f"{' [straggler]' if straggler else ''}")
        if args.ckpt_dir and (step % args.ckpt_every == 0 or step == args.steps - 1):
            with ob.span("ckpt", "train"):
                save_checkpoint(args.ckpt_dir, step, (params, opt))
    if walls:  # none when a resumed run's checkpoint is its last step
        median = float(np.median(walls))
        peak = (f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.2f} GiB" if on_card
                else "not measured (cpu)")
        print(f"median step {1e3 * median:.1f} ms over {len(walls)} steps, "
              f"{args.batch * args.seq / median:.0f} tokens/s, peak device memory {peak}")
    finish_obs(ob, args.trace, args.metrics)


if __name__ == "__main__":
    main()
