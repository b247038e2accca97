"""Training launcher of the port, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 8 --batch 8 --seq 256

  # small config on the CPU; --arch granite-moe-1b-a400m (MoE) and
  # --arch mamba2-1.3b (SSM) train the same way
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 3

One device, random weights (seed 0), ``SyntheticLM`` batches (seed 0).  The
JAX launcher's mesh, checkpoint and orchestrator flags wait for the
multi-device work and the checkpoints (ROADMAP A10, A11).  It prints the
reference's ``step N loss ... gnorm ... lr ...`` lines, then the median step
time (host clock, each step ending in a device sync), tokens/s and the peak
device memory.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config
from ..data.pipeline import SyntheticLM
from ..models import build_model
from ..optim.adamw import AdamWConfig
from ..runtime.trainer import Trainer
from ..tree import tree_leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

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

    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    walls = []
    for step in range(args.steps):
        batch = pipe.global_batch_arrays(step)
        t0 = time.perf_counter()
        params, opt, metrics = trainer.step(params, opt, batch)
        if on_card:
            torch.cuda.synchronize(model.device)
        walls.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e}")
    median = float(np.median(walls))
    peak = (f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.2f} GiB" if on_card
            else "not measured (cpu)")
    print(f"median step {1e3 * median:.1f} ms over {args.steps} steps, "
          f"{args.batch * args.seq / median:.0f} tokens/s, peak device memory {peak}")


if __name__ == "__main__":
    main()
