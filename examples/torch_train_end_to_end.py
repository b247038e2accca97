"""End-to-end training example of the PyTorch/CUDA port: train a ~100M-parameter
qwen3-family model on the synthetic pipeline, with checkpoints and an
injected mid-run failure to show exact recovery; on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_train_end_to_end.py [--steps 300] [--device cpu]

The counterpart of ``examples/train_end_to_end.py``: checkpoints every 50
steps, a failure at ``--fail-at``, a restore of the newest checkpoint
through ``restore_checkpoint`` and a resume after it (the pipeline is a
function of the step, so the resumed run repeats the straight one), the
step time's running median from ``StragglerMonitor``.  ``main`` takes the
model's config as a parameter (a test passes a smaller one).  It imports no
JAX.
"""

import argparse
import dataclasses
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint.checkpointing import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.fault_tolerance import StragglerMonitor  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def default_config():
    """~100M params: the qwen3 family scaled down but wide enough to learn."""
    base = get_config("qwen3-32b", reduced=True)
    return dataclasses.replace(
        base, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_head=64, d_ff=2048,
        vocab=32768, compute_dtype="float32", remat=False,
    )


def main(argv=None, cfg=None, seq_len: int = 256, global_batch: int = 16) -> dict:
    """Runs the example; returns the final params and the logged losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-at", type=int, default=150, help="inject a failure at this step")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = cfg or default_config()
    model = build_model(cfg, device=args.device)
    trainer = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps))
    params, opt = trainer.init(torch.Generator(device=model.device).manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"model: qwen3-family {n / 1e6:.1f}M params, {cfg.n_layers}L d{cfg.d_model} "
          f"on {model.device}")

    ckpt_dir = tempfile.mkdtemp(prefix="clex_e2e_")
    step_fn = trainer.jitted_step(donate=False)
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch)
    monitor = StragglerMonitor()
    losses = {}

    def run(start, params, opt, crash_at=None):
        for step in range(start, args.steps):
            if crash_at is not None and step == crash_at:
                raise RuntimeError("injected node failure")
            monitor.step_start()
            params, opt, metrics = step_fn(params, opt, pipe.global_batch_arrays(step))
            loss = float(metrics["loss"])  # waits for the step
            monitor.step_end()
            if step % 25 == 0 or step == args.steps - 1:
                losses[step] = loss
                print(f"step {step:4d}  loss {loss:.4f}  "
                      f"({monitor.median * 1e3:.0f} ms/step median)", flush=True)
            if step % 50 == 0:
                save_checkpoint(ckpt_dir, step, (params, opt))
        return params, opt

    t0 = time.time()
    restarts = 0
    try:
        params, opt = run(0, params, opt, crash_at=args.fail_at)
    except RuntimeError as e:
        print(f"!! {e} — restoring from checkpoint and resuming")
        restarts = 1
        (params, opt), last = restore_checkpoint(ckpt_dir, (params, opt))
        params, opt = run(last + 1, params, opt, crash_at=None)
    print(f"finished {args.steps} steps in {time.time() - t0:.0f}s "
          f"({restarts} injected failure, exact skip-ahead resume)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"params": params, "losses": losses, "restarts": restarts}


if __name__ == "__main__":
    main()
