"""Quickstart of the PyTorch/CUDA port: the CLEX simulator and a small
training run, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py``: the same simulator run
(C(1/3, 3) at m 16, L 3, 14 messages a node, dense, seed 0) and its
comparison with a torus, then 30 steps of REDUCED internlm2-1.8b through
``Trainer.jitted_step(donate=False)``.  It imports no JAX.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import CLEXTopology, derive_comparison, simulate_point_to_point  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402


def main(argv=None, steps: int = 30) -> list[float]:
    """Runs the example; returns the losses of the logged steps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # --- 1. The paper's contribution: CLEX routing vs a torus --------------
    topo = CLEXTopology(m=16, L=3)  # 4096 nodes, cliques of 16, 3 levels
    res = simulate_point_to_point(topo, msgs_per_node=14, mode="dense", seed=0,
                                  device=args.device)
    print(f"CLEX C(1/3,3) with {topo.n} nodes, dense traffic:")
    for row in res.table():
        print("  ", row)
    d = derive_comparison(res)
    print(
        f"vs 3D torus: bandwidth x{d.bandwidth_gain:.1f}, hop-delay x{d.hop_delay_reduction:.1f}, "
        f"propagation within {d.propagation_competitive_ratio:.2f}x of physical optimum\n"
    )

    # --- 2. The framework: train a small LM with the same codebase ---------
    cfg = get_config("internlm2-1.8b", reduced=True)
    model = build_model(cfg, device=args.device)
    trainer = Trainer(model, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    params, opt = trainer.init(torch.Generator(device=model.device).manual_seed(0))
    step = trainer.jitted_step(donate=False)
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=128, global_batch=8)
    losses = []
    for i in range(steps):
        params, opt, metrics = step(params, opt, pipe.global_batch_arrays(i))
        if i % 10 == 0 or i == steps - 1:
            losses.append(float(metrics["loss"]))
            print(f"step {i:3d}  loss {losses[-1]:.4f}")
    print("done — see examples/torch_train_end_to_end.py for the ~100M-parameter run")
    return losses


if __name__ == "__main__":
    main()
