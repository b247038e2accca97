"""Serving example of the PyTorch/CUDA port: an MoE model (OLMoE family,
REDUCED) under both engines, the one-shot lockstep batch and the
continuous-batching scheduler, on the same ragged workload, reporting
throughput and slot utilization; on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The counterpart of ``examples/serve_batched.py``.  It imports no JAX.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.serving import ContinuousBatchingEngine, ServingEngine  # noqa: E402


def main(argv=None, n_req: int = 8, slots: int = 4, prompt_len: int = 64,
         new_tokens: int = 32) -> dict:
    """Runs the example; returns the continuous engine's outputs and metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("olmoe-1b-7b", reduced=True)
    model = build_model(cfg, device=args.device)
    params = model.load(model.init(torch.Generator(device=model.device).manual_seed(0)))
    sync = (lambda: torch.cuda.synchronize(model.device)) if model.device.type == "cuda" else (
        lambda: None)

    rng = np.random.default_rng(0)
    lens = rng.integers(prompt_len // 2, prompt_len + 1, n_req)
    budgets = rng.integers(new_tokens // 4, new_tokens + 1, n_req)
    prompts = [rng.integers(1, cfg.vocab, (int(n),)).astype(np.int32) for n in lens]
    useful = int(sum(budgets))

    # ---- one-shot baseline: fixed batches, padded prompts, max budget each batch
    engine = ServingEngine(model, params, max_len=prompt_len + new_tokens + 8)
    width = max(int(n) for n in lens)
    t0 = time.perf_counter()
    for i in range(0, n_req, slots):
        batch = prompts[i: i + slots]
        padded = np.zeros((len(batch), width), np.int32)
        for r, p in enumerate(batch):
            padded[r, width - p.shape[0]:] = p
        engine.generate(padded, int(max(budgets[i: i + slots])))
    sync()
    t_oneshot = time.perf_counter() - t0

    # ---- continuous batching: pooled KV slots, per-request completion
    cont = ContinuousBatchingEngine(model, params, n_slots=slots,
                                    max_len=prompt_len + new_tokens + 8)
    t0 = time.perf_counter()
    out = cont.generate(prompts, [int(b) for b in budgets])
    sync()
    t_cont = time.perf_counter() - t0

    print(f"arch={cfg.name} (MoE {cfg.moe.n_experts}e top-{cfg.moe.top_k}) "
          f"{n_req} ragged requests, {slots} slots, {useful} useful tokens, on {model.device}")
    print(f"one-shot batches: {t_oneshot:.2f}s = {useful / t_oneshot:.0f} tok/s (incl. first "
          f"calls)")
    print(f"continuous:       {t_cont:.2f}s = {useful / t_cont:.0f} tok/s (incl. first calls), "
          f"slot utilization {cont.metrics.slot_utilization:.2f}")
    print("sample:", out[0][:16].tolist())
    return {"outputs": out, "budgets": [int(b) for b in budgets],
            "slot_utilization": cont.metrics.slot_utilization}


if __name__ == "__main__":
    main()
