"""Serving launcher of the port: continuous batching (default) or the
one-shot baseline, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --requests 8 --slots 4

  # MoE: granite-moe-1b-a400m on the card, olmoe-1b-7b small on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --requests 8 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --reduced \
      --device cpu

  # one-shot lockstep baseline, small config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --one-shot --batch 4 --prompt-len 32 --new-tokens 16

Continuous mode submits a ragged closed-loop (or, with --open-rate,
Poisson open-loop) workload -- prompt lengths and token budgets jittered
around --prompt-len/--new-tokens as in the JAX launcher -- and reports
tokens/s and slot utilization.  Weights are random, made from --seed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config
from ..models import build_model
from ..runtime.serving import ContinuousBatchingEngine, ServingEngine


def ragged_workload(rng: np.random.Generator, n: int, prompt_len: int, new_tokens: int,
                    vocab: int):
    """Prompt lengths in [prompt_len // 2, prompt_len], budgets in
    [new_tokens // 4, new_tokens], tokens in [1, vocab)."""
    lens = rng.integers(max(prompt_len // 2, 1), prompt_len + 1, n)
    budgets = rng.integers(max(new_tokens // 4, 1), new_tokens + 1, n)
    prompts = [rng.integers(1, vocab, (int(l),)).astype(np.int32) for l in lens]
    return prompts, [int(b) for b in budgets]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--one-shot", action="store_true",
                    help="ServingEngine: one fixed batch, lockstep decode")
    ap.add_argument("--batch", type=int, default=4, help="one-shot batch size")
    ap.add_argument("--requests", type=int, default=16,
                    help="continuous mode: number of ragged requests")
    ap.add_argument("--slots", type=int, default=4, help="KV-pool decode slots")
    ap.add_argument("--policy", choices=["fcfs", "cost_aware"], default="cost_aware")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--open-rate", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = closed loop)")
    ap.add_argument("--seed", type=int, default=0, help="weights and workload seed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params = model.load(model.init(gen))  # one cast to the compute dtype
    rng = np.random.default_rng(args.seed)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.compute_dtype} "
          f"on {model.device}")

    if args.one_shot:
        engine = ServingEngine(model, params, max_len=args.prompt_len + args.new_tokens + 8)
        prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.new_tokens, temperature=args.temperature)
        dt = time.perf_counter() - t0
        toks = out.size
        print(f"generated {toks} tokens in {dt:.3f}s ({toks / dt:.1f} tok/s)")
        for row in out[: min(args.batch, 4)]:
            print(f"  {row.tolist()}")
        return

    engine = ContinuousBatchingEngine(
        model, params, n_slots=args.slots, max_len=args.prompt_len + args.new_tokens + 8,
        policy=args.policy, seed=args.seed,
    )
    prompts, budgets = ragged_workload(rng, args.requests, args.prompt_len, args.new_tokens,
                                       cfg.vocab)
    arrivals = None
    if args.open_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / args.open_rate, args.requests))
    t0 = time.perf_counter()
    base = time.monotonic()
    rids = [
        engine.submit(p, b, temperature=args.temperature,
                      arrival_time=None if arrivals is None else base + float(arrivals[i]))
        for i, (p, b) in enumerate(zip(prompts, budgets))
    ]
    out = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(out[r]) for r in rids if r in out)
    m = engine.metrics
    print(f"served {len(rids)} ragged requests / {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s)")
    print(f"slots={engine.pool.n_slots} policy={args.policy} decode_steps={m.decode_steps} "
          f"prefills={m.prefills} slot_utilization={m.slot_utilization:.2f} "
          f"pool_evictions={engine.pool.n_evict}")
    for r in [r for r in rids if r in out][:4]:
        print(f"  {out[r].tolist()}")


if __name__ == "__main__":
    main()
