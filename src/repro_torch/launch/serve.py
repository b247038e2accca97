"""Serving launcher of the port: continuous batching (default) or the
one-shot baseline, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --requests 8 --slots 4

  # MoE: granite-moe-1b-a400m on the card, olmoe-1b-7b small on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --requests 8 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --reduced \
      --device cpu

  # MLA (minicpm3-4b) and the vision model (phi-3-vision-4.2b, served on
  # text); seamless-m4t-large-v2's engines refuse it, as the reference's do
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \
      --requests 8 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b \
      --device cpu --reduced

  # one-shot lockstep baseline, small config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --one-shot --batch 4 --prompt-len 32 --new-tokens 16

  # multi-turn sessions through the tiered KV pool: finished sessions
  # demote their cache rows to host (and spill to the modeled pooled
  # tier), and each later turn wakes them with no prefill; a trace with
  # prefill, decode and wakeup spans, and the metrics with serve.pool.*
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --tiered --turns 2 --requests 6 --slots 2 --host-sessions 2 \
      --pooled-sessions 2 --trace build/serve.json --metrics

Continuous mode submits a ragged closed-loop (or, with --open-rate,
Poisson open-loop) workload -- prompt lengths and token budgets jittered
around --prompt-len/--new-tokens as in the JAX launcher -- and reports
tokens/s and slot utilization.  With --tiered every request is a session;
--turns N resumes each session N - 1 more times (each resume carries the
whole history and asks for half of --new-tokens), and a ``tiers:`` line
reports the hierarchy's ledgers.  Weights are random, made from --seed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import obs as obslib
from ..configs.base import ARCH_IDS, get_config
from ..models import build_model
from ..runtime.serving import ContinuousBatchingEngine, ServingEngine, TierConfig
from .train import finish_obs


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
    ap.add_argument("--tiered", action="store_true",
                    help="tiered KV pool: demote finished sessions into the "
                         "HBM -> host -> pooled hierarchy")
    ap.add_argument("--host-sessions", type=int, default=64,
                    help="tiered: cache rows kept in host memory")
    ap.add_argument("--pooled-sessions", type=int, default=256,
                    help="tiered: rows spilled to the modeled pooled tier")
    ap.add_argument("--turns", type=int, default=1,
                    help="tiered: serve each session this many turns; turns after "
                         "the first resume the demoted session")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="drop requests not admitted within this many seconds of "
                         "arrival (0 = no deadlines)")
    ap.add_argument("--seed", type=int, default=0, help="weights and workload seed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", type=str, default="",
                    help="write a Chrome/Perfetto trace_event JSON here (plus a .jsonl next to it)")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the metrics registry and calibration summary after the run")
    args = ap.parse_args(argv)

    # --trace/--metrics install an enabled observability bundle process-wide
    # before the engine is built; otherwise the null bundle stays
    ob = obslib.get_obs()
    if args.trace or args.metrics:
        ob = obslib.set_obs(obslib.Obs())

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
        finish_obs(ob, args.trace, args.metrics)
        return

    tiers = None
    resume_budget = max(args.new_tokens // 2, 1)
    if args.tiered:
        tiers = TierConfig(host_sessions=args.host_sessions,
                           pooled_sessions=args.pooled_sessions)
    # later turns append to each session's history: capacity holds the
    # whole multi-turn transcript
    max_len = args.prompt_len + args.new_tokens + max(args.turns - 1, 0) * resume_budget + 8
    engine = ContinuousBatchingEngine(
        model, params, n_slots=args.slots, max_len=max_len, policy=args.policy,
        seed=args.seed, tiers=tiers,
    )
    prompts, budgets = ragged_workload(rng, args.requests, args.prompt_len, args.new_tokens,
                                       cfg.vocab)
    arrivals = None
    if args.open_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / args.open_rate, args.requests))
    t0 = time.perf_counter()
    base = time.monotonic()
    rids = []
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        arrival = None if arrivals is None else base + float(arrivals[i])
        rids.append(engine.submit(
            p, b, temperature=args.temperature, arrival_time=arrival,
            session_id=i if args.tiered else None,
            deadline=(None if args.deadline_s <= 0
                      else (base if arrival is None else arrival) + args.deadline_s),
        ))
    out = engine.run()
    toks = sum(len(out[r]) for r in rids if r in out)
    # multi-turn sessions: each extra turn resubmits every finished session's
    # history; resident rows page back in with no prefill, dropped ones
    # re-prefill cold
    if args.tiered and args.turns > 1:
        histories = {i: np.concatenate([prompts[i], out[r]])
                     for i, r in enumerate(rids) if r in out}
        for _ in range(args.turns - 1):
            turn = {i: engine.submit(h, resume_budget, temperature=args.temperature,
                                     session_id=i)
                    for i, h in histories.items()}
            turn_out = engine.run()
            for i, r in turn.items():
                histories[i] = np.concatenate([histories[i], turn_out[r]])
                toks += len(turn_out[r])
    dt = time.perf_counter() - t0
    m = engine.metrics
    print(f"served {len(rids)} ragged requests / {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s)")
    print(f"slots={engine.pool.n_slots} policy={args.policy} decode_steps={m.decode_steps} "
          f"prefills={m.prefills} slot_utilization={m.slot_utilization:.2f} "
          f"pool_evictions={engine.pool.n_evict}")
    if args.tiered:
        p = engine.pool
        print(f"tiers: resident_sessions={p.resident_sessions} (host={len(p.host)} "
              f"pooled={len(p.pooled)} dropped={len(p.dropped)}) demotions={p.n_demote} "
              f"wakeups={m.wakeups} cold_resumes={m.cold_resumes} spills={p.n_spill} "
              f"refills={p.n_refill} modeled_tier_s={p.modeled_tier_s:.4f}")
    for r in [r for r in rids if r in out][:4]:
        print(f"  {out[r].tolist()}")
    if ob.enabled:
        engine.absorb_pool_metrics()
    finish_obs(ob, args.trace, args.metrics)


if __name__ == "__main__":
    main()
