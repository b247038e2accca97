#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (run from the root
of a checkout: ``python3 chip_smoke.py``).  It imports only ``repro_torch``,
torch and numpy.  Phases, one line or more each; any failure exits non-zero:

1. card and build: the card's name and power limit, the kernel built from
   the sources in the checkout;
2. every kernel against its plain PyTorch version on the card, at the shapes
   of the kernel sweep, of the main path (internlm2-1.8b: every prefill
   group of 1, 2 or 4 rows at every bucket of 128 to 2048 tokens) and of
   h2o-danube-1.8b, and at a ragged length; phase 4 fails if it launched the
   kernel at a group shape this phase did not check;
3. kernel times at the main-path shapes beside the plain version, one
   library call (``scaled_dot_product_attention``, a yardstick the port never
   calls) and the least time the card could take (bound);
4. the main path at full width: internlm2-1.8b (all 24 layers, random
   weights from a seed, bf16) serving 8 ragged requests on 4 slots through
   ``ContinuousBatchingEngine`` and one 4 x 512 batch through the one-shot
   ``ServingEngine``; the launch counters are read around this phase only;
5. card against CPU: the same model cut to 2 layers in fp32, prefill and 8
   ragged decode steps on both; greedy tokens equal, logits within 1e-3;
6. a JSON line of the kernels, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where no CUDA card is visible.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import reference_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.serving import ContinuousBatchingEngine, ServingEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the peak of their type and its bytes over
# the memory rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; fp32 FMA
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FP32_LOGITS_BOUND = 1e-3  # card vs CPU: fp32 sums over d_ff = 8192 in other orders
MAIN_ROWS = (1, 2, 4)  # prefill group sizes on 4 slots
MAIN_BUCKETS = (128, 256, 512, 1024, 2048)  # power-of-two prompt buckets


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@dataclasses.dataclass(frozen=True)
class Shape:
    b: int
    s: int
    h: int
    kv: int
    d: int
    dtype: torch.dtype
    causal: bool = True
    window: int = 0

    def __str__(self):
        dt = "bf16" if self.dtype == torch.bfloat16 else "fp32"
        mask = ("causal" if self.causal else "full") + (f" w{self.window}" if self.window else "")
        return f"{dt} B{self.b} S{self.s} H{self.h} KV{self.kv} D{self.d} {mask}"

    def inputs(self, seed: int = 0):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        mk = lambda heads: torch.randn(self.b, self.s, heads, self.d, generator=gen,  # noqa: E731
                                       device="cuda").to(self.dtype)
        return mk(self.h), mk(self.kv), mk(self.kv)

    def attended_pairs(self) -> int:
        """(query, key) pairs the masks keep, per (batch, head)."""
        i = np.arange(self.s)
        lo = np.maximum(i - self.window + 1, 0) if self.window > 0 else np.zeros_like(i)
        hi = i + 1 if self.causal else np.full_like(i, self.s)
        return int((hi - lo).sum())

    def bound(self) -> tuple[float, str]:
        ops = 4.0 * self.b * self.h * self.d * self.attended_pairs()  # QK^T and PV
        nbytes = self.b * self.s * self.d * (2 * self.h + 2 * self.kv) * (
            2 if self.dtype == torch.bfloat16 else 4
        )
        t_ops, t_bytes = ops / PEAK_OPS[self.dtype], nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_card_and_build() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    built = fa_kernel.load()
    regs = sorted({line.split("Used ")[1].split(",")[0] for line in built.log.splitlines()
                   if "Used " in line})
    log(f"phase 1 card+build: {kind}, torch {torch.__version__} cuda {torch.version.cuda}; "
        f"flash_attention built by nvcc in {built.seconds:.1f} s "
        f"(wall {time.perf_counter() - t0:.1f} s; ptxas: {'; '.join(regs)})")
    return smi, kind


def main_shape(rows: int, bucket: int) -> Shape:
    """The kernel's shape in one internlm2-1.8b prefill group."""
    cfg = get_config("internlm2-1.8b")
    return Shape(rows, bucket, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16,
                 window=cfg.sliding_window)


def phase_check() -> tuple[float, set[Shape]]:
    """Kernel against plain version; returns the max error at the main-path
    (internlm2) shapes and the main-path shapes checked."""
    main = [main_shape(b, s) for b in MAIN_ROWS for s in MAIN_BUCKETS]
    other = [Shape(1, 8192, 32, 8, 80, torch.bfloat16, window=4096),
             Shape(1, 1000, 16, 8, 128, torch.bfloat16), Shape(2, 1000, 16, 8, 128, torch.float32)]
    main_err = 0.0
    for shape in [s for dt in (torch.float32, torch.bfloat16) for s in sweep_of(dt)] + main + other:
        q, k, v = shape.inputs()
        out = fa_ops.flash_attention(q, k, v, causal=shape.causal, window=shape.window)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, causal=shape.causal, window=shape.window)
        err = (out.float() - ref.float()).abs()
        tol = TOL[shape.dtype]
        ok = bool((err <= tol + tol * ref.float().abs()).all())
        log(f"phase 2 check {shape}: max_abs_err {err.max().item():.3e} "
            f"(tol {tol:g} abs + rel) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain version at {shape}")
        if shape in main:
            main_err = max(main_err, err.max().item())
        del q, k, v, out, ref, err
        torch.cuda.empty_cache()
    return main_err, set(main)


def sweep_of(dt):
    """The shapes of the JAX package's kernel sweep (tests/test_kernels.py)."""
    return [Shape(2, 256, 4, 2, 64, dt), Shape(1, 512, 8, 8, 32, dt),
            Shape(2, 256, 4, 1, 64, dt, window=64), Shape(1, 128, 2, 2, 128, dt, causal=False),
            Shape(1, 384, 6, 3, 64, dt, window=128)]


def library_call(q, k, v, shape: Shape):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if shape.window:
        i = torch.arange(shape.s, device="cuda")
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < shape.window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=shape.causal,
                                                  enable_gqa=True)


def phase_time() -> list[dict]:
    rows = []
    shapes = [main_shape(b, s) for b in MAIN_ROWS for s in MAIN_BUCKETS]
    shapes += [Shape(1, 8192, 32, 8, 80, torch.bfloat16, window=4096),
               Shape(2, 128, 16, 8, 128, torch.float32)]
    for shape in shapes:
        q, k, v = shape.inputs(seed=1)
        kern = lambda: fa_ops.flash_attention(q, k, v, causal=shape.causal,  # noqa: E731
                                              window=shape.window)
        plain = lambda: reference_attention(q, k, v, causal=shape.causal,  # noqa: E731
                                            window=shape.window)
        ms = cuda_ms(kern, iters=20)
        plain_ms = cuda_ms(plain, iters=3 if shape.s >= 4096 else 10, warmup=1)
        lib_ms = cuda_ms(library_call(q, k, v, shape), iters=20)
        bound_ms, bound_by = shape.bound()
        rows.append(dict(shape=str(shape), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"phase 3 time {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library (sdpa) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"kernel at {100 * bound_ms / ms:.1f}% of bound")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_serve(checked: set[Shape]) -> int:
    """The main path at full width; returns the flash launches it made.
    Fails if a prefill group ran the kernel at a shape phase 2 did not check."""
    cfg = get_config("internlm2-1.8b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.load(model.init(torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 4 init: {cfg.name} {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
        f"{cfg.compute_dtype} on {model.device} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    lens = rng.integers(100, 1001, 8)
    prompts = [rng.integers(1, cfg.vocab, (int(n),)).astype(np.int32) for n in lens]
    batch = rng.integers(1, cfg.vocab, (4, 512)).astype(np.int32)
    new_tokens = 32
    engine = ContinuousBatchingEngine(model, params, n_slots=4, max_len=1000 + new_tokens + 8)
    one_shot = ServingEngine(model, params, max_len=512 + new_tokens + 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa_kernel.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, new_tokens)
    cb_s = time.perf_counter() - t0
    cb_launches = fa_kernel.launches
    t0 = time.perf_counter()
    one = one_shot.generate(batch, new_tokens)
    one_s = time.perf_counter() - t0
    launches = fa_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    m = engine.metrics
    if cb_launches != cfg.n_layers * m.prefills or launches != cb_launches + cfg.n_layers:
        raise SystemExit(f"flash launches {cb_launches}/{launches} do not match "
                         f"{m.prefills} prefill groups x {cfg.n_layers} layers (+ one-shot)")
    for o in outs + list(one):
        if len(o) != new_tokens or o.min() < 0 or o.max() >= cfg.vocab:
            raise SystemExit(f"bad token stream {o}")
    engine.pool.check()
    served = {main_shape(g, b) for g, b, _ in m.prefill_walls} | {main_shape(*batch.shape)}
    if not served <= checked:
        raise SystemExit("the main path launched flash_attention at shapes phase 2 did not "
                         f"check: {', '.join(map(str, served - checked))}")
    logits, _ = model.prefill(params, torch.as_tensor(prompts[0][None]))
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("non-finite logits at full width")

    groups = ", ".join(f"{g}x{b}: {1e3 * s:.1f}" for g, b, s in m.prefill_walls)
    dec = np.array([s for _, s in m.decode_walls]) * 1e3
    toks = sum(len(o) for o in outs)
    log(f"phase 4 serve continuous: {len(prompts)} requests (prompts {lens.min()}-{lens.max()}),"
        f" {toks} tokens in {cb_s:.3f} s = {toks / cb_s:.1f} tok/s; "
        f"{m.prefills} prefill groups, {m.decode_steps} decode steps; "
        f"flash launches {cb_launches}")
    log(f"phase 4 prefill ms per group (rows x bucket: ms): {groups}")
    log(f"phase 4 decode ms per step: median {np.median(dec):.2f}, mean {dec.mean():.2f}, "
        f"min {dec.min():.2f}, max {dec.max():.2f} (host clock, ends in a sync)")
    log(f"phase 4 serve one-shot: 4 x 512 prompt, {one.size} tokens in {one_s:.3f} s = "
        f"{one.size / one_s:.1f} tok/s; max_memory_allocated {peak_gb:.2f} GiB")
    profile_decode(engine, prompts)
    return launches


def profile_decode(engine, prompts, steps: int = 12) -> None:
    """Device busy share of decode: 4 slots decoding, ``steps`` engine steps
    under torch.profiler (after the launch counts were read)."""
    for p in prompts[:4]:
        engine.submit(p[:128], steps + 2)
    engine.step()  # admission and the first decode step stay outside the window
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.run()
    # kernel entries only: an op's entry repeats the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        log("phase 4 decode profile: the profiler saw no device time (not measured)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    log(f"phase 4 decode profile: {steps} steps of 4 rows, wall {wall_ms / steps:.2f} ms/step, "
        f"device busy {busy_ms / steps:.2f} ms/step = {100 * busy_ms / wall_ms:.1f}% "
        f"(idle {100 - 100 * busy_ms / wall_ms:.1f}%); top device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms/step "
                    f"x{e.count // steps}" for e in top))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _greedy_run(model, params, toks, lens, capacity, steps):
    """Prefill right-padded prompts, then ``steps`` ragged greedy decode
    steps; returns (tokens [B, steps + 1], logits of every step)."""
    dev = model.device
    true_len = torch.as_tensor(lens, device=dev)
    logits, caches = model.prefill(params, torch.as_tensor(toks, device=dev),
                                   last_pos=true_len - 1)
    caches = model.prepare_decode_caches(model.mask_prompt_cache(caches, true_len), capacity)
    pos = true_len.clone()
    out_toks, out_logits = [logits[:, 0].argmax(-1)], [logits[:, 0].float().cpu()]
    for _ in range(steps):
        logits, caches = model.decode_step(params, caches, out_toks[-1][:, None], pos,
                                           ragged=True)
        out_toks.append(logits[:, 0].argmax(-1))
        out_logits.append(logits[:, 0].float().cpu())
        pos += 1
    return torch.stack([t.cpu() for t in out_toks], 1), torch.stack(out_logits, 1)


def phase_card_vs_cpu() -> None:
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2, compute_dtype="float32")
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    lens = np.array([100, 77])
    toks = rng.integers(1, cfg.vocab, (2, 128))
    toks[1, lens[1]:] = 0
    before = fa_kernel.launches
    t_gpu, l_gpu = _greedy_run(gpu_model, gpu_model.load(params), toks, lens, 144, 8)
    if fa_kernel.launches != before + cfg.n_layers:
        raise SystemExit("the card's prefill did not go through the kernel")
    t_cpu, l_cpu = _greedy_run(cpu_model, cpu_model.load(params), toks, lens, 144, 8)
    gap = (l_gpu - l_cpu).abs().max().item()
    same = torch.equal(t_gpu, t_cpu)
    log(f"phase 5 card vs cpu ({cfg.name} 2 layers fp32, prefill + 8 decode steps): "
        f"greedy tokens {'equal' if same else 'DIFFER'}, max logit gap {gap:.3e} "
        f"(bound {FP32_LOGITS_BOUND:g})")
    if not same or gap > FP32_LOGITS_BOUND:
        raise SystemExit("card and CPU disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi, kind = phase_card_and_build()
    main_err, checked = phase_check()
    rows = phase_time()
    launches = phase_serve(checked)
    phase_card_vs_cpu()
    rep = next(r for r in rows if r["shape"] == str(main_shape(4, 1024)))
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": str(fa_kernel.SOURCE.relative_to(Path(__file__).resolve().parent)),
        "replaces": fa_kernel.REPLACES,
        "launches": launches,
        "max_abs_err": main_err,
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "shape": rep["shape"],
    }]
    log("kernels: flash_attention (launched on the main path, held against its plain version)")
    log(f"card: {smi}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
