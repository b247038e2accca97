#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (run from the root
of a checkout: ``python3 chip_smoke.py``).  It imports only ``repro_torch``,
torch and numpy.  Phases, one line or more each; any failure exits non-zero:

1. card and build: the card's name and power limit, the three kernel
   libraries (flash attention's and the SSD scan's each with its backward)
   built from the sources in the checkout (one nvcc each, started
   together), with ptxas's registers and spills by kernel, any compiler
   warning and any note that it serialised wgmma instructions;
2. every kernel against its plain PyTorch version on the card.  Flash
   attention at the shapes of the kernel sweep, of both attention paths (every
   prefill group of 1, 2 or 4 rows at every bucket of 128 to 2048 tokens:
   internlm2-1.8b at head_dim 128, granite-moe-1b-a400m at head_dim 64) and
   of h2o-danube-1.8b, of jamba-v0.1-52b (32 heads over 8 KV heads of 128,
   no RoPE: one prompt at each of its exact lengths, and the 4 x 512
   batch), at a ragged length, and at the edges of the bf16
   kernel's tiles (S of 1, 127, 129 and 1025, windows below one tile, GQA
   groups of 1 to 8, every head dim, q/k/v as views of a fused buffer), and
   at the train shapes of internlm2-1.8b, granite-moe-1b-a400m and
   jamba-v0.1-52b (B 8 x S 256; fp32 B 2 x S 128), and at internlm2's
   prefill groups in fp32 (phase 8's cold resumes), and at phase 9's shapes:
   phi-3-vision-4.2b (32 heads over 32 KV heads of 96) in every prefill
   group, its frontend prefill (B 2 x S 832) and its train shapes, and
   seamless-m4t-large-v2's decoder (16 over 16 of 64) in its prefill (B 4
   x S 64) and its train shapes.  The
   grouped matmul, its forward and both backward products (dx = g w^T and
   dw = x^T g, the transposed operand read in place), at the shapes of the
   JAX package's sweep, at ragged capacities around its tiles (1 to 2560),
   on strided views, at every granite expert shape of the served runs
   (gate/up and down at each capacity C; forward) and of the train runs (C
   640 in bf16, C 80 in fp32; all three), in fp32 and bf16, at every
   jamba expert shape of the served runs in bf16 (16 experts, D 4096, F
   14336: decode C 2, C 17 to 135 for the prompts alone, C 320 for the
   batch; 1.88 GB of weights a product) and at jamba's train shapes (C 320
   in bf16, and C 160 of the card-vs-CPU run's 4 experts in fp32; all
   three).  The SSD scan at the shapes of the JAX
   package's sweep, at ragged S, at the edges of the bf16 kernel's tiles (S
   of 1 to 1000 around 64 and 128, P of 8 to 64, N of 16 to 128, a batch of
   4, and a bf16 shape of its FMA route) and at every mamba2-1.3b and
   jamba-v0.1-52b (128 heads of 64, state 16; bf16) shape of the served
   runs (one prompt at each of its exact lengths, and the 4 x 512 batch),
   and at mamba2's and jamba's two train shapes, in fp32 and bf16, with the
   errors of y and of the final state apart; at the served bf16 shapes the
   state must also be within 1e-4 of the plain version relative to its
   largest value.  The SSD backward (dx, ddt, da, db, dc) against autograd
   through the plain ``ssd_chunked``, each gradient within 5e-4 (fp32) or
   2e-2 (bf16) of its largest value, on the route ``bwd_route`` names (the
   tensor cores for bf16 with P <= 64 and P, N multiples of 8; the FMA
   units otherwise): at mamba2's and jamba's train shapes (bf16 B 8 x S
   256, fp32 B 2 x S 128), at a ragged S with the final state's cotangent, with rows of dt
   = 0, tiny and negative, at the JAX package's gradient-test shape, at the
   edges of the wgmma route's tiles and at a bf16 shape of the FMA route.
   Phases 4 and 6 fail if they launched a kernel at a shape this phase did
   not check;
3. kernel times at the main-path shapes beside the plain version, one
   library call the port never calls (``scaled_dot_product_attention``,
   ``torch.bmm``, on the same transposed views for the backward products;
   no single PyTorch call computes the SSD scan), the kernel-to-library
   ratio and the least time the card could take (bound); the grouped
   matmul's dx and dw at granite's and jamba's train shapes; jamba's flash
   attention at its longest prompt and the 4 x 512 batch, phi-3-vision's
   at its frontend prefill and the 4 x 512 batch and seamless's at its
   prefill, grouped matmul at
   decode (C 2) and at the batch (C 320), and SSD scan at its longest
   prompt and its train shape; the SSD scan at all nine served mamba2
   shapes; the SSD backward at mamba2's and jamba's train shapes on the
   wgmma route, beside the FMA route on the same inputs (timed in turns),
   the plain backward (autograd through ``ssd_chunked``) and its bound at
   the peak of the inputs' type, and each route's device time by kernel;
4. the three main paths at full width (random weights from a seed, bf16),
   each serving 8 ragged requests on 4 slots through
   ``ContinuousBatchingEngine`` and one 4 x 512 batch through the one-shot
   ``ServingEngine``, each at half its depth (``EARLIER_LAYERS``):
   internlm2-1.8b (dense, 12 of 24 layers), granite-moe-1b-a400m
   (MoE, 12 of 24 layers, expert FFNs through the grouped matmul), then
   mamba2-1.3b (24 of 48 SSM layers, each prefill through the SSD scan, every
   prompt prefilled alone at its exact length), then jamba-v0.1-52b cut to
   one pattern period of 8 layers (7 Mamba-2 layers, one attention layer,
   4 MoE FFNs of 16 experts top-2, 13.27 B parameters; all three kernels,
   every prompt alone at its exact length; its weights built a layer at a
   time on the card).  Each model's weights come from seed 0, as
   ``Model.init`` makes them.  The launch counters are
   set to 0 just before each path and read just after it, and must match
   the path's layers, prefills and decode steps.  Then jamba's bf16
   prefill of one 866-token prompt through the kernels against the same
   weights with every kernel wrapper replaced by its plain version, within
   the whole-model bf16 bound; then mamba2-1.3b's bf16
   prefill of one 866-token prompt at full width, cut to 4 layers, through
   the SSD kernel against the same model with the plain ``ssd_chunked`` in
   every layer, within the port's whole-model bf16 bound (5e-2 + 2e-2
   relative); and the wall and device busy time of that prefill at 24
   layers, with the SSD kernel's part; each path's decode profiled over 6
   engine steps;
5. card against CPU: each model cut to 2 layers in fp32 (jamba: layer 0
   Mamba-2 with a dense FFN, layer 1 attention with MoE, 3.675 B
   parameters), prefill and 8 ragged decode steps on both; greedy tokens
   equal, logits within 1e-3;
6. the train path: flash attention's backward kernel (dq, dk and dv from
   the forward kernel's o and logsumexp rows) against the plain
   ``attention_backward`` and against autograd through the plain
   ``reference_attention`` on the card, and the forward kernel's logsumexp
   rows against the plain ``attention_forward``'s: at the train shapes of
   internlm2-1.8b (D 128), granite-moe-1b-a400m (D 64), jamba-v0.1-52b
   (H 32 over KV 8, D 128, no RoPE), phi-3-vision-4.2b (H 32 over KV 32,
   D 96) and seamless-m4t-large-v2's decoder (H 16 over KV 16, D 64), a
   windowed
   shape, qwen3-32b's group of 8 query heads per kv head, a ragged S, a
   non-causal shape, every head dim, fused-qkv views, and in fp32 at the
   card-vs-CPU train shapes; the grouped matmul's and the expert FFN's
   gradients (every product through the kernel, the transposed operands
   read in place) against autograd through the plain versions, in bf16 and
   fp32; at the five train shapes flash's forward (without and with its
   logsumexp rows) beside SDPA's, and its backward kernel beside
   ``attention_backward``, the old recompute (autograd through
   ``reference_attention``) and SDPA's backward, each with its bound; then
   internlm2-1.8b, granite-moe-1b-a400m and mamba2-1.3b at full width and
   phase 4's depth, and
   jamba-v0.1-52b at full width cut to 2 layers (layer 0 Mamba-2 with a
   dense FFN, layer 1 attention with MoE: 3.675 B parameters; the whole
   8-layer period would need about 212 GB at 16 bytes a parameter), bf16
   compute, fp32 master weights, random weights from seed 0, each trained
   8 steps through ``Trainer`` on
   ``SyntheticLM`` batches (B 8, S 256, seed 0): flash attention launched
   twice per attention layer and step (forward and remat recompute) and its
   backward once, the grouped matmul 12 times per MoE layer and step (3
   forward, 3 recompute, 3 dx and 3 dw), the SSD scan twice per SSM layer
   and step and its backward once (on the wgmma route in bf16), a finite
   loss that falls, the MoE load-balancing loss, a finite non-zero
   gradient for every parameter, two gradient passes of one batch that are
   bit-identical, step wall,
   tokens/s, peak memory and one profiled step; then each model cut to 2
   layers in fp32 (jamba's with 4 of its 16 experts, every width kept: the
   host holds both runs' state) trained 2 steps on the card and on the
   CPU, gradients within 1e-4 of each leaf's largest value, losses within
   1e-4 relative and params within 1e-4;
7. checkpoints and restarts: granite-moe-1b-a400m cut to 2 layers at full
   width trained 6 steps straight, then 6 steps through
   ``run_with_restarts`` with a checkpoint every 2 steps and one failure
   injected after step 3's update; params, moments, step and losses
   bit-identical to the straight run; an ``AsyncCheckpointer`` save of the
   final state passes ``verify_checkpoint``; the bytes and seconds of a
   save and a restore (the directory, under ``build/``, is removed);
8. multi-turn sessions through the tiered KV pool, on phase 4's weights
   right after their path (internlm2-1.8b's 12 layers and jamba-v0.1-52b's
   period): the
   same 8 prompts, greedy, as sessions of two turns of 16 tokens (the
   second turn resubmits each history), each run held bit for bit against
   a never-demoted run of the prompts for 32 tokens on as many slots.
   internlm2 on 4 slots in bf16 with 4 host and 4 pooled sessions (turn 2
   wakes 4 rows from host and refills 4 from pooled, no prefill), then in
   fp32 (its weights built again from seed 0) with no tier capacity
   (every session dropped and re-prefilled cold through the fp32 flash
   route: 8 rows); jamba's period on 1 slot, so that no two rows share an
   expert's capacity, with 4 host and 4 pooled sessions in bf16 (its
   Mamba-2 conv and SSM state and its attention ring through the
   hierarchy).  ``pool.check()`` after each turn; the launches equal the
   engines' prefills and decode steps (none per wakeup), at shapes phase 2
   checked; the spans (``Obs()`` on every tiered run) match the engine's
   counters.  Printed: each model's row bytes by leaf, demote and promote
   walls per row and their GB/s from the calibration ledger beside the
   modeled prices, ``extract_all`` of 4 rows against 4 ``extract`` calls
   (and ``insert_all`` against ``insert``), each with the card's name and
   power limit;
9. the MLA, vision-frontend and encoder-decoder families at full width, bf16, random
   weights from seed 0: minicpm3-4b (62 layers of multi-head latent
   attention, 4.26 B parameters) served as phase 4 serves (its path
   launches no kernel: the reference runs MLA outside its kernels) and
   through phase 8's two-turn sessions (4 host, 4 pooled, bit-identical to
   a never-demoted run; its row bytes); phi-3-vision-4.2b (32 layers) served
   on text as phase 4 serves (flash 32 times per prefill group), then
   ``Model.prefill`` on 2 rows of 576 patch rows of width 1024 and 256
   text tokens and 32 greedy ``decode_step``s; seamless-m4t-large-v2 (24
   encoder and 24 decoder layers), whose engines refuse it with the
   reference's messages, through ``Model.prefill`` on 4 rows of 512
   encoder frames of width 160 and a 64-token prompt (flash 24 times,
   the decoder's self-attention) and 32 greedy decode steps; both
   prefills through the kernel against the plain version on the same
   weights (logits within phase 4's bound; on every row the plain logit
   at the kernel's greedy token within twice the row's gap of the plain
   maximum, and the tokens equal where the plain top-2 margin exceeds
   twice the gap); each model cut to 2
   layers (seamless 2 + 2) in fp32 on the card against the CPU, 16 greedy
   steps, and one gradient pass held to phase 6's rule (each leaf within
   1e-4 of its largest value); and each trained 8 steps as phase
   6 trains (minicpm3 and phi-3-vision cut to 8 layers, seamless whole;
   phi-3-vision's batches carry 128 frontend rows, seamless's 256 encoder
   frames), with the launches, peak memory and a step profile;
10. the CLEX topology simulator (``repro_torch.core``), which launches none
   of the three kernels (the counters are read around it): its hash RNG on
   2^20 indices with salts whose top bit is set, card against CPU bit for
   bit; the JAX package's eight frozen tables (``tests/test_golden_tables.py``)
   reproduced on the card by the golden and the streaming engine; at m 16,
   L 3 (4096 nodes, 14 messages a node) both engines dense and light, with
   1 % node faults and with Valiant routing at level 2, and the streaming
   engine at chunk 2^10 against 2^20, every field equal on the card and on
   the CPU, as are a ``scenario_matrix`` row per scenario, the k 16 torus
   and the streaming all-to-all on m 8, L 3 (clean and faulted); then the
   paper's experiment, C(1/4, 4) (m 32, L 4, 2^20 nodes) with 28 messages a
   node, dense, seed 1, chunk 2^21, on the streaming engine, and the 102^3
   torus at 4 a node, held exactly to ``BENCH_sim.json``'s rows, torus
   fields and factors (copied here) and printed beside the paper's Table
   I, with the walls, messages a second, peak device memory and a
   profiled run's device busy time and top kernels;
11. the walls by phase and path, a JSON line of the kernels (the flash and SSD
   backwards beside the three forward kernels; the SSD backward's launches
   by route and its FMA route's time beside; launches by path, the train
   paths, the checkpoint phase, the session paths and phase 9's paths
   among them, and the simulator's, all 0), and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where no CUDA card is visible.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import math
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint.checkpointing import (  # noqa: E402
    AsyncCheckpointer, verify_checkpoint)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_backward, attention_forward, reference_attention)
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    reference_expert_ffn, reference_grouped_matmul)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import dense_init, embed_init, zeros_init  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.runtime.fault_tolerance import run_with_restarts  # noqa: E402
from repro_torch.configs.clex_paper import (  # noqa: E402
    PAPER_DERIVED, PAPER_TABLES, PAPER_TOPOLOGIES, PAPER_TRAFFIC)
from repro_torch.core import (  # noqa: E402
    CLEXTopology, FaultSet, StreamingEngine, TorusTopology, derive_comparison, scenario_matrix,
    simulate_all_to_all_streaming, simulate_point_to_point, simulate_point_to_point_streaming,
    simulate_torus_dor_streaming)
from repro_torch.core.hashrng import (  # noqa: E402
    hash_randint, hash_u01, mix64, pseudo_permutation, salt_for)
from repro_torch.core.scenarios import asymmetric_bandwidth  # noqa: E402
from repro_torch.obs import Obs, get_obs, set_obs  # noqa: E402
from repro_torch.runtime.serving import (  # noqa: E402
    ContinuousBatchingEngine, KVPool, ServingEngine, TierConfig)
from repro_torch.runtime.trainer import Trainer, value_and_grads  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the peak of their type and its bytes over
# the memory rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; fp32 FMA
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
GMM_TOL = {dt: 5 * t for dt, t in TOL.items()}  # as the JAX package's gmm sweep
SSD_TOL = {dt: 20 * t for dt, t in TOL.items()}  # as the JAX package's SSD sweep
# the bf16 SSD kernel's final state against the fp32 plain version, relative
# to its largest value: two bf16 terms per fp32 factor give a few 1e-6, one
# term about 2e-3 (tests/test_torch_ssd_scan.py emulates both)
SSD_STATE_REL = 1e-4
# whole-model bf16 logits (tests/test_torch_model.py's bound)
BF16_LOGITS_ATOL, BF16_LOGITS_RTOL = 5e-2, 2e-2
# card vs CPU: fp32 sums over d_ff = 8192 (internlm2), over 8 experts of
# 512 (granite) or over the SSD scan's chunks (mamba2) in other orders
FP32_LOGITS_BOUND = 1e-3
DENSE, MOE, SSM = "internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-1.3b"
ARCHS = (DENSE, MOE, SSM)
# phase 9: the MLA, vision-frontend and encoder-decoder families
MLA, VLM, ENCDEC = "minicpm3-4b", "phi-3-vision-4.2b", "seamless-m4t-large-v2"
FAMILIES = (MLA, VLM, ENCDEC)
# phase 9's training cuts: minicpm3 (4.26 B parameters) and phi-3-vision
# (3.82 B) need 68 and 61 GB of fp32 params and AdamW moments at full
# depth, before activations; seamless (2.04 B, 33 GB) trains whole
FAMILY_TRAIN_LAYERS = {MLA: 8, VLM: 8, ENCDEC: None}
# phi-3-vision's frontend prefill: 576 patch rows of width 1024, then 256
# text tokens (S 832), 2 rows; seamless's: 512 encoder frames of width 160
# and a 64-token decoder prompt, 4 rows; then greedy decode steps
VLM_PATCHES, VLM_TEXT, VLM_ROWS = 576, 256, 2
ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_ROWS = 512, 64, 4
FAMILY_DECODE_STEPS = 32
# the hybrid, served at full width cut to one pattern period of its 32
# layers: 13.27 B parameters, 26.5 GB in bf16 (the whole model does not fit
# one card)
HYBRID = "jamba-v0.1-52b"
HYBRID_LAYERS = 8
# phases 4, 6 and 8 run the three one-family models at half their depth,
# every width kept (internlm2-1.8b and granite-moe-1b-a400m 12 of 24
# layers, mamba2-1.3b 24 of 48), so that the whole script stays near 11
# minutes beside phase 9
EARLIER_LAYERS = {DENSE: 12, MOE: 12, SSM: 24}
KERNELS = {"flash_attention": fa_kernel, "moe_gmm": gmm_kernel, "ssd_scan": ssd_kernel}
# launch counters by kernel: each backward is a kernel of its forward's
# library with a counter of its own
COUNTERS = {"flash_attention": (fa_kernel, "launches"),
            "flash_attention_bwd": (fa_kernel, "bwd_launches"),
            "moe_gmm": (gmm_kernel, "launches"),
            "ssd_scan": (ssd_kernel, "launches"), "ssd_scan_bwd": (ssd_kernel, "bwd_launches"),
            "ssd_scan_bwd_wgmma": (ssd_kernel, "bwd_wgmma_launches")}
MAIN_ROWS = (1, 2, 4)  # prefill group sizes on 4 slots
MAIN_BUCKETS = (128, 256, 512, 1024, 2048)  # power-of-two prompt buckets
N_SLOTS, NEW_TOKENS = 4, 32
# phase 8: two turns of 16 tokens a session, on pools of phase 4's capacity
SESSION_TURN, SESSION_CAPACITY = NEW_TOKENS // 2, 1000 + NEW_TOKENS + 8
PROFILE_PROMPT = 128  # the decode profile's prompts (phase 4), cut to this many tokens
L2_BYTES = 50e6  # inputs of a timed call rotate through copies of at least 2.5x this
# training: the launcher's batch, length and warmup rule, 8 steps.  Its
# default lr of 3e-3 (the JAX launcher's, sized for REDUCED configs) makes
# the full-width loss rise within 8 steps; at 1e-3 it falls (PERF.md
# section 6)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 256, 8, 1e-3
# the card-vs-CPU train run: 2 layers of full width in fp32, at AdamW's
# default lr.  An AdamW step moves an element by up to lr whatever its
# gradient's size, so where a gradient is near 0 the rounding of the two
# devices can flip its step: at 1e-3 the params drifted 1.1e-4 apart (104 of
# 505 M elements over 1e-5) while the losses agreed within 1e-7 (PERF.md
# section 6)
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_STEPS, TRAIN_CPU_LR = 2, 128, 2, 3e-4
# relative on the losses and on each gradient leaf's largest value; max abs
# on the params
TRAIN_CPU_TOL = 1e-4
# the hybrid's card-vs-CPU train run keeps 4 of its 16 experts (every width
# kept): with all 16 the two runs' fp32 params, moments, gradients and the
# copies compared hold about 117 GB on a host of 96 GiB
TRAIN_CPU_HYBRID_EXPERTS = 4
# the checkpoint phase: steps, a checkpoint every CKPT_EVERY steps, and one
# failure injected after this step's update (after the step-2 checkpoint)
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT = 6, 2, 3
# flash dq/dk/dv against autograd through the plain version
FLASH_GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the forward kernel's logsumexp rows against the plain version's: both sum
# fp32 exponentials of the same fp32 scores (the kernel's one ex2.approx
# each, 2^-22 relative); a wrong base or scale is off by O(1)
LSE_TOL = 1e-4
# the SSD backward's dx, ddt, da, db, dc against autograd through the plain
# ssd_chunked, each relative to its largest value: the JAX package's 5e-4 in
# fp32 (tests/test_kernels.py::test_ssd_grads), the per-kernel bf16 one in
# bf16 (dx, db and dc come back in bf16)
SSD_GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-4}
# ddt and da, which both backward routes store in fp32, in bf16: the wgmma
# route's two-term split of its fp32 factors reads about 4e-6 of each one's
# largest value, plain bf16 factors 4e-4 to 3e-3 (the CPU emulation,
# tests/test_torch_ssd_scan.py::TC_GRAD_REL), so this holds the split
SSD_FP32_STORE_TOL = 1e-4
# the expert FFN's gradients against autograd through its plain version: the
# JAX package's 2e-3 in fp32 (tests/test_kernels.py), the grouped matmul's
# bf16 tolerance in bf16 (the two round silu(gate) * up to bf16 alike)
FFN_GRAD_TOL = {torch.bfloat16: GMM_TOL[torch.bfloat16], torch.float32: 2e-3}
GMM_LAYOUTS = ("fwd", "dx", "dw")  # a layer's forward product and its two backward ones


def log(msg: str) -> None:
    print(msg, flush=True)


def wall_marks():
    """(mark, walls): ``mark(what)`` appends (what, the seconds since the
    previous mark) to ``walls``."""
    t0, walls = time.perf_counter(), []

    def mark(what: str) -> None:
        walls.append((what, time.perf_counter() - t0 - sum(w for _, w in walls)))

    return mark, walls


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of one call of ``fn``.  The ``iters`` timed calls queue
    behind a device-side sleep and run back to back, so the host's launch
    overhead stays out of the time: a kernel shorter than its launch would
    otherwise be timed at the host's launch rate.  The sleep grows until the
    host has queued every call before it ends."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()  # the sleep was still running
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise SystemExit("cuda_ms: the host could not queue the timed calls ahead of the device")


def device_ms_by_kernel(fn, calls: int = 5) -> str:
    """Device ms per call of each kernel that ``fn`` launches, by
    torch.profiler over ``calls`` calls: where the time of a call of
    several kernels goes."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.self_device_time_total > 0:  # "void (anonymous namespace)::name<T>(args)" -> "name<T>"
            m = re.search(r"(\w+(?:<[^()]*?>)?)\(", e.key)
            parts.append(f"{m.group(1) if m else e.key[:40]} {e.self_device_time_total / 1e3 / calls:.4f}")
    return ", ".join(parts) if parts else "the profiler saw no device time (not measured)"


def _dt(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


@dataclasses.dataclass(frozen=True)
class Shape:
    """A flash attention call: q [B, S, H, D], k/v [B, S, KV, D]; ``fused``
    takes q, k and v as strided views of one [B, S, H + 2 KV, D] buffer, as
    a fused projection gives them."""
    b: int
    s: int
    h: int
    kv: int
    d: int
    dtype: torch.dtype
    causal: bool = True
    window: int = 0
    fused: bool = False

    def __str__(self):
        mask = ("causal" if self.causal else "full") + (f" w{self.window}" if self.window else "")
        return (f"{_dt(self.dtype)} B{self.b} S{self.s} H{self.h} KV{self.kv} D{self.d} {mask}"
                + (" fused-qkv" if self.fused else ""))

    def inputs(self, seed: int = 0):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        mk = lambda heads: torch.randn(self.b, self.s, heads, self.d, generator=gen,  # noqa: E731
                                       device="cuda").to(self.dtype)
        if self.fused:
            qkv = mk(self.h + 2 * self.kv)
            return qkv.split([self.h, self.kv, self.kv], dim=2)
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

    def bwd_bound(self) -> tuple[float, str]:
        """The backward's least time: five products over the attended pairs
        (the scores again, dV, dP, dQ, dK) at the peak of the inputs' type,
        and its bytes: q, k, v, o, dO and the fp32 lse rows read once, dq,
        dk and dv written once."""
        elem = 2 if self.dtype == torch.bfloat16 else 4
        ops = 10.0 * self.b * self.h * self.d * self.attended_pairs()
        nbytes = (self.b * self.s * self.d * (4 * self.h + 4 * self.kv) * elem
                  + 4 * self.b * self.h * self.s)
        t_ops, t_bytes = ops / PEAK_OPS[self.dtype], nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


@dataclasses.dataclass(frozen=True)
class GmmShape:
    """A grouped matmul call of a layer whose forward is x [E, C, D] x w [E,
    D, F]: that forward (``layout`` "fwd"), or one of its backward products
    with g [E, C, F]: "dx" is g w^T [E, C, D], "dw" is x^T g [E, D, F], the
    transposed operand a view of the stored tensor, as the autograd function
    passes it.  ``strided`` stores x, w and g as views of larger buffers
    (rows, columns and experts at other strides, starting off the buffers'
    first element).  Each layout does 2 E C D F operations and moves the
    same three tensors (two read, one written)."""
    e: int
    c: int
    d: int
    f: int
    dtype: torch.dtype
    strided: bool = False
    layout: str = "fwd"

    def __str__(self):
        return (f"{_dt(self.dtype)} E{self.e} C{self.c} D{self.d} F{self.f}"
                + (" strided" if self.strided else "")
                + ("" if self.layout == "fwd" else f" {self.layout}"))

    def nbytes(self) -> int:
        elem = 2 if self.dtype == torch.bfloat16 else 4
        return (self.e * self.c * self.d + self.e * self.d * self.f
                + self.e * self.c * self.f) * elem

    def inputs(self, seed: int = 0):
        """The call's two operands, in the order ``gmm`` takes them."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        pad = 3 if self.strided else 0  # rows, and 8 x as many columns, around each view

        def stored(rows, cols, scale=1.0):
            t = torch.randn(self.e + pad, rows + 2 * pad, cols + 16 * pad, generator=gen,
                            device="cuda") * scale
            return t.to(self.dtype)[pad:, pad:pad + rows, 8 * pad:8 * pad + cols]

        if self.layout == "fwd":
            return stored(self.c, self.d), stored(self.d, self.f, self.d**-0.5)
        if self.layout == "dx":
            return stored(self.c, self.f), stored(self.d, self.f, self.d**-0.5).transpose(1, 2)
        return stored(self.c, self.d).transpose(1, 2), stored(self.c, self.f)

    def bound(self) -> tuple[float, str]:
        ops = 2.0 * self.e * self.c * self.d * self.f
        t_ops, t_bytes = ops / PEAK_OPS[self.dtype], self.nbytes() / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


@dataclasses.dataclass(frozen=True)
class SsdShape:
    """An SSD scan call: x [B, S, H, P], dt [B, S, H], a [H], b/c [B, S, N].
    ``chunk`` is the plain version's (the kernel takes its own)."""
    b: int
    s: int
    h: int
    p: int
    n: int
    dtype: torch.dtype
    chunk: int = dataclasses.field(default=512, compare=False)
    edges: bool = False  # rows of dt = 0, far below 1 and < 0

    def __str__(self):
        return (f"{_dt(self.dtype)} B{self.b} S{self.s} H{self.h} P{self.p} N{self.n}"
                + (" dt-edges" if self.edges else ""))

    def nbytes(self) -> int:
        """x and y in their dtype, b and c read once, dt, a and the fp32 state."""
        elem = 2 if self.dtype == torch.bfloat16 else 4
        return (elem * (2 * self.b * self.s * self.h * self.p + 2 * self.b * self.s * self.n)
                + 4 * (self.b * self.s * self.h + self.h + self.b * self.h * self.p * self.n))

    def inputs(self, seed: int = 0):
        """x, dt, a, b, c drawn as the JAX package's SSD sweep draws them."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(self.b, self.s, self.h, self.p, generator=gen, device="cuda")
        dt = torch.rand(self.b, self.s, self.h, generator=gen, device="cuda") * 0.199 + 0.001
        if self.edges:  # as test_torch_gpu.py::test_ssd_kernel_takes_zero_tiny_and_negative_dt
            dt[:, ::7] = 0.0
            dt[:, 3::11] = 1e-30
            dt[:, 5::13] = -0.01
        a = -(torch.rand(self.h, generator=gen, device="cuda") * 3.5 + 0.5)
        bc = [torch.randn(self.b, self.s, self.n, generator=gen, device="cuda").to(self.dtype)
              for _ in range(2)]
        return x.to(self.dtype), dt, a, *bc

    def bwd_nbytes(self) -> int:
        """The backward's inputs x, dy, b, c, dt, a and outputs dx, db, dc,
        ddt, da, each once (the final state's cotangent is none in
        training)."""
        elem = 2 if self.dtype == torch.bfloat16 else 4
        return (elem * (3 * self.b * self.s * self.h * self.p + 4 * self.b * self.s * self.n)
                + 4 * (2 * self.b * self.s * self.h + 2 * self.h))

    def bound(self) -> tuple[float, str]:
        """Operations of the chunked schedule at the kernel's chunk Q: per
        chunk of L rows, C B^T over the lower triangle, L (L + 1) N, once for
        all heads; and per head G u over the lower triangle, L (L + 1) P,
        C S^T, 2 L N P (not in the first chunk, where S = 0), and the state
        update, 2 L P N.  Each product counts once (not once per bf16 term),
        at the peak of the fastest unit that gives the accuracy phase 2
        holds: the bf16 tensor cores for bf16 inputs (their fp32 factors
        split into two bf16 terms), the fp32 FMA units for fp32."""
        rows = [min(ssd_kernel.CHUNK, self.s - t0) for t0 in range(0, self.s, ssd_kernel.CHUNK)]
        cb = self.b * sum(r * (r + 1) * self.n for r in rows)
        rest = self.b * self.h * sum(r * (r + 1) * self.p + 2 * r * self.n * self.p * (1 + (i > 0))
                                     for i, r in enumerate(rows))
        t_ops = (cb + rest) / PEAK_OPS[self.dtype]
        t_bytes = self.nbytes() / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    def bwd_bound(self) -> tuple[float, str]:
        """The backward's least time: its products at the peak of the
        inputs' type, as ``bound`` (for bf16 the tensor cores, on which the
        wgmma route computes them; each product counts once, not once per
        bf16 term), and its bytes, ``bwd_nbytes``.  Per head the
        forward walk's state updates over every chunk but the last and the
        backward walk's over every chunk but the first, 2 L P N each; per
        chunk C B^T (once for all heads), and per head dy u^T and the
        (C B^T) L term of du over the lower triangle, L (L + 1) P each, the
        state terms of du, dB and dC, 2 L N P each, and the (dy u^T) L terms
        of dB and dC over the lower triangle, L (L + 1) N each; and the sums
        of dB and dC over the heads, 2 B S H N."""
        rows = [min(ssd_kernel.CHUNK, self.s - t0) for t0 in range(0, self.s, ssd_kernel.CHUNK)]
        cb = self.b * sum(r * (r + 1) * self.n for r in rows)
        walks = 2 * self.p * self.n * (sum(rows[:-1]) + sum(rows[1:]))
        chunk = sum(2 * r * (r + 1) * self.p + 6 * r * self.n * self.p
                    + 2 * r * (r + 1) * self.n for r in rows)
        ops = cb + self.b * self.h * (walks + chunk) + 2 * self.b * self.s * self.h * self.n
        t_ops, t_bytes = ops / PEAK_OPS[self.dtype], self.bwd_nbytes() / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card_and_build() -> tuple[str, str]:
    smi = _smi()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 card: {kind}, torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc each
        built = dict(zip(KERNELS, pool.map(lambda k: k.load(), KERNELS.values())))
    for name, b in built.items():
        ptxas = "; ".join(_ptxas_by_kernel(b.log))
        warnings = [line.strip() for line in b.log.splitlines() if "warning" in line.lower()]
        serialised = [line.split("ptxas info    : ")[-1].strip() for line in b.log.splitlines()
                      if "Potential Performance Loss" in line]
        log(f"phase 1 build: {name} built by nvcc in {b.seconds:.1f} s (ptxas: {ptxas}); "
            f"{len(warnings)} compiler warnings, {len(serialised)} wgmma serialisation notes")
        for w in warnings + serialised:  # e.g. ptxas's "setmaxnreg ignored"
            log(f"phase 1 build: {name} warning: {w}")
    log(f"phase 1 build: all {len(built)} kernels in {time.perf_counter() - t0:.1f} s wall")
    return smi, kind


def _kernel_label(mangled: str) -> str:
    """A kernel's name and first template argument from its mangled name
    (``flash_bwd_dkdv_bf16<128>``, ``flash_bwd_prep<f>``), skipping the
    anonymous namespace."""
    pos, name = (3 if mangled.startswith("_ZN") else 2), ""
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        name, pos = mangled[start:start + int(m.group())], start + int(m.group())
        if not name.startswith("_GLOBAL__N"):
            break
    if not name:
        return mangled[:48]
    arg = re.match(r"IL[ijb](\d+)E|I(?:\d+)?([A-Za-z_]\w*?)E", mangled[pos:])
    return f"{name}<{arg.group(1) or arg.group(2)}>" if arg else name


def _ptxas_by_kernel(log: str) -> list[str]:
    """ptxas's registers and spills of each kernel of a build log."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = _kernel_label(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = "" if m.group(1) == m.group(2) == "0" else f", spills {m.group(1)}/{m.group(2)} B"
        elif m := re.search(r"Used (\d+) registers", line):
            out.append(f"{name} {m.group(1)} regs{spill}")
            spill = ""
    return out


def main_shape(rows: int, bucket: int, arch: str = DENSE) -> Shape:
    """The flash kernel's shape in one prefill group of ``arch``."""
    cfg = get_config(arch)
    return Shape(rows, bucket, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16,
                 window=cfg.sliding_window)


def train_shape(dtype=torch.bfloat16, b: int = TRAIN_BATCH, s: int = TRAIN_SEQ,
                arch: str = DENSE) -> Shape:
    """The flash kernel's shape in ``arch``'s train forward."""
    return dataclasses.replace(main_shape(b, s, arch), dtype=dtype)


def expert_shapes(c: int, dtype=torch.bfloat16, arch: str = MOE, cfg=None) -> list[GmmShape]:
    """``arch``'s (or ``cfg``'s) three grouped matmuls at capacity ``c``:
    gate and up share one shape, then down."""
    cfg = cfg or get_config(arch)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert_ff
    return [GmmShape(e, c, d, f, dtype), GmmShape(e, c, f, d, dtype)]


def train_gmm_shapes(dtype=torch.bfloat16, b: int = TRAIN_BATCH,
                     s: int = TRAIN_SEQ, arch: str = MOE, cfg=None) -> list[GmmShape]:
    """Every grouped matmul of an ``arch`` (or ``cfg``) train step on b x s
    tokens: each expert shape's forward, dx and dw (granite: C = 640 at B 8
    S 256; jamba: C = 320)."""
    cfg = cfg or get_config(arch)
    c = capacity(cfg, b * s)
    return [dataclasses.replace(sh, layout=lay) for sh in expert_shapes(c, dtype, arch, cfg)
            for lay in GMM_LAYOUTS]


def served_groups(arch: str) -> list[tuple[int, int]]:
    """(rows, tokens) of every prefill ``arch``'s served runs can make on 4
    slots: groups of 1 to 4 rows at power-of-two buckets of 128 to 2048
    (the 4 x 512 one-shot batch among them); for a stack with SSM layers
    each prompt of the traffic alone at its exact length, and the one-shot
    batch."""
    if not layer_kinds(get_config(arch))[2]:
        return [(g, b) for g in MAIN_ROWS for b in MAIN_BUCKETS]
    lens, _, batch = traffic(get_config(arch).vocab)
    return sorted({(1, int(n)) for n in lens} | {batch.shape})


def main_capacities(arch: str = MOE) -> list[int]:
    """Every capacity ``arch``'s served runs can give the grouped matmul on
    4 slots: decode, and each prefill of ``served_groups``."""
    cfg = get_config(arch)
    return sorted({capacity(cfg, N_SLOTS)} | {capacity(cfg, g * b) for g, b in served_groups(arch)})


def longest_prompt() -> int:
    """The longest prompt of the served traffic (its lengths do not depend
    on the vocab)."""
    return int(traffic(get_config(HYBRID).vocab)[0].max())


def main_flash_shapes(arch: str) -> list[Shape]:
    """Every flash attention shape ``arch``'s served prefills give the kernel."""
    return [main_shape(g, b, arch) for g, b in served_groups(arch)]


def profile_shapes(arch: str) -> tuple[list[Shape], list[GmmShape], list[SsdShape]]:
    """The kernels' shapes in the prefills of phase 4's decode profile of a
    stack with SSM layers: one prompt of ``PROFILE_PROMPT`` tokens alone
    (a pure-attention stack's profile prefills fall in its served groups)."""
    cfg = get_config(arch)
    n_attn, n_moe, _ = layer_kinds(cfg)
    return ([main_shape(1, PROFILE_PROMPT, arch)] if n_attn else [],
            expert_shapes(capacity(cfg, PROFILE_PROMPT), arch=arch) if n_moe else [],
            [ssm_shape(1, PROFILE_PROMPT, arch=arch)])


def _check(name: str, shape, out, ref, tol: float, phase: int = 2) -> float:
    """``out`` against ``ref`` (a tensor each, or tuples of them)."""
    pairs = list(zip(out, ref)) if isinstance(out, tuple) else [(out, ref)]
    errs = [(o.float() - r.float()).abs() for o, r in pairs]
    ok = all(bool((e <= tol + tol * r.float().abs()).all()) for e, (_, r) in zip(errs, pairs))
    err = max(e.max().item() for e in errs)
    log(f"phase {phase} check {name} {shape}: max_abs_err {err:.3e} "
        f"(tol {tol:g} abs + rel) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version at {shape}")
    return err


def phase_check_flash() -> tuple[float, set[Shape]]:
    """Flash kernel against its plain version; returns the max error at the
    main-path shapes and the main-path shapes checked."""
    main = family_flash_shapes()
    main += [sh for arch in (DENSE, MOE, HYBRID) for sh in main_flash_shapes(arch)]
    main += profile_shapes(HYBRID)[0] + session_flash_shapes()
    main += [train_shape(dt, b, s, arch) for arch in (DENSE, MOE, HYBRID)
             for dt, b, s in ((torch.bfloat16, TRAIN_BATCH, TRAIN_SEQ),
                              (torch.float32, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ))]
    other = [Shape(1, 8192, 32, 8, 80, torch.bfloat16, window=4096),
             Shape(1, 1000, 16, 8, 128, torch.bfloat16), Shape(2, 1000, 16, 8, 128, torch.float32),
             Shape(2, 77, 16, 8, 64, torch.float32)]
    edges = [s for dt in (torch.float32, torch.bfloat16) for s in flash_edges(dt)]
    main_err = 0.0
    for shape in [s for dt in (torch.float32, torch.bfloat16) for s in sweep_of(dt)] + main + other \
            + edges:
        q, k, v = shape.inputs()
        out = fa_ops.flash_attention(q, k, v, causal=shape.causal, window=shape.window)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, causal=shape.causal, window=shape.window)
        err = _check("flash_attention", shape, out, ref, TOL[shape.dtype])
        if shape in main:
            main_err = max(main_err, err)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return main_err, set(main)


def family_flash_shapes() -> list[Shape]:
    """Every flash shape of phase 9's paths, new to the kernel on a main
    path: phi-3-vision (32 heads over 32 KV heads of 96) in its served
    prefill groups, its frontend prefill (B 2, S 832) and its train
    forward, and seamless's decoder (16 over 16 of 64) in its prefill (B 4,
    S 64) and its train forward; the train shapes in fp32 too (the
    card-vs-CPU runs' B 2 x S 128, where the greedy run prefills too)."""
    shapes = main_flash_shapes(VLM) + [main_shape(VLM_ROWS, VLM_PATCHES + VLM_TEXT, VLM),
                                       main_shape(ENCDEC_ROWS, ENCDEC_PROMPT, ENCDEC)]
    return shapes + [train_shape(dt, b, s, arch) for arch in (VLM, ENCDEC)
                     for dt, b, s in ((torch.bfloat16, TRAIN_BATCH, TRAIN_SEQ),
                                      (torch.float32, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ))]


def flash_edges(dt):
    """Shapes at the edges of the kernels' tiles (128 query rows, 128 keys, 64
    columns): S of 1, 127, 129 and 1025; windows below one tile; GQA groups of
    1, 2, 4 and 8; every head dim; q, k and v as views of a fused buffer."""
    return ([Shape(2, s, 16, 8, 128, dt) for s in (1, 127, 129, 1025)]
            + [Shape(2, 300, 8, 4, 64, dt, window=32), Shape(1, 1025, 8, 2, 128, dt, window=100)]
            + [Shape(1, 257, 8, kv, 64, dt) for kv in (8, 4, 2, 1)]
            + [Shape(2, 200, 4, 2, d, dt) for d in fa_kernel.HEAD_DIMS]
            + [Shape(1, 129, 4, 2, 128, dt, causal=False)]
            + [Shape(2, 333, 16, 8, 128, dt, fused=True),
               Shape(1, 129, 32, 8, 80, dt, window=64, fused=True)])


def sweep_of(dt):
    """The shapes of the JAX package's flash kernel sweep (tests/test_kernels.py)."""
    return [Shape(2, 256, 4, 2, 64, dt), Shape(1, 512, 8, 8, 32, dt),
            Shape(2, 256, 4, 1, 64, dt, window=64), Shape(1, 128, 2, 2, 128, dt, causal=False),
            Shape(1, 384, 6, 3, 64, dt, window=128)]


def phase_check_gmm() -> tuple[float, set[GmmShape]]:
    """Grouped matmul against its plain version, its forward and both
    backward products (the sweep, ragged C and strided views in every
    layout); returns the max error at the main-path (granite and jamba
    bf16) shapes and every shape checked."""
    hybrid = [s for c in main_capacities(HYBRID) for s in expert_shapes(c, arch=HYBRID)]
    hybrid += profile_shapes(HYBRID)[1]
    main = [s for c in main_capacities() for s in expert_shapes(c)] + train_gmm_shapes() + hybrid
    main += train_gmm_shapes(arch=HYBRID)
    checked = set()
    main_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        sweep = [GmmShape(4, 256, 256, 128, dt), GmmShape(8, 128, 512, 256, dt),
                 GmmShape(2, 128, 128, 128, dt), GmmShape(16, 128, 256, 128, dt)]
        ragged = [GmmShape(8, c, 256, 128, dt)
                  for c in (1, 7, 8, 9, 16, 17, 40, 50, 63, 65, 127, 129, 160, 2560)]
        strided = [GmmShape(8, c, 256, 128, dt, strided=True) for c in (8, 65, 129)] \
            + [GmmShape(32, 8, 1024, 512, dt, strided=True),
               GmmShape(32, 200, 512, 1024, dt, strided=True)]
        granite = [s for c in main_capacities() for s in expert_shapes(c, dt)]
        backward = [dataclasses.replace(s, layout=lay) for s in sweep + ragged + strided
                    for lay in GMM_LAYOUTS[1:]]
        # granite's and jamba's train shapes (bf16 C 640 and C 320), and
        # their card-vs-CPU ones (fp32 C 80, and C 160 of jamba's 4 experts)
        train = (train_gmm_shapes() + train_gmm_shapes(arch=HYBRID) if dt == torch.bfloat16
                 else train_gmm_shapes(dt, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ)
                 + train_gmm_shapes(dt, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, cfg=hybrid_cpu_cut()))
        # jamba's served shapes, bf16 only: 1.88 GB of weights a shape
        served = hybrid if dt == torch.bfloat16 else []
        for shape in dict.fromkeys(sweep + ragged + strided + granite + backward + train + served):
            x, w = shape.inputs()
            out = gmm_ops.gmm(x, w)
            torch.cuda.synchronize()
            err = _check("moe_gmm", shape, out, reference_grouped_matmul(x, w), GMM_TOL[dt])
            if shape in main:
                main_err = max(main_err, err)
            checked.add(shape)
            del x, w, out
            if shape.d * shape.f >= 4096 * 14336:  # jamba's: 0.94 to 1.88 GB of weights
                torch.cuda.empty_cache()
        torch.cuda.empty_cache()
    return main_err, checked


def library_call(q, k, v, shape: Shape):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if shape.window:
        i = torch.arange(shape.s, device="cuda")
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < shape.window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=shape.causal,
                                                  enable_gqa=True)


def phase_time_flash() -> list[dict]:
    rows = []
    shapes = [main_shape(b, s, arch) for arch in (DENSE, MOE)
              for b in MAIN_ROWS for s in MAIN_BUCKETS]
    shapes += [Shape(1, 8192, 32, 8, 80, torch.bfloat16, window=4096),
               Shape(2, 128, 16, 8, 128, torch.float32)]
    # jamba: the longest prompt served alone, and the one-shot batch
    shapes += [main_shape(1, longest_prompt(), HYBRID), main_shape(4, 512, HYBRID)]
    # phase 9: phi-3-vision's frontend prefill and one-shot batch (D 96, no
    # grouping), seamless's decoder prefill
    shapes += [main_shape(VLM_ROWS, VLM_PATCHES + VLM_TEXT, VLM), main_shape(4, 512, VLM),
               main_shape(ENCDEC_ROWS, ENCDEC_PROMPT, ENCDEC)]
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
        log(f"phase 3 time flash_attention {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library (sdpa) {lib_ms:.4f} ms, kernel/library {ms / lib_ms:.2f}, "
            f"bound {bound_ms:.4f} ms ({bound_by}); kernel at {100 * bound_ms / ms:.1f}% of bound")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _rotating(fn, sets):
    """A call of ``fn`` on the next input set of ``sets`` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def phase_time_gmm() -> list[dict]:
    """The grouped matmul at granite's served shapes, its dx and dw at the
    train shapes (granite C 640, jamba C 320; the library call
    ``torch.bmm`` on the same transposed views), and jamba's at decode (C 2)
    and at the one-shot batch (C 320).  Each timed call reads inputs that the previous calls
    did not (copies rotate through at least 2.5x the 50 MB L2), as in
    serving, where granite's 72 calls a step stream 2.4 GB of weights and
    jamba's 12 calls a step of one period 22.5 GB."""
    rows = []
    shapes = [s for c in main_capacities() for s in expert_shapes(c)]
    shapes += [s for arch in (MOE, HYBRID) for s in train_gmm_shapes(arch=arch)
               if s.layout != "fwd"]
    shapes += expert_shapes(capacity(get_config(MOE), 2 * 128), torch.float32)[:1]
    jamba = get_config(HYBRID)
    shapes += [s for t in (N_SLOTS, 4 * 512)
               for s in expert_shapes(capacity(jamba, t), arch=HYBRID)]
    for shape in shapes:
        n_sets = max(1, min(8, math.ceil(2.5 * L2_BYTES / shape.nbytes())))
        sets = [shape.inputs(seed=i) for i in range(n_sets)]
        iters = 20 if shape.c <= 1280 else 10
        ms = cuda_ms(_rotating(gmm_ops.gmm, sets), iters=iters)
        plain_ms = cuda_ms(_rotating(reference_grouped_matmul, sets), iters=5, warmup=1)
        lib_ms = cuda_ms(_rotating(torch.bmm, sets), iters=iters)
        bound_ms, bound_by = shape.bound()
        rows.append(dict(shape=str(shape), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"phase 3 time moe_gmm {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library (torch.bmm) {lib_ms:.4f} ms, kernel/library {ms / lib_ms:.2f}, "
            f"bound {bound_ms:.4f} ms ({bound_by}); kernel at {100 * bound_ms / ms:.1f}% of bound "
            f"({n_sets} input sets)")
        del sets
        torch.cuda.empty_cache()
    return rows


def traffic(vocab: int):
    """The served traffic, from seed 0: 8 prompts of 100 to 1000 tokens (their
    lengths, and the prompts) and one 4 x 512 batch."""
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 1001, 8)
    prompts = [rng.integers(1, vocab, (int(n),)).astype(np.int32) for n in lens]
    batch = rng.integers(1, vocab, (4, 512)).astype(np.int32)
    return lens, prompts, batch


def ssm_shape(b: int, s: int, dtype=torch.bfloat16, arch: str = SSM) -> SsdShape:
    """The SSD scan's shape in a prefill of ``arch``: b rows of s tokens."""
    cfg = get_config(arch)
    c = cfg.ssm
    return SsdShape(b, s, c.expand * cfg.d_model // c.head_dim, c.head_dim, c.state_dim, dtype,
                    chunk=c.chunk_size)


def main_ssd_shapes(dtype=torch.bfloat16, arch: str = SSM) -> list[SsdShape]:
    """Every shape ``arch``'s served runs give the kernel: each prompt alone
    at its exact length, and the one-shot 4 x 512 batch."""
    return [ssm_shape(g, b, dtype, arch) for g, b in served_groups(arch)]


def train_ssd_shapes(arch: str = SSM) -> list[SsdShape]:
    """The SSD scan's shapes on ``arch``'s train paths: the full-width run
    (bf16 B 8 x S 256) and the card-vs-CPU run (fp32 B 2 x S 128); mamba2
    H64 P64 N128, jamba H128 P64 N16."""
    return [ssm_shape(TRAIN_BATCH, TRAIN_SEQ, arch=arch),
            ssm_shape(TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, torch.float32, arch=arch)]


def ssd_edges(dt):
    """Shapes at the edges of the bf16 kernel's tiles (chunks of 64 rows, 32
    columns of P, boxes of 64 columns of N): S of 1 to 1000 around 64 and
    128, P of 8 to 64, N of 16 to 128, a batch of 4; and a bf16 shape of the
    kernel's FMA route (P and N not multiples of 8)."""
    shapes = ([SsdShape(1, s, 4, 64, 128, dt, 256) for s in (1, 63, 64, 65, 127, 128, 129, 1000)]
              + [SsdShape(2, 130, 4, p, 64, dt, 64) for p in (8, 16, 32, 64)]
              + [SsdShape(2, 130, 4, 32, n, dt, 64) for n in (16, 32, 64, 128)]
              + [SsdShape(4, 200, 8, 64, 128, dt, 64), SsdShape(2, 100, 3, 12, 20, dt, 64)])
    return list(dict.fromkeys(shapes))


def _check_ssd(shape: SsdShape, out, ref, served: bool) -> float:
    """The kernel's (y, final state) against the plain version's, each within
    SSD_TOL (abs + rel); at a served bf16 shape the state also within
    SSD_STATE_REL of its largest value.  Returns the larger abs error."""
    tol = SSD_TOL[shape.dtype]
    (y, h), (yr, hr) = out, ref
    y_err = (y.float() - yr.float()).abs()
    h_err = (h - hr).abs()
    ok = bool((y_err <= tol + tol * yr.float().abs()).all()) and bool((h_err <= tol + tol * hr.abs()).all())
    h_rel = (h_err.max() / hr.abs().max()).item()
    strict = served and shape.dtype == torch.bfloat16
    if strict:
        ok = ok and h_rel <= SSD_STATE_REL
    log(f"phase 2 check ssd_scan {shape} ({ssd_kernel.route(shape.dtype, shape.p, shape.n)}): "
        f"y max_abs_err {y_err.max().item():.3e}, state max_abs_err {h_err.max().item():.3e}, "
        f"state rel {h_rel:.3e} (tol {tol:g} abs + rel"
        + (f"; state rel <= {SSD_STATE_REL:g}" if strict else "") + f") {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"ssd_scan disagrees with its plain version at {shape}")
    return max(y_err.max().item(), h_err.max().item())


def phase_check_ssd() -> tuple[float, set[SsdShape]]:
    """SSD scan against its plain version; returns the max error at the
    main-path (mamba2 and jamba bf16) shapes and every shape checked."""
    main = main_ssd_shapes() + main_ssd_shapes(arch=HYBRID)
    checked = set()
    main_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        sweep = [SsdShape(2, 128, 4, 32, 16, dt, 32), SsdShape(1, 256, 2, 64, 32, dt, 64),
                 SsdShape(1, 64, 8, 16, 128, dt, 16)]
        ragged = [SsdShape(2, 77, 3, 16, 32, dt, 32), SsdShape(1, 1, 4, 64, 128, dt, 64),
                  SsdShape(3, 130, 2, 8, 16, dt, 64), SsdShape(1, 1000, 8, 64, 128, dt, 256)]
        card_vs_cpu = [ssm_shape(1, n, dt, arch) for arch in (SSM, HYBRID)  # phase 5's prefills
                       for n in (100, 77)]
        served = main_ssd_shapes(dt) + (main_ssd_shapes(arch=HYBRID) if dt == torch.bfloat16
                                         else [])
        profile = ([sh for arch in (SSM, HYBRID) for sh in profile_shapes(arch)[2]]
                   if dt == torch.bfloat16 else [])
        train = [sh for arch in (SSM, HYBRID) for sh in train_ssd_shapes(arch)
                 if sh.dtype == dt]  # phase 6's
        for shape in dict.fromkeys(sweep + ragged + ssd_edges(dt) + card_vs_cpu + served + train
                                   + profile):
            args = shape.inputs()
            out = ssd_ops.ssd(*args)  # (y, final state)
            torch.cuda.synchronize()
            err = _check_ssd(shape, out, ssd_chunked(*args, shape.chunk), shape in served)
            if shape in main:
                main_err = max(main_err, err)
            checked.add(shape)
            del args, out
        torch.cuda.empty_cache()
    return main_err, checked


def _ssd_grads(fn, args, dy, dh=None):
    """Gradients of ``sum(y * dy)`` (and ``sum(h_final * dh)``) through ``fn``
    with respect to x, dt, a, b and c."""
    leaves = [t.detach().requires_grad_() for t in args]
    y, hf = fn(*leaves)
    outs, cots = ([y], [dy]) if dh is None else ([y, hf], [dy, dh])
    return torch.autograd.grad(outs, leaves, cots)


def ssd_grad_cases() -> list[tuple[SsdShape, bool]]:
    """Phase 2's backward cases, (shape, with the final state's cotangent):
    mamba2's and jamba's train shapes (bf16 B 8 x S 256, the card-vs-CPU
    fp32 B 2 x S 128) with the cotangent of y only, as training gives it; the JAX
    package's gradient-test shape; a ragged S (200 rows: a last chunk of 8)
    with the final state's cotangent, and with rows of dt = 0, tiny and
    negative, in both dtypes; and in bf16 the wgmma route's edges (N of one
    box, P of 8 and 16, three heads, which make groups of one) and a shape
    it does not take (P 12, N 20: the FMA route)."""
    bf16 = torch.bfloat16
    cases = [(sh, False) for arch in (SSM, HYBRID) for sh in train_ssd_shapes(arch)]
    cases += [(SsdShape(1, 64, 2, 16, 16, torch.float32, 32), False)]
    for dt in (torch.float32, bf16):
        cases += [(SsdShape(2, 200, 4, 64, 128, dt, 64), True),
                  (SsdShape(2, 200, 4, 64, 128, dt, 64, edges=True), False)]
    cases += [(SsdShape(1, 64, 2, 16, 16, bf16, 32), False), (SsdShape(2, 130, 4, 8, 16, bf16, 64), True),
              (SsdShape(2, 130, 3, 16, 32, bf16, 64), True), (SsdShape(2, 100, 3, 12, 20, bf16, 64), True)]
    return cases


def phase_check_ssd_grads() -> tuple[float, set[SsdShape]]:
    """The SSD backward kernels, through ``ops.ssd``'s autograd function,
    against autograd through the plain ``ssd_chunked`` on the same inputs on
    the card, at ``ssd_grad_cases``: each of dx, ddt, da, db and dc within
    ``SSD_GRAD_TOL`` of its largest value (ddt and da in bf16 within
    ``SSD_FP32_STORE_TOL``), in its input's dtype, and finite;
    one backward launch each, on the route ``bwd_route`` names (the wgmma
    route at every bf16 case it takes, the FMA route in fp32 and at the bf16
    shape it does not take).  Returns the max abs error at the bf16 train
    shape and the shapes checked."""
    main = train_ssd_shapes()[0]
    cases = ssd_grad_cases()
    main_err = 0.0
    for shape, with_state in cases:
        args = shape.inputs(seed=7)
        gen = torch.Generator(device="cuda").manual_seed(8)
        dy = torch.randn(args[0].shape, generator=gen, device="cuda").to(shape.dtype)
        dh = (torch.randn(shape.b, shape.h, shape.p, shape.n, generator=gen, device="cuda")
              if with_state else None)
        way = ssd_kernel.bwd_route(shape.dtype, shape.p, shape.n)
        before = (ssd_kernel.bwd_launches, ssd_kernel.bwd_wgmma_launches)
        got = _ssd_grads(ssd_ops.ssd, args, dy, dh)
        torch.cuda.synchronize()
        made = (ssd_kernel.bwd_launches - before[0], ssd_kernel.bwd_wgmma_launches - before[1])
        if made != (1, int(way == "wgmma")) or any(g.dtype != t.dtype for g, t in zip(got, args)):
            raise SystemExit(f"ssd_scan backward at {shape}: {made} (all, wgmma) launches for "
                             f"route {way}, dtypes {[g.dtype for g in got]}")
        want = _ssd_grads(lambda *a: ssd_chunked(*a, shape.chunk), args, dy, dh)
        tol = SSD_GRAD_TOL[shape.dtype]
        tols = [tol] * 5
        if shape.dtype == torch.bfloat16:
            tols[1] = tols[2] = SSD_FP32_STORE_TOL  # ddt, da: fp32 stores
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        rels = [e / w.float().abs().max().item() for e, w in zip(errs, want)]
        ok = (all(r <= t for r, t in zip(rels, tols))
              and all(bool(torch.isfinite(g.float()).all()) for g in got))
        names = ("dx", "ddt", "da", "db", "dc")
        log(f"phase 2 check ssd_scan_bwd {shape} ({way})"
            f"{' + final-state cotangent' if with_state else ''}: "
            + ", ".join(f"{n} rel {r:.3e} (tol {t:g})" for n, r, t in zip(names, rels, tols))
            + f" of each gradient's largest value; max_abs_err {max(errs):.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the ssd_scan backward disagrees with autograd through its plain "
                             f"version at {shape}")
        if shape == main:
            main_err = max(errs)
        del args, got, want
    torch.cuda.empty_cache()
    return main_err, {shape for shape, _ in cases}


def phase_time_ssd_backward() -> dict:
    """The SSD backward at mamba2's and jamba's train shapes
    (``time_ssd_backward``); returns mamba2's row."""
    return [time_ssd_backward(train_ssd_shapes(arch)[0]) for arch in (SSM, HYBRID)][0]


def time_ssd_backward(shape: SsdShape) -> dict:
    """The SSD backward at a train shape: the kernels of the route it
    takes (``ops._backward``: the launch and its scratch; the wgmma route),
    the FMA route's kernels on the same inputs, timed in turns (FMA, wgmma,
    wgmma, FMA), the plain backward (autograd through ``ssd_chunked``), and
    the bound; no PyTorch call computes it."""
    args = [t.detach() for t in shape.inputs(seed=1)]
    dy = torch.randn(args[0].shape, device="cuda").to(shape.dtype)
    need = (True,) * 5
    way = ssd_kernel.bwd_route(shape.dtype, shape.p, shape.n)
    times = {way: [], "fma": []}
    for turn in ("fma", way, way, "fma"):
        times[turn].append(cuda_ms(lambda: ssd_ops._backward(*args, dy, None, need, way=turn),
                                   iters=10))
    leaves = [t.requires_grad_() for t in args]
    y_plain, _ = ssd_chunked(*leaves, shape.chunk)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(y_plain, leaves, dy, retain_graph=True),
                       iters=5, warmup=1)
    ms, fma_ms = min(times[way]), min(times["fma"])
    bound_ms, bound_by = shape.bwd_bound()
    split = {turn: device_ms_by_kernel(lambda: ssd_ops._backward(*args, dy, None, need, way=turn))
             for turn in (way, "fma")}
    log(f"phase 3 time ssd_scan_bwd {shape}: kernel ({way}) "
        + " / ".join(f"{t:.4f}" for t in times[way]) + " ms, FMA route "
        + " / ".join(f"{t:.4f}" for t in times["fma"]) + f" ms ({fma_ms / ms:.2f}x the "
        f"{way} route's time), plain (autograd through ssd_chunked) {plain_ms:.4f} ms, library "
        f"none, bound {bound_ms:.4f} ms ({bound_by}); kernel at {100 * bound_ms / ms:.1f}% of "
        f"bound; device ms a call by kernel ({way}: {split[way]}; fma: {split['fma']})")
    del y_plain, args, leaves
    torch.cuda.empty_cache()
    return dict(shape=str(shape), ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, fma_ms=fma_ms)


def phase_time_ssd() -> list[dict]:
    """The SSD scan at all nine served mamba2 shapes (each prompt at its
    exact length, and the one-shot batch), bf16, one fp32 shape, jamba's
    longest prompt served alone and jamba's train shape (B 8 x S 256);
    inputs rotate through at least 2.5x the L2 as in ``phase_time_gmm``."""
    shapes = main_ssd_shapes() + [ssm_shape(1, 100, torch.float32),
                                  ssm_shape(1, longest_prompt(), arch=HYBRID),
                                  train_ssd_shapes(HYBRID)[0]]
    rows = []
    for shape in shapes:
        n_sets = max(1, min(8, math.ceil(2.5 * L2_BYTES / shape.nbytes())))
        sets = [shape.inputs(seed=i) for i in range(n_sets)]
        ms = cuda_ms(_rotating(ssd_ops.ssd, sets), iters=20)
        plain_ms = cuda_ms(_rotating(lambda *a: ssd_chunked(*a, shape.chunk), sets), iters=5,
                           warmup=1)
        bound_ms, bound_by = shape.bound()
        rows.append(dict(shape=str(shape), ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"phase 3 time ssd_scan {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library none, bound {bound_ms:.4f} ms ({bound_by}); "
            f"kernel at {100 * bound_ms / ms:.1f}% of bound ({n_sets} input sets)")
        del sets
        torch.cuda.empty_cache()
    return rows


def layer_kinds(cfg) -> tuple[int, int, int]:
    """(GQA attention layers, MoE layers, SSM layers) of the decoder: the
    layers of the flash kernel, the grouped matmul and the SSD scan.  MLA
    layers are none of them (the reference runs MLA outside its kernels),
    nor are an encoder's (its attention is bidirectional and plain)."""
    kinds = [tf.mixer_kind(cfg, i) for i in range(cfg.n_layers)]
    return (kinds.count("attn"), sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers)),
            kinds.count("ssm"))


def expected_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """Launches a path makes: flash attention once per attention layer and
    prefill, the grouped matmul three times per MoE layer and prefill or
    decode step, the SSD scan once per SSM layer and prefill (decode keeps
    the plain ``ssd_step``)."""
    n_attn, n_moe, n_ssm = layer_kinds(cfg)
    return {"flash_attention": n_attn * prefills, "flash_attention_bwd": 0,
            "moe_gmm": 3 * n_moe * (prefills + decode_steps),
            "ssd_scan": n_ssm * prefills, "ssd_scan_bwd": 0, "ssd_scan_bwd_wgmma": 0}


def _launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def _reset_launches() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def init_loaded(model, seed: int = 0) -> dict:
    """``model.load(model.init(gen))`` with a generator on the model's
    device seeded ``seed``, one layer at a time: the same draws in the same
    order, so the same values, with at most one layer's fp32 copy alive
    beside the loaded weights (jamba's MoE layer is 11.3 GB in fp32, one
    period of its layers 53 GB)."""
    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    top = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
           "final_norm": zeros_init(gen, (cfg.d_model,), dtype)}
    if not cfg.tie_embeddings:
        top["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype)
    if cfg.frontend is not None:
        top["frontend_proj"] = dense_init(gen, (cfg.frontend.d_frontend, cfg.d_model), dtype)
    params = model.load(top)
    del top
    if cfg.enc_dec:
        params["encoder"] = [model.load(tf.encoder_block_init(gen, cfg, dtype))
                             for _ in range(cfg.n_encoder_layers)]
    params["layers"] = [model.load(tf.block_init(gen, cfg, i, dtype))
                        for i in range(cfg.n_layers)]
    return params


def phase_serve(arch: str, flash_checked: set[Shape], gmm_checked: set[GmmShape],
                ssd_checked: set[SsdShape], n_layers: int | None = None,
                sessions: dict | None = None, phase: int = 4) -> dict:
    """One main path at full width (cut to ``n_layers`` layers when given);
    returns the launches it made by kernel.  Fails if a launch count does
    not match the path, or if the path ran a kernel at a shape phase 2 did
    not check.  For the hybrid, then its bf16 prefill against the plain
    versions on the same weights (``check_prefill_vs_plain``).  With
    ``sessions``, then phase 8 on the same weights, its launches stored
    there under ``sessions <arch>``."""
    cfg = get_config(arch)
    cut = ""
    if n_layers:
        cut = f" (cut from {cfg.n_layers})"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_loaded(model)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_attn, n_moe, n_ssm = layer_kinds(cfg)
    log(f"phase {phase} init: {cfg.name} {cfg.n_layers} layers{cut} ({n_attn} attention, {n_ssm} "
        f"SSM, {n_moe} MoE), {n_params / 1e9:.3f} B params, {cfg.compute_dtype} on "
        f"{model.device} in {time.perf_counter() - t0:.1f} s (built a layer at a time), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    lens, prompts, batch = traffic(cfg.vocab)
    engine = ContinuousBatchingEngine(model, params, n_slots=N_SLOTS, max_len=SESSION_CAPACITY)
    one_shot = ServingEngine(model, params, max_len=512 + NEW_TOKENS + 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, NEW_TOKENS)
    cb_s = time.perf_counter() - t0
    cb = _launches()
    t0 = time.perf_counter()
    one = one_shot.generate(batch, NEW_TOKENS)
    one_s = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    m = engine.metrics
    want_cb = expected_launches(cfg, m.prefills, m.decode_steps)
    one_shot_want = expected_launches(cfg, 1, NEW_TOKENS - 1)
    want = {k: want_cb[k] + one_shot_want[k] for k in want_cb}
    if cb != want_cb or launches != want:
        raise SystemExit(f"{cfg.name}: launches {cb} / {launches} do not match {m.prefills} "
                         f"prefills and {m.decode_steps} decode steps of {cfg.n_layers} "
                         f"layers (+ one-shot): want {want_cb} / {want}")
    for o in outs + list(one):
        if len(o) != NEW_TOKENS or o.min() < 0 or o.max() >= cfg.vocab:
            raise SystemExit(f"bad token stream {o}")
    engine.pool.check()
    groups = [(g, b) for g, b, _ in m.prefill_walls] + [batch.shape]
    if n_attn:
        served = {main_shape(g, b, arch) for g, b in groups}
        if not served <= flash_checked:
            raise SystemExit("the main path launched flash_attention at shapes phase 2 did not "
                             f"check: {', '.join(map(str, served - flash_checked))}")
    if n_moe:
        tokens = [g * b for g, b in groups] + [N_SLOTS, batch.shape[0]]  # prefills, decodes
        served_gmm = {s for t in tokens for s in expert_shapes(capacity(cfg, t), arch=arch)}
        if not served_gmm <= gmm_checked:
            raise SystemExit("the main path launched moe_gmm at shapes phase 2 did not "
                             f"check: {', '.join(map(str, served_gmm - gmm_checked))}")
    if n_ssm:
        exact = sorted(b for g, b, _ in m.prefill_walls if g == 1)
        if len(exact) != m.prefills or exact != sorted(int(n) for n in lens):
            raise SystemExit(f"{cfg.name}: prompts not prefilled one at a time at their exact "
                             f"length: {[(g, b) for g, b, _ in m.prefill_walls]}")
        served_ssd = {ssm_shape(g, b, arch=arch) for g, b in groups}
        if not served_ssd <= ssd_checked:
            raise SystemExit("the main path launched ssd_scan at shapes phase 2 did not "
                             f"check: {', '.join(map(str, served_ssd - ssd_checked))}")
    logits, _ = model.prefill(params, torch.as_tensor(prompts[0][None]))
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("non-finite logits at full width")

    walls = ", ".join(f"{g}x{b}: {1e3 * s:.1f}" for g, b, s in m.prefill_walls)
    row_bytes = {nm: nb for nm, _, nb, _ in engine.pool._layout}
    dec = np.array([s for _, s in m.decode_walls]) * 1e3
    toks = sum(len(o) for o in outs)
    log(f"phase {phase} serve {cfg.name} continuous: {len(prompts)} requests (prompts "
        f"{lens.min()}-{lens.max()}), {toks} tokens in {cb_s:.3f} s = {toks / cb_s:.1f} tok/s; "
        f"{m.prefills} prefills, {m.decode_steps} decode steps; launches {cb} "
        f"(per prefill {expected_launches(cfg, 1, 0)}, per decode step "
        f"{expected_launches(cfg, 0, 1)}); a KV row {sum(row_bytes.values()) / 1e6:.3f} MB ("
        + ", ".join(f"{nm} {nb / 1e6:.3f}" for nm, nb in row_bytes.items()) + " MB)")
    if not any(launches.values()):  # MLA: the reference runs it outside its kernels
        log(f"phase {phase} {cfg.name}: no kernel launched on the path ok ({cfg.attn_type} "
            "attention in plain PyTorch, as the JAX package computes it outside any Pallas "
            "kernel)")
    log(f"phase {phase} {cfg.name} prefill ms per group (rows x tokens: ms): {walls}")
    log(f"phase {phase} {cfg.name} decode ms per step: median {np.median(dec):.2f}, mean "
        f"{dec.mean():.2f}, min {dec.min():.2f}, max {dec.max():.2f} (host clock, ends in a sync)")
    log(f"phase {phase} serve {cfg.name} one-shot: 4 x 512 prompt, {one.size} tokens in "
        f"{one_s:.3f} s"
        f" = {one.size / one_s:.1f} tok/s; max_memory_allocated {peak_gb:.2f} GiB; "
        f"launches of both runs {launches}")
    profile_decode(cfg.name, engine, prompts, phase=phase)
    if arch == HYBRID:
        check_prefill_vs_plain(model, params, longest_prompt())
    del engine, one_shot
    if sessions is not None:
        torch.cuda.empty_cache()
        sessions[f"sessions {arch}"] = phase_sessions(arch, model, params, flash_checked,
                                                      gmm_checked, ssd_checked,
                                                      phase=8 if phase == 4 else phase)
    del params, model
    torch.cuda.empty_cache()
    return launches


def profile_decode(name: str, engine, prompts, steps: int = 6, phase: int = 4) -> None:
    """Device busy share of decode: 4 slots decoding, ``steps`` engine steps
    under torch.profiler (after the launch counts were read), and the host
    seconds the profile took, its summary included."""
    t_prof = time.perf_counter()
    for p in prompts[:4]:
        engine.submit(p[:PROFILE_PROMPT], steps + 2)
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
        log(f"phase {phase} {name} decode profile: the profiler saw no device time (not measured)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    t_prof = time.perf_counter() - t_prof
    log(f"phase {phase} {name} decode profile: {steps} steps of 4 rows, wall {wall_ms / steps:.2f} "
        f"ms/step, device busy {busy_ms / steps:.2f} ms/step = {100 * busy_ms / wall_ms:.1f}% "
        f"(idle {100 - 100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in events) / steps:.0f} kernels/step; top device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms/step "
                    f"x{e.count // steps}" for e in top)
        + f"; profiled and summarised in {t_prof:.1f} s (host clock)")


def plain_expert_ffn(params: dict, buckets: torch.Tensor) -> torch.Tensor:
    """``gmm_ops.expert_ffn`` with each product its plain version, as the
    wrapper computes it on the CPU."""
    dt = buckets.dtype
    wg, wu, wd = (params[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    h = F.silu(reference_grouped_matmul(buckets, wg)) * reference_grouped_matmul(buckets, wu)
    return reference_grouped_matmul(h, wd)


# the plain version of each kernel wrapper the model calls, by (module, name)
PLAIN = {
    (fa_ops, "flash_attention"): lambda q, k, v, *, causal=True, window=0: reference_attention(
        q, k, v, causal=causal, window=window),
    (gmm_ops, "expert_ffn"): plain_expert_ffn,
    (ssd_ops, "ssd"): lambda x, dt, a, b, c, *, chunk=256: ssd_chunked(x, dt, a, b, c, chunk),
}


def _prefill_logits(model, params, toks, swaps=None) -> torch.Tensor:
    """Prefill logits in fp32, with the functions of ``swaps`` ({(module,
    name): function}) in place of the wrappers they name, in every layer."""
    swaps = swaps or {}
    kept = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        return model.prefill(params, toks)[0].float()
    finally:
        for (mod, name), fn in kept.items():
            setattr(mod, name, fn)


class Routing:
    """``router_topk`` that records the experts each MoE layer picks, in
    call order.  Given the picks of another run (``replay``), it counts the
    tokens whose pick differs from that run's, by call; with ``pin`` it
    then picks that run's experts instead, weighted by its own router
    probabilities at them."""

    def __init__(self, replay: list | None = None, pin: bool = False):
        self.picks, self.replay, self.pin, self.flips = [], replay, pin, []

    def __call__(self, router_w, x_flat, top_k):
        weights, experts, aux = ROUTER_TOPK(router_w, x_flat, top_k)
        self.picks.append(experts)
        if self.replay is None:
            return weights, experts, aux
        want = self.replay[len(self.picks) - 1]
        self.flips.append(int((want.sort(-1).values != experts.sort(-1).values).any(-1).sum()))
        if not self.pin:
            return weights, experts, aux
        probs = torch.softmax((x_flat @ router_w.to(x_flat.dtype)).float(), dim=-1)
        w = probs.gather(1, want)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), want, aux


ROUTER_TOPK = moe_mod.router_topk


def check_prefill_vs_plain(model, params, seq: int) -> None:
    """One bf16 prefill of ``seq`` tokens through ``model`` with its kernels
    (each wrapper's launches counted), then on the same weights with every
    kernel wrapper replaced by its plain version (no launch) and the MoE
    layers routing each token to the experts the kernel run picked: the
    same greedy token, and the logits within the port's whole-model bf16
    bound, 5e-2 + 2e-2 relative, the relative term taken against the
    largest logit (elements over the bound taken element by element are
    counted in the log line).  Routing is pinned because it is not a kernel
    and is not continuous: the kernels' bf16 roundings (a grouped matmul
    output in 1e-2 to 1e-3 differs from its plain version's by one bf16
    step, as ``torch.bmm``'s does) move the router's inputs, a near-tie then
    sends a token to another expert (an output thousands away at these
    random weights), and the SSM layers carry that token's state on to
    every later one.  Pinned, the one-step differences still grow through
    the MoE layers, whose outputs reach about 10^4 here, to several 1e-2 in
    the logits.  A third run, plain and routing freely, gives the unpinned
    gap and the tokens whose routing moved, which are logged and not
    held."""
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, cfg.vocab, (1, seq)),
                           device=model.device)
    record = Routing()
    before = _launches()
    lk = _prefill_logits(model, params, toks, {(moe_mod, "router_topk"): record})
    made = {k: n - before[k] for k, n in _launches().items()}
    pinned = Routing(record.picks, pin=True)
    lp = _prefill_logits(model, params, toks, {**PLAIN, (moe_mod, "router_topk"): pinned})
    free = Routing(record.picks)
    lf = _prefill_logits(model, params, toks, {**PLAIN, (moe_mod, "router_topk"): free})
    plain_made = {k: n - before[k] - made[k] for k, n in _launches().items()}
    want = expected_launches(cfg, 1, 0)
    if made != want or any(plain_made.values()) or len(free.flips) != layer_kinds(cfg)[1]:
        raise SystemExit(f"{cfg.name} prefill vs plain: kernel launches {made} (want {want}), "
                         f"plain runs {plain_made} (want none), {len(pinned.flips)} MoE calls")
    gap = (lk - lp).abs()
    bound = BF16_LOGITS_ATOL + BF16_LOGITS_RTOL * lp.abs().max().item()
    same = torch.equal(lk.argmax(-1), lp.argmax(-1))
    ok = bool(torch.isfinite(lk).all()) and gap.max().item() <= bound and same
    per_element = int((gap > BF16_LOGITS_ATOL + BF16_LOGITS_RTOL * lp.abs()).sum())
    free_gap = (lk - lf).abs()
    over = int((free_gap > BF16_LOGITS_ATOL + BF16_LOGITS_RTOL * lf.abs()).sum())
    launched = ", ".join(f"{k} {n}" for k, n in made.items() if n)
    log(f"phase 4 check {cfg.name} bf16 full width, {cfg.n_layers} layers, prefill 1 x {seq}: "
        f"kernels ({launched}) vs plain versions (reference_attention, reference_grouped_matmul, "
        f"ssd_chunked) routed as the kernel run: max logit gap {gap.max().item():.3e} (bound "
        f"{BF16_LOGITS_ATOL:g} + {BF16_LOGITS_RTOL:g} x the largest logit "
        f"{lp.abs().max().item():.3f} = {bound:.3e}; {per_element} of {lp.numel()} logits over "
        f"{BF16_LOGITS_ATOL:g} + {BF16_LOGITS_RTOL:g} x their own size), greedy token "
        f"{'equal' if same else 'differs'} {'ok' if ok else 'FAIL'}; plain routing freely (not "
        f"held): tokens routed otherwise by MoE layer {free.flips} of {seq}, max logit gap "
        f"{free_gap.max().item():.3e}, {over} of {lf.numel()} logits over the bound, greedy "
        f"token {'equal' if torch.equal(lk.argmax(-1), lf.argmax(-1)) else 'differs'}")
    if not ok:
        raise SystemExit(f"{cfg.name}'s bf16 prefill through the kernels is off its plain versions")


def phase_ssm_prefill_vs_plain(seq: int = 866, layers: int = 4) -> None:
    """mamba2-1.3b at full width in bf16 (random weights from seed 0), cut to
    ``layers`` layers, the depth at which the port's tests hold whole-model
    bf16 logits to 5e-2 + 2e-2 relative (the REDUCED config): one prefill of
    ``seq`` tokens with the SSD kernel in every layer against the same model
    with the plain ``ssd_chunked`` in its place, on the card, within that
    bound.  The only check of the bf16 kernel inside the model (phase 5 runs
    fp32)."""
    cfg = dataclasses.replace(get_config(SSM), n_layers=layers)
    model = build_model(cfg)
    params = model.load(model.init(torch.Generator(device="cuda").manual_seed(0)))
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, cfg.vocab, (1, seq)), device="cuda")
    before = ssd_kernel.launches
    lk = _prefill_logits(model, params, toks)
    made = ssd_kernel.launches - before
    lp = _prefill_logits(model, params, toks, {(ssd_ops, "ssd"): PLAIN[(ssd_ops, "ssd")]})
    if ssd_kernel.launches - before != made or made != layers:
        raise SystemExit(f"the bf16 prefill check launched the SSD kernel {made} times")
    gap = (lk - lp).abs()
    ok = bool(torch.isfinite(lk).all()) and bool(
        (gap <= BF16_LOGITS_ATOL + BF16_LOGITS_RTOL * lp.abs()).all())
    same = torch.equal(lk.argmax(-1), lp.argmax(-1))
    log(f"phase 4 check {cfg.name} bf16 full width, {layers} layers, prefill 1 x {seq}: SSD "
        f"kernel ({made} launches) vs plain ssd_chunked: max logit gap {gap.max().item():.3e} "
        f"(bound {BF16_LOGITS_ATOL:g} + {BF16_LOGITS_RTOL:g} relative), greedy token "
        f"{'equal' if same else 'differs'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("mamba2's bf16 prefill through the SSD kernel is off its plain version")
    del model, params
    torch.cuda.empty_cache()


def phase_prefill_profile(seq: int = 866, reps: int = 3) -> None:
    """mamba2-1.3b at full width in bf16, cut to phase 4's depth, one prompt
    of ``seq`` tokens: the wall of a prefill (host clock, ends in a sync; mean of ``reps``), then
    under torch.profiler its device busy time and the SSD kernel's part.
    The prefill is host-bound, so the device time is what the SSD kernel
    can move."""
    cfg = dataclasses.replace(get_config(SSM), n_layers=EARLIER_LAYERS[SSM])
    model = build_model(cfg)
    params = model.load(model.init(torch.Generator(device="cuda").manual_seed(0)))
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, cfg.vocab, (1, seq)), device="cuda")
    model.prefill(params, toks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model.prefill(params, toks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            model.prefill(params, toks)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    ssd_ms = sum(e.self_device_time_total for e in events if "ssd_fwd" in e.key) / 1e3 / reps
    log(f"phase 4 {cfg.name} ({cfg.n_layers} layers) prefill profile 1 x {seq}: wall {wall_ms:.2f} ms (host clock), device "
        f"busy {busy_ms:.3f} ms, of which the SSD kernel {ssd_ms:.3f} ms "
        f"({sum(e.count for e in events) / reps:.0f} kernels per prefill)")
    del model, params
    torch.cuda.empty_cache()


def family_inputs(cfg, b: int, s: int, seed: int = 0) -> dict:
    """The batch entries a frontend or an encoder-decoder config takes
    beside its tokens (numpy fp32, from ``seed``), as the JAX package's
    launcher sizes them (``src/repro/launch/specs.py:39-44``): ``min(576,
    s // 2)`` frontend rows, or ``s`` encoder frames; none otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.enc_dec:
        return {"encoder_frames": rng.normal(size=(b, s, cfg.frontend.d_frontend))
                .astype(np.float32)}
    if cfg.frontend is not None and cfg.frontend.n_tokens:
        n = min(cfg.frontend.n_tokens, s // 2)
        return {"frontend_embeds": rng.normal(size=(b, n, cfg.frontend.d_frontend))
                .astype(np.float32)}
    return {}


def check_kernels_vs_plain(model, params, batch, label: str) -> None:
    """One bf16 prefill of ``batch`` through the model with the flash kernel
    (``n_attn`` launches), then on the same weights with the plain
    ``reference_attention`` in its place (no launch): the logits within
    phase 4's whole-model bf16 bound, 5e-2 + 2e-2 x the largest logit, and
    on every row the plain logit at the kernel's greedy token within twice
    the row's largest gap of the plain row's maximum, which holds on ties
    (near a vocab of 256k two bf16 logits often tie).  That second test
    follows from the row's gap; the logit bound is the one that decides.
    Where a row's plain top-2 margin exceeds twice its gap, its greedy
    tokens must also be equal."""
    cfg = model.cfg
    before = _launches()
    lk = _prefill_logits(model, params, batch)
    made = {k: n - before[k] for k, n in _launches().items()}
    lp = _prefill_logits(model, params, batch,
                         {(fa_ops, "flash_attention"): PLAIN[(fa_ops, "flash_attention")]})
    plain_made = {k: n - before[k] - made[k] for k, n in _launches().items()}
    want = expected_launches(cfg, 1, 0)
    if made != want or any(plain_made.values()):
        raise SystemExit(f"{label}: kernel launches {made} (want {want}), plain {plain_made}")
    row_gap = (lk - lp).abs().amax(dim=(1, 2))
    bound = BF16_LOGITS_ATOL + BF16_LOGITS_RTOL * lp.abs().max().item()
    pick = lk[:, 0].argmax(-1)
    deficit = lp[:, 0].amax(-1) - lp[:, 0].gather(-1, pick[:, None])[:, 0]
    top2 = lp[:, 0].topk(2, dim=-1).values
    decided = top2[:, 0] - top2[:, 1] > 2 * row_gap
    same = pick == lp[:, 0].argmax(-1)
    ok = (bool(torch.isfinite(lk).all()) and row_gap.max().item() <= bound
          and bool((deficit <= 2 * row_gap).all()) and bool(same[decided].all()))
    log(f"phase 9 check {label}: flash_attention ({made['flash_attention']} launches) vs "
        f"plain reference_attention: max logit gap {row_gap.max().item():.3e} (bound "
        f"{BF16_LOGITS_ATOL:g} + {BF16_LOGITS_RTOL:g} x the largest logit "
        f"{lp.abs().max().item():.3f} = {bound:.3e}); the plain logit at the kernel's greedy "
        f"token below the plain maximum by {', '.join(f'{d:.3e}' for d in deficit.tolist())} "
        f"(bound twice the row's gap: "
        f"{', '.join(f'{g:.3e}' for g in row_gap.tolist())}); greedy tokens equal on "
        f"{int(same.sum())} of {lk.shape[0]} rows, {int(same[decided].sum())} of the "
        f"{int(decided.sum())} whose top-2 margin exceeds twice the gap {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: the bf16 prefill through the kernel is off its plain version")


def _greedy_decode(model, params, logits, caches, pos: int, steps: int):
    """``steps`` lockstep greedy decode steps from a prefill's logits;
    returns (tokens [B, steps + 1], ms per step, host clock to a sync)."""
    toks = [logits[:, 0].argmax(-1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step_pos = torch.full((logits.shape[0],), pos + i, device=model.device)
        logits, caches = model.decode_step(params, caches, toks[-1][:, None], step_pos)
        toks.append(logits[:, 0].argmax(-1))
    torch.cuda.synchronize()
    return torch.stack(toks, 1).cpu(), 1e3 * (time.perf_counter() - t0) / steps


def phase_prefill_then_decode(arch: str, flash_checked: set[Shape]) -> dict:
    """Phase 9's path through ``Model.prefill`` -> ``prepare_decode_caches``
    -> ``decode_step`` at full width (bf16, random weights from seed 0),
    the reference's only path for a frontend's patch rows and for an
    encoder-decoder: phi-3-vision on 2 rows of 576 patch rows of width
    1024 (numpy, seed 0) and 256 text tokens (S 832), seamless on 4 rows of
    512 encoder frames of width 160 and a 64-token decoder prompt (its
    engines refuse it, with the reference's messages, first); then 32
    greedy decode steps.  Flash runs once per decoder layer in the prefill
    (at a shape phase 2 checked) and never in decode; then the prefill
    through the kernel against the plain version (``check_kernels_vs_plain``).
    Returns the launches of the prefill and the decode."""
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_loaded(model)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    if cfg.enc_dec:
        rows, text = ENCDEC_ROWS, ENCDEC_PROMPT
        extra = {"encoder_frames": rng.normal(size=(rows, ENCDEC_FRAMES, cfg.frontend.d_frontend))
                 .astype(np.float32)}
        refused = []
        for call in (lambda: ContinuousBatchingEngine(model, params),
                     lambda: ServingEngine(model, params).generate(np.ones((1, 8), np.int32), 2)):
            try:
                call()
            except NotImplementedError as e:
                refused.append(str(e))
        if len(refused) != 2:
            raise SystemExit(f"{cfg.name}: the engines did not refuse it: {refused}")
        log(f"phase 9 {cfg.name}: both engines refuse it, as the reference's do: {refused}")
    else:
        rows, text = VLM_ROWS, VLM_TEXT
        extra = {"frontend_embeds": rng.normal(size=(rows, VLM_PATCHES, cfg.frontend.d_frontend))
                 .astype(np.float32)}
        text += VLM_PATCHES  # the patch rows take the sequence's first positions
    dev = model.device
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab, (rows, text)), device=dev),
             **{k: torch.as_tensor(v, device=dev) for k, v in extra.items()}}
    shape = main_shape(rows, text, arch)
    if shape not in flash_checked:
        raise SystemExit(f"{cfg.name}'s prefill would launch flash_attention at {shape}, which "
                         "phase 2 did not check")
    _reset_launches()
    with torch.no_grad():
        model.prefill(params, batch)  # a warm-up: the timed prefill is the second
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        prefilled = _launches()
        caches = model.prepare_decode_caches(caches, text + FAMILY_DECODE_STEPS + 8)
        toks, step_ms = _greedy_decode(model, params, logits, caches, text,
                                       FAMILY_DECODE_STEPS)
    launches = _launches()
    want = {k: 2 * n for k, n in expected_launches(cfg, 1, 0).items()}
    if prefilled != want or launches != want:
        raise SystemExit(f"{cfg.name}: launches {prefilled} after two prefills, {launches} after "
                         f"{FAMILY_DECODE_STEPS} decode steps; want {want} (none in decode)")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise SystemExit(f"{cfg.name}: bad tokens {toks}")
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    cross = (f", cross K/V {sum(caches[n].nbytes for n in tf.CROSS_KEYS) / 1e6:.1f} MB"
             if cfg.enc_dec else "")
    log(f"phase 9 {cfg.name} full width ({cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.enc_dec else "")
        + f", {n_params / 1e9:.3f} B params, built in {init_s:.1f} s): prefill of {inputs} in "
        f"{prefill_ms:.1f} ms, then {FAMILY_DECODE_STEPS} greedy decode steps at "
        f"{step_ms:.2f} ms a step ({rows * 1e3 / step_ms:.1f} tok/s; host clock, ends in a "
        f"sync){cross}; flash_attention {want['flash_attention'] // 2} "
        f"launches a prefill at {shape}, 0 a decode step; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{_smi()}]")
    check_kernels_vs_plain(model, params, batch, f"{cfg.name} bf16 full width prefill")
    del params, model, caches, logits
    torch.cuda.empty_cache()
    return launches


def phase_families(flash_checked: set[Shape], flash_grad_checked: set[Shape]) -> dict:
    """Phase 9, the MLA, vision-frontend and encoder-decoder families at full width:
    minicpm3-4b (MLA, no kernel on its path) served through both engines
    and through two-turn sessions; phi-3-vision-4.2b served on text through
    both engines and run on its frontend rows; seamless-m4t-large-v2's
    encoder-decoder through prefill and decode; each cut to 2 layers (2 + 2)
    on the card against the CPU, greedy and one gradient pass; each trained
    ``TRAIN_STEPS`` steps, as phase 6 trains (at 4 steps, minicpm3's loss
    rose from 11.5586 to 11.5629 while the warmup of 5 steps ramped the
    rate).  Returns the launches by path."""
    t0 = time.perf_counter()
    mark, walls = wall_marks()
    paths, sessions = {}, {}
    none = dict.fromkeys(COUNTERS, 0)
    paths[MLA] = phase_serve(MLA, flash_checked, set(), set(), sessions=sessions, phase=9)
    mark(f"{MLA} serve and sessions")
    paths[VLM] = phase_serve(VLM, flash_checked, set(), set(), phase=9)
    paths[f"frontend {VLM}"] = phase_prefill_then_decode(VLM, flash_checked)
    paths[f"prefill and decode {ENCDEC}"] = phase_prefill_then_decode(ENCDEC, flash_checked)
    mark(f"{VLM} and {ENCDEC}")
    for arch in FAMILIES:
        phase_card_vs_cpu(arch, steps=16, phase=9)
    for arch in FAMILIES:
        phase_grads_card_vs_cpu(arch)
    mark("card vs cpu")
    for arch in FAMILIES:
        cfg = get_config(arch)
        if FAMILY_TRAIN_LAYERS[arch]:
            cfg = dataclasses.replace(cfg, n_layers=FAMILY_TRAIN_LAYERS[arch])
        paths[f"train {arch}"] = phase_train(arch, flash_checked, flash_grad_checked, set(), set(),
                                             set(), cfg=cfg, phase=9)
    mark("train")
    paths.update(sessions)
    for name in (MLA, f"sessions {MLA}", f"train {MLA}"):
        if paths[name] != none:
            raise SystemExit(f"minicpm3's MLA path {name} launched kernels: {paths[name]}")
    made = {name: {k: n for k, n in p.items() if n} for name, p in paths.items()}
    log(f"phase 9 families: {', '.join(FAMILIES)} in {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{what} {w:.1f} s" for what, w in walls) + f"); launches by path {made}")
    return paths


def _greedy_run(model, params, toks, lens, capacity, steps, extra: dict):
    """Prefill right-padded prompts in one batch -- or, for a stack with SSM
    layers, whose state would run through the padding, each row alone at its
    exact length, as the engines do -- then ``steps`` ragged greedy decode
    steps; returns (tokens [B, steps + 1], logits of every step).  ``extra``
    holds the batch's frontend rows or encoder frames (none for a model that
    takes neither)."""
    dev = model.device
    true_len = torch.as_tensor(lens, device=dev)
    if layer_kinds(model.cfg)[2]:  # each row re-laid alone, as KVPool.write installs it
        rows = []
        for i, n in enumerate(lens):
            lg, c = model.prefill(params, torch.as_tensor(toks[i:i + 1, :n], device=dev))
            rows.append((lg, model.prepare_decode_caches(model.mask_prompt_cache(c, n), capacity)))
        logits = torch.cat([r[0] for r in rows])
        caches = {k: torch.cat([r[1][k] for r in rows], dim=1) for k in rows[0][1]}
    else:
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 **{k: torch.as_tensor(v, device=dev) for k, v in extra.items()}}
        logits, caches = model.prefill(params, batch, last_pos=true_len - 1)
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


def hybrid_cut():
    """jamba at full widths cut to 2 layers, one of each kind: layer 0
    Mamba-2 with a dense FFN, layer 1 attention with MoE (3.675 B
    parameters)."""
    cfg = get_config(HYBRID)
    return dataclasses.replace(cfg, n_layers=2, attn_period=2, attn_offset=1,
                               moe=dataclasses.replace(cfg.moe, layer_period=2, layer_offset=1))


def hybrid_cpu_cut():
    """The hybrid's cut for the card-vs-CPU train run: ``hybrid_cut`` with
    ``TRAIN_CPU_HYBRID_EXPERTS`` of its 16 experts (top-2 kept), every width
    kept."""
    cfg = hybrid_cut()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=TRAIN_CPU_HYBRID_EXPERTS))


def layer_list(cfg) -> str:
    """Each layer's mixer and FFN, for the logs."""
    enc = (f"{cfg.n_encoder_layers} encoder layers (attn + dense FFN), " if cfg.enc_dec else "")
    return enc + ", ".join(f"layer {i} {tf.mixer_kind(cfg, i)}"
                           + (" + cross" if cfg.enc_dec else "") + " + "
                           + ("MoE" if cfg.layer_is_moe(i) else "dense FFN" if cfg.d_ff
                              else "no FFN") for i in range(cfg.n_layers))


def host_init(cfg, seed: int = 0) -> dict:
    """``Model.init`` of ``cfg`` drawn on the card from ``seed`` and copied to
    the host: the card's generator draws jamba's 3.675 B parameters in well
    under a second, the CPU's in tens of seconds."""
    params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(seed))
    return tree_map(lambda t: t.cpu(), params)


def two_layers(cfg):
    """``cfg`` cut to 2 layers (an encoder-decoder to 2 + 2) in fp32."""
    cut = dict(n_layers=2, compute_dtype="float32")
    if cfg.enc_dec:
        cut["n_encoder_layers"] = 2
    return dataclasses.replace(cfg, **cut)


def phase_card_vs_cpu(arch: str, steps: int = 8, cfg=None, phase: int = 5) -> None:
    """``arch`` (or the config ``cfg``) cut to 2 layers in fp32, from the
    same params on the card and the CPU: prefill (with frontend rows or
    encoder frames where the config takes them), then ``steps`` ragged
    greedy decode steps; equal greedy tokens, logits within
    ``FP32_LOGITS_BOUND``."""
    cfg = two_layers(cfg or get_config(arch))
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = host_init(cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    kinds = layer_list(cfg)
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    lens = np.array([100, 77])
    toks = rng.integers(1, cfg.vocab, (2, 128))
    toks[1, lens[1]:] = 0
    extra = family_inputs(cfg, 2, 128)
    before = _launches()
    t_gpu, l_gpu = _greedy_run(gpu_model, gpu_model.load(params), toks, lens, 144, steps, extra)
    made = {k: n - before[k] for k, n in _launches().items()}
    prefills = len(lens) if layer_kinds(cfg)[2] else 1
    if made != expected_launches(cfg, prefills, steps):
        raise SystemExit(f"the card's run did not go through the kernels: launches {made}")
    t0 = time.perf_counter()
    t_cpu, l_cpu = _greedy_run(cpu_model, cpu_model.load(params), toks, lens, 144, steps, extra)
    cpu_s = time.perf_counter() - t0
    gap = (l_gpu - l_cpu).abs().max().item()
    same = torch.equal(t_gpu, t_cpu)
    inputs = "".join(f", {k} {tuple(v.shape)}" for k, v in extra.items())
    log(f"phase {phase} card vs cpu ({cfg.name} 2 layers fp32: {kinds}{inputs}; "
        f"{n_params / 1e9:.3f} B params, "
        f"initialised on the card and copied to the cpu in {t_init:.1f} s; prompts {lens[0]} and "
        f"{lens[1]}, prefill + "
        f"{steps} decode steps, {cpu_s:.1f} s on the cpu): greedy tokens "
        f"{'equal' if same else 'DIFFER'}, max logit gap {gap:.3e} (bound "
        f"{FP32_LOGITS_BOUND:g}); card launches {made}")
    if not same or gap > FP32_LOGITS_BOUND:
        raise SystemExit("card and CPU disagree")


def _flash_grads(shape: Shape, q, k, v, cot, plain: bool):
    """dq, dk, dv of ``sum(attention(q, k, v) * cot)``: through the port's
    autograd function (the forward and backward kernels), or with ``plain``
    through autograd of the plain version."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    attend = reference_attention if plain else fa_ops.flash_attention
    out = attend(*leaves, causal=shape.causal, window=shape.window)
    return torch.autograd.grad(out, leaves, cot)


def flash_grad_shapes() -> list[Shape]:
    """Phase 6's backward shapes: the train shapes of internlm2 (D 128),
    granite (D 64) and jamba (H 32 over KV 8, D 128) first, then a windowed
    shape (window < S), qwen3-32b's
    group of 8 query heads per kv head, a ragged S (a short last tile of
    each kernel), S of 1, non-causal shapes, every head dim at a small shape,
    fused-qkv views, and the card-vs-CPU train shapes in fp32; then phase
    9's train shapes (phi-3-vision's H 32 over KV 32 of 96, seamless's
    decoder H 16 over KV 16 of 64) in bf16 and fp32."""
    bf16 = torch.bfloat16
    cfg = get_config("qwen3-32b")
    return ([train_shape(), train_shape(arch=MOE), train_shape(arch=HYBRID),
             Shape(2, 512, 16, 8, 128, bf16, window=128),
             Shape(1, 512, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, bf16),
             Shape(2, 200, 16, 8, 128, bf16), Shape(2, 1, 16, 8, 64, bf16),
             Shape(1, 256, 16, 8, 128, bf16, causal=False),
             Shape(2, 129, 16, 8, 64, bf16, causal=False, window=50)]
            + [Shape(2, 200, 4, 2, d, dt) for dt in (bf16, torch.float32)
               for d in fa_kernel.HEAD_DIMS]
            + [Shape(2, 333, 16, 8, 128, bf16, fused=True),
               Shape(1, 129, 32, 8, 80, torch.float32, window=64, fused=True)]
            + [train_shape(torch.float32, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, arch)
               for arch in (DENSE, MOE, HYBRID)]
            + [train_shape(dt, b, s, arch) for arch in (VLM, ENCDEC)
               for dt, b, s in ((bf16, TRAIN_BATCH, TRAIN_SEQ),
                                (torch.float32, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ))])


def phase_check_flash_grads() -> tuple[float, set[Shape]]:
    """Flash attention's backward kernel on the card, through the autograd
    function (one forward and one backward launch), against the plain
    ``attention_backward`` (from the plain forward's o and lse) and against
    autograd through the plain ``reference_attention``, on the same inputs,
    within ``FLASH_GRAD_TOL``; and the forward kernel's logsumexp rows
    against ``attention_forward``'s within ``LSE_TOL``.  Returns the max
    error against ``attention_backward`` at internlm2's train shape and the
    shapes checked."""
    main, main_err = train_shape(), 0.0
    shapes = flash_grad_shapes()
    for shape in shapes:
        q, k, v = shape.inputs(seed=3)
        cot = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(4),
                          device="cuda").to(shape.dtype)
        before = (fa_kernel.launches, fa_kernel.bwd_launches)
        got = _flash_grads(shape, q, k, v, cot, plain=False)
        torch.cuda.synchronize()
        made = (fa_kernel.launches - before[0], fa_kernel.bwd_launches - before[1])
        if made != (1, 1) or any(g.dtype != shape.dtype for g in got):
            raise SystemExit(f"flash_attention backward at {shape}: {made} (forward, backward) "
                             f"launches, dtypes {[g.dtype for g in got]}")
        mask = dict(causal=shape.causal, window=shape.window)
        _, lse = fa_ops._forward(q, k, v, shape.causal, shape.window, True)
        o_plain, lse_plain = attention_forward(q, k, v, **mask)
        _check("flash_attention lse", shape, lse, lse_plain, LSE_TOL, phase=6)
        plain = attention_backward(q, k, v, o_plain, lse_plain, cot, **mask)
        tol = FLASH_GRAD_TOL[shape.dtype]
        err = _check("flash_attention_bwd dq/dk/dv vs attention_backward", shape, tuple(got),
                     plain, tol, phase=6)
        want = _flash_grads(shape, q, k, v, cot, plain=True)
        _check("flash_attention_bwd dq/dk/dv vs autograd through reference_attention", shape,
               tuple(got), tuple(want), tol, phase=6)
        if shape == main:
            main_err = err
        del q, k, v, cot, got, plain, want, lse, lse_plain, o_plain
        torch.cuda.empty_cache()
    return main_err, set(shapes)


def _grads(fn, inputs, cot):
    """Gradients of ``sum(fn(*inputs) * cot)`` with respect to every input."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def _ffn(params_fn):
    """An expert FFN as a function of (buckets, w_gate, w_up, w_down)."""
    return lambda bk, wg, wu, wd: params_fn({"w_gate": wg, "w_up": wu, "w_down": wd}, bk)


def phase_check_gmm_grads() -> None:
    """The grouped matmul's and the expert FFN's gradients on the card, every
    product through the kernel, against autograd through their plain versions
    on the same inputs: at granite's train shapes in bf16 (C 640) and its
    card-vs-CPU ones in fp32 (C 80).  The backward's launches must get the
    transposed operands as they are, views of the stored tensors (dx's w^T,
    dw's x^T), never contiguous copies."""
    seen = []  # (a contiguous, b contiguous) of every launch
    launch = gmm_kernel.launch
    gmm_kernel.launch = lambda a, b, out: seen.append(
        (a.is_contiguous(), b.is_contiguous())) or launch(a, b, out)
    try:
        for dt, b, s in ((torch.bfloat16, TRAIN_BATCH, TRAIN_SEQ),
                         (torch.float32, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ)):
            gen = torch.Generator(device="cuda").manual_seed(6)
            for shape in expert_shapes(capacity(get_config(MOE), b * s), dt):
                x, w = shape.inputs(seed=5)
                cot = torch.randn(shape.e, shape.c, shape.f, generator=gen, device="cuda").to(dt)
                seen.clear()
                got = _grads(gmm_ops.gmm, (x, w), cot)
                torch.cuda.synchronize()
                if seen != [(True, True), (True, False), (False, True)]:
                    raise SystemExit(f"gmm at {shape}: launches (a, b contiguous) {seen}, want "
                                     "the forward, then dx with w^T and dw with x^T in place")
                want = _grads(reference_grouped_matmul, (x, w), cot)
                _check("moe_gmm gmm dx/dw", f"{shape} (3 launches, transposes in place)",
                       tuple(got), tuple(want), GMM_TOL[dt], phase=6)
            up = expert_shapes(capacity(get_config(MOE), b * s), dt)[0]
            e, c, d, f = up.e, up.c, up.d, up.f
            ffn_inputs = [torch.randn(e, c, d, generator=gen, device="cuda").to(dt)] + [
                (torch.randn(e, i, o, generator=gen, device="cuda") * i**-0.5).to(dt)
                for i, o in ((d, f), (d, f), (f, d))]
            cot = torch.randn(e, c, d, generator=gen, device="cuda").to(dt)
            seen.clear()
            got = _grads(_ffn(gmm_ops.expert_ffn), ffn_inputs, cot)
            torch.cuda.synchronize()
            if len(seen) != 9:
                raise SystemExit(f"expert_ffn launched the kernel {len(seen)} times, want 9")
            want = _grads(_ffn(reference_expert_ffn), ffn_inputs, cot)
            _check("moe_gmm expert_ffn d(buckets, w_gate, w_up, w_down)",
                   f"{_dt(dt)} E{e} C{c} D{d} F{f} (9 launches)", tuple(got), tuple(want),
                   FFN_GRAD_TOL[dt], phase=6)
    finally:
        gmm_kernel.launch = launch


def phase_time_flash_backward() -> dict:
    """At the train shapes of internlm2, granite, jamba, phi-3-vision and
    seamless's decoder: the forward
    kernel, without and with its logsumexp rows (as training runs it),
    beside SDPA's forward, and the backward kernel (autograd's backward of
    ``ops.flash_attention``: its scratch, outputs and one launch: the
    pre-pass and the grid of dK/dV and dQ blocks behind it) beside the
    plain ``attention_backward``, the recompute it
    replaced (autograd through ``reference_attention``, forward included, as
    the port's backward ran before) and SDPA's backward, each with its
    bound (``Shape.bound``, ``Shape.bwd_bound``).  Returns internlm2's
    backward row."""
    rows = []
    for arch in (DENSE, MOE, HYBRID, VLM, ENCDEC):
        shape = train_shape(arch=arch)
        q, k, v = (t.detach().requires_grad_() for t in shape.inputs(seed=1))
        cot = torch.randn(q.shape, device="cuda", dtype=shape.dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
        fwd = lambda: fa_ops.flash_attention(q, k, v, causal=True)  # noqa: E731
        with torch.no_grad():
            ms, lib_ms = cuda_ms(fwd, iters=20), cuda_ms(sdpa, iters=20)
            lse_ms = cuda_ms(lambda: fa_ops._forward(q, k, v, True, 0, True), iters=20)
            o_plain, lse_plain = attention_forward(q, k, v, causal=True)
            plain_ms = cuda_ms(lambda: attention_backward(q, k, v, o_plain, lse_plain, cot,
                                                          causal=True), iters=10, warmup=1)
        out, out_s = fwd(), sdpa()
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), cot, retain_graph=True),
                         iters=20)
        recompute_ms = cuda_ms(lambda: torch.autograd.grad(
            reference_attention(q, k, v, causal=True), (q, k, v), cot), iters=10, warmup=1)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out_s, (q, k, v), cot.transpose(1, 2),
                                                         retain_graph=True), iters=20)
        bound_ms, bound_by = shape.bound()
        bwd_bound, bwd_by = shape.bwd_bound()
        log(f"phase 6 time flash_attention {shape} forward: kernel {ms:.4f} ms (with its "
            f"logsumexp rows {lse_ms:.4f} ms), library (sdpa) {lib_ms:.4f} ms, kernel/library "
            f"{ms / lib_ms:.2f} ({lse_ms / lib_ms:.2f} with the rows), bound {bound_ms:.4f} ms "
            f"({bound_by})")
        log(f"phase 6 time flash_attention_bwd {shape}: kernel {bwd_ms:.4f} ms, plain "
            f"(attention_backward) {plain_ms:.4f} ms, recompute (autograd through "
            f"reference_attention) {recompute_ms:.4f} ms, library (sdpa backward) "
            f"{lib_bwd_ms:.4f} ms, kernel/library {bwd_ms / lib_bwd_ms:.2f}, bound "
            f"{bwd_bound:.4f} ms ({bwd_by}); kernel at {100 * bwd_bound / bwd_ms:.1f}% of bound")
        rows.append(dict(shape=str(shape), ms=bwd_ms, plain_ms=plain_ms, library_ms=lib_bwd_ms,
                         bound_ms=bwd_bound, bound_by=bwd_by))
        del q, k, v, cot, qt, kt, vt, out, out_s, o_plain, lse_plain
        torch.cuda.empty_cache()
    return rows[0]


KERNEL_CLASSES = (("flash_attention", ("flash_fwd",)), ("flash_attention_bwd", ("flash_bwd",)),
                  ("moe_gmm", ("gmm_bf16", "gmm_f32")),
                  ("ssd_scan", ("ssd_fwd",)), ("ssd_scan_bwd", ("ssd_bwd",)),
                  ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
                  ("elementwise", ("elementwise",)), ("reduction", ("reduce",)))


def _kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")


def profile_train_step(model, params, opt, opt_cfg, batch) -> str:
    """One train step under torch.profiler, as ``Trainer.step`` runs it
    (``value_and_grads``, then ``adamw_update``), with CUDA events around the
    update: the step's wall, its device busy time and share, the device time
    by kernel class and the update's span on the device; and the host
    seconds the profile took, its summary included."""
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        grads, _ = value_and_grads(model, params, batch)
        start.record()
        adamw_update(params, grads, opt, opt_cfg, model.decay_mask(params))
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return "the profiler saw no device time (not measured)"
    by_class = {}
    for e in events:
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return (f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% "
            f"(idle {100 - 100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events)} kernels; "
            f"adamw_update spans {start.elapsed_time(end):.1f} ms on the device; device ms by "
            "kernel: " + ", ".join(f"{c} {ms:.1f} ({100 * ms / busy_ms:.1f}%)" for c, ms in
                                   sorted(by_class.items(), key=lambda kv: -kv[1]))
            + "; top kernels: " + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.1f} ms "
                                            f"x{e.count}" for e in top)
            + f"; profiled and summarised in {time.perf_counter() - t_prof:.1f} s (host clock)")


def _train_opt(steps: int, lr: float) -> AdamWConfig:
    """The train launcher's optimizer for a run of ``steps`` steps."""
    return AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)


def train_launches(cfg, passes: int) -> dict:
    """Launches of ``passes`` gradient passes (one per train step): with
    remat, flash attention twice per attention layer (forward and
    recompute) and its backward once; the grouped matmul 12 times per MoE
    layer (three products forward, three recomputed, and the dx and dw of
    each); the SSD scan twice per SSM layer (forward and recompute) and its
    backward once, on the wgmma route where ``bwd_route`` sends the model's
    compute dtype and shape (bf16 mamba2: every launch; fp32: none)."""
    n_attn, n_moe, n_ssm = layer_kinds(cfg)
    fwd = 2 if cfg.remat else 1
    wgmma = n_ssm and ssd_kernel.bwd_route(
        getattr(torch, cfg.compute_dtype), cfg.ssm.head_dim, cfg.ssm.state_dim) == "wgmma"
    return {"flash_attention": fwd * n_attn * passes, "flash_attention_bwd": n_attn * passes,
            "moe_gmm": (3 * fwd + 6) * n_moe * passes,
            "ssd_scan": fwd * n_ssm * passes, "ssd_scan_bwd": n_ssm * passes,
            "ssd_scan_bwd_wgmma": n_ssm * passes if wgmma else 0}


def phase_train(arch: str, flash_checked: set[Shape], flash_grad_checked: set[Shape],
                gmm_checked: set[GmmShape], ssd_checked: set[SsdShape],
                ssd_grad_checked: set[SsdShape], cfg=None, phase: int = 6) -> dict:
    """``arch`` at full width (``cfg`` where given: a cut of its depth)
    trained ``TRAIN_STEPS`` steps through ``Trainer``, each
    batch with the frontend rows or encoder frames its config takes
    (``family_inputs``); returns the launches
    the run made by kernel.  Fails unless every kernel ran as often as
    ``train_launches`` says, at shapes phases 2 and 6 checked (the
    backwards' too), the loss is finite and falls, every parameter gets a
    finite, non-zero gradient and two gradient passes of one batch are
    bit-identical (the first pass's gradients wait on the host: the
    hybrid's cut has no room for two sets on the card); for an MoE model
    also unless its load-balancing loss is finite and positive."""
    cfg = cfg or get_config(arch)
    full_n = get_config(arch).n_layers
    cut = cfg.n_layers != full_n
    layers = (f"{cfg.n_layers} layers" + (f" (cut from {full_n})" if cut else "")
              + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.enc_dec else ""))
    model = build_model(cfg)
    trainer = Trainer(model, _train_opt(TRAIN_STEPS, TRAIN_LR))
    t0 = time.perf_counter()
    params, opt = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"phase {phase} init: {cfg.name} {layers}, {n_params / 1e9:.3f} B params (fp32 master, "
        f"{cfg.compute_dtype} compute) on {model.device} in {time.perf_counter() - t0:.1f} s"
        + (f" ({layer_list(cfg)})" if cut else "") + f"; params and AdamW moments "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    batches = [{**pipe.global_batch_arrays(i), **family_inputs(cfg, TRAIN_BATCH, TRAIN_SEQ, i)}
               for i in range(TRAIN_STEPS + 1)]
    n_attn, n_moe, n_ssm = layer_kinds(cfg)
    moe = n_moe > 0
    if moe:
        with torch.no_grad():
            aux0 = float(model.train_loss(params, batches[0])[1]["aux_loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    walls, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = trainer.step(params, opt, batches[i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    want = train_launches(cfg, TRAIN_STEPS)
    if launches != want:
        raise SystemExit(f"{cfg.name} training: launches {launches}, want {want}")
    if n_attn and not (train_shape(arch=arch) in flash_checked
                       and train_shape(arch=arch) in flash_grad_checked):
        raise SystemExit(f"training launched flash_attention (forward and backward) at "
                         f"{train_shape(arch=arch)}, which phases 2 and 6 did not check in both "
                         "directions")
    ssd_train = train_ssd_shapes(arch)[0] if n_ssm else None
    if n_ssm and not (ssd_train in ssd_checked and ssd_train in ssd_grad_checked):
        raise SystemExit(f"training launched ssd_scan (forward and backward) at {ssd_train}, "
                         "which phase 2 did not check in both directions")
    if moe and not set(train_gmm_shapes(arch=arch)) <= gmm_checked:
        raise SystemExit("training launched moe_gmm at shapes phase 2 did not check: "
                         + ", ".join(map(str, set(train_gmm_shapes(arch=arch)) - gmm_checked)))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"{cfg.name} training: loss not finite or not falling: {losses}")
    grads, _ = value_and_grads(model, params, batches[0])
    n_leaves = len(tree_leaves(grads))
    bad = sum(not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))
              for g in tree_leaves(grads))
    if bad:
        raise SystemExit(f"{bad} of {n_leaves} parameter leaves got a zero or non-finite "
                         "gradient")
    first = [g.cpu() for g in tree_leaves(grads)]
    del grads
    median = float(np.median(walls))
    inputs = "".join(f", {k} {v.shape}" for k, v in family_inputs(cfg, TRAIN_BATCH,
                                                                   TRAIN_SEQ).items())
    log(f"phase {phase} train {cfg.name} full width, {layers}, B{TRAIN_BATCH} S{TRAIN_SEQ}"
        f"{inputs}, {TRAIN_STEPS} steps: "
        f"loss " + " ".join(f"{x:.4f}" for x in losses) + " (finite, falling) ok; gnorm "
        + " ".join(f"{x:.3f}" for x in gnorms))
    # the same batch again: the flash backward's sums over query tiles and
    # heads, the MoE backward's gathers and products (models/moe.py) and the
    # SSD backward's sums over heads and chunks must repeat bit for bit
    again, _ = value_and_grads(model, params, batches[0])
    same = all(torch.equal(a, b.cpu()) for a, b in zip(first, tree_leaves(again)))
    del again, first
    if not same:
        raise SystemExit(f"{cfg.name}: two gradient passes of batch 0 differ")
    log(f"phase {phase} train {cfg.name}: two gradient passes of batch 0 bit-identical ok")
    if moe:
        with torch.no_grad():
            aux = float(model.train_loss(params, batches[0])[1]["aux_loss"])
        log(f"phase {phase} train {cfg.name}: load-balancing loss (summed over {n_moe} MoE "
            f"layers, batch 0) {aux0:.6f} at init, {aux:.6f} after {TRAIN_STEPS} steps "
            f"{'ok' if math.isfinite(aux) and aux > 0 else 'FAIL'}")
        if not (math.isfinite(aux) and aux > 0):
            raise SystemExit(f"{cfg.name}: a bad aux loss {aux}")
    per_step = {k: n // TRAIN_STEPS for k, n in launches.items() if n}
    log(f"phase {phase} train {cfg.name}: step wall median {1e3 * median:.1f} ms (min "
        f"{1e3 * min(walls):.1f}, max {1e3 * max(walls):.1f}; host clock, ends in a sync), "
        f"{TRAIN_BATCH * TRAIN_SEQ / median:.0f} tokens/s, max_memory_allocated {peak_gb:.2f} GiB; "
        f"launches {launches} ({per_step} per step); every one of the {n_leaves} parameter "
        f"leaves has a finite, non-zero gradient ok")
    log(f"phase {phase} train {cfg.name} step profile: "
        + profile_train_step(model, params, opt, trainer.opt_cfg, batches[TRAIN_STEPS]))
    del params, opt, trainer, model
    torch.cuda.empty_cache()
    return launches


def session_flash_shapes() -> list[Shape]:
    """The flash kernel's shapes in phase 8's fp32 internlm2 runs: prefill
    groups of 1 to 4 rows at every bucket, the prompts' and the cold
    resumes' histories (16 tokens longer) among them."""
    return [dataclasses.replace(main_shape(g, b, DENSE), dtype=torch.float32)
            for g in MAIN_ROWS for b in MAIN_BUCKETS]


def _two_turns(engine, prompts) -> tuple[list, list, int, int]:
    """Phase 8's session schedule on ``engine``: every prompt a session of
    ``SESSION_TURN`` new tokens, run; then every history resubmitted for
    ``SESSION_TURN`` more, run; ``pool.check()`` after each turn.  Returns
    (each session's two turns, the second turn's wall, its prefill groups,
    the rows they prefilled)."""
    rids = [engine.submit(p, SESSION_TURN, session_id=i) for i, p in enumerate(prompts)]
    out = engine.run()
    first = [out[r] for r in rids]
    engine.pool.check()
    groups = len(engine.metrics.prefill_walls)
    t0 = time.perf_counter()
    rids = [engine.submit(np.concatenate([p, f]), SESSION_TURN, session_id=i)
            for i, (p, f) in enumerate(zip(prompts, first))]
    out = engine.run()
    wall = time.perf_counter() - t0
    engine.pool.check()
    later = engine.metrics.prefill_walls[groups:]
    return ([(f, out[r]) for f, r in zip(first, rids)], wall, len(later),
            sum(g for g, _, _ in later))


def _tier_figures(ob, nbytes: int, smi: str) -> str:
    """The calibration ledger's tier_transfer (demote, hbm->host) and
    wakeup (promote) records: counts, predicted and observed seconds, the
    observed wall per row and its GB/s."""
    parts = []
    for kind, what in (("tier_transfer", "demote"), ("wakeup", "promote")):
        recs = [r for r in ob.calibration.records if r.kind == kind]
        pred = sum(r.predicted_s for r in recs)
        seen = [r.observed_s for r in recs]
        per = float(np.median(seen))
        parts.append(f"{what} ({kind}) x{len(recs)}: predicted {1e3 * pred:.3f} ms, observed "
                     f"{1e3 * sum(seen):.3f} ms, median {1e3 * per:.3f} ms a row = "
                     f"{nbytes / per / 1e9:.2f} GB/s")
    return "; ".join(parts) + f" [{smi}]"


def _span_counts(ob) -> dict:
    counts = {}
    for e in ob.tracer.events:
        key = e["name"] if e["ph"] == "X" else f"{e['name']} instant"
        counts[key] = counts.get(key, 0) + 1
    return counts


def time_wire_format(model, slots: int = N_SLOTS, reps: int = 3) -> str:
    """``extract_all`` of ``slots`` rows against as many ``extract`` calls,
    and ``insert_all`` against as many ``insert`` calls, on a pool of the
    session runs' capacity (medians of ``reps``, host clock; each ends in
    its copy or a sync); the batched rows must equal the single ones."""
    pool = KVPool(model, slots, SESSION_CAPACITY)
    ids = [pool.allocate(r) for r in range(slots)]
    for t in pool.caches.values():
        t.copy_(torch.arange(t.numel(), device=t.device).reshape(t.shape).to(t.dtype))

    def timed(fn):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)), out

    all_s, rows = timed(lambda: pool.extract_all(ids))
    one_s, singles = timed(lambda: [pool.extract(s) for s in ids])
    same = all(np.array_equal(a[n], b[n]) for a, b in zip(rows, singles) for n in a)
    ins_all_s, _ = timed(lambda: pool.insert_all(ids, rows))
    ins_one_s, _ = timed(lambda: [pool.insert(s, r) for s, r in zip(ids, rows)])
    nbytes = slots * sum(leaf.nbytes for leaf in rows[0].values())
    if not same:
        raise SystemExit(f"{model.cfg.name}: extract_all disagrees with extract")
    del pool
    torch.cuda.empty_cache()
    return (f"extract_all of {slots} rows {1e3 * all_s:.2f} ms ({nbytes / all_s / 1e9:.2f} GB/s) "
            f"against {slots} extract calls {1e3 * one_s:.2f} ms ({nbytes / one_s / 1e9:.2f} "
            f"GB/s), rows equal; insert_all {1e3 * ins_all_s:.2f} ms "
            f"({nbytes / ins_all_s / 1e9:.2f} GB/s) against {slots} insert calls "
            f"{1e3 * ins_one_s:.2f} ms ({nbytes / ins_one_s / 1e9:.2f} GB/s)")


def phase_sessions(arch: str, model, params, flash_checked: set[Shape],
                   gmm_checked: set[GmmShape], ssd_checked: set[SsdShape],
                   phase: int = 8) -> dict:
    """Phase 8, multi-turn sessions through the tiered KV pool at full width
    on phase 4's bf16 weights of ``arch``, on the served traffic (8 prompts,
    greedy), each run held against a never-demoted run of the same prompts
    for ``NEW_TOKENS`` tokens on as many slots.  internlm2-1.8b on 4 slots:
    run 1 in bf16 with 4 host and 4 pooled sessions (the second turn wakes 4
    sessions from host and refills 4 from pooled, with no prefill), run 2 in
    fp32 (weights built again from the same seed) with no tier capacity
    (every session dropped, its history re-prefilled cold through the fp32
    flash route).  jamba on 1 slot, so that no two rows share an expert's
    capacity, with 4 host and 4 pooled sessions in bf16.  Phase 9 runs
    minicpm3-4b's bf16 run alone, on 4 slots.  Streams must be
    equal bit for bit; the launches those of the engines' prefills and
    decode steps (a wakeup launches nothing), at shapes phase 2 checked.
    Returns the launches of the phase's runs."""
    cfg = model.cfg
    smi = _smi()
    lens, prompts, _ = traffic(cfg.vocab)
    hybrid = arch == HYBRID
    slots = 1 if hybrid else N_SLOTS
    runs = [("bf16", model, params, TierConfig(host_sessions=4, pooled_sessions=4))]
    if arch == DENSE:
        runs.append(("fp32", None, None, TierConfig(host_sessions=0, pooled_sessions=0)))
    # (prefills, decode steps) of every engine, and every prefill's length
    counts, lengths, flash_groups = [], set(), set()
    _reset_launches()
    t_phase = time.perf_counter()
    for label, m, p, tiers in runs:
        if m is None:
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
            m = build_model(cfg32)
            p = init_loaded(m)
        ref = ContinuousBatchingEngine(m, p, n_slots=slots, max_len=SESSION_CAPACITY)
        t0 = time.perf_counter()
        full = ref.generate(prompts, NEW_TOKENS)
        ref_s = time.perf_counter() - t0
        ob = Obs()
        eng = ContinuousBatchingEngine(m, p, n_slots=slots, max_len=SESSION_CAPACITY,
                                       tiers=tiers, obs=ob)
        t0 = time.perf_counter()
        turns, wake_s, groups2, rows2 = _two_turns(eng, prompts)
        tiered_s = time.perf_counter() - t0
        for e in (ref, eng):
            counts.append((e.metrics.prefills, e.metrics.decode_steps))
            lengths |= {b for _, b, _ in e.metrics.prefill_walls}
            flash_groups |= {dataclasses.replace(main_shape(g, b, arch), dtype=m.compute_dtype)
                             for g, b, _ in e.metrics.prefill_walls}
        pool, mt = eng.pool, eng.metrics
        equal = all(np.array_equal(np.concatenate(t), f) for t, f in zip(turns, full))
        n = len(prompts)
        cold = tiers.host_sessions + tiers.pooled_sessions == 0
        # (wakeups, cold resumes, refills, rows re-prefilled in turn 2, drops:
        # every demotion of both turns when no tier holds a row)
        want = ((0, n, 0, n, 2 * n) if cold
                else (n, 0, min(n - tiers.host_sessions, tiers.pooled_sessions), 0, 0))
        got = (mt.wakeups, mt.cold_resumes, pool.n_refill, rows2, pool.n_drop)
        spans = _span_counts(ob)
        spans_ok = (spans.get("prefill", 0) == mt.prefills
                    and spans.get("decode", 0) == mt.decode_steps
                    and spans.get("wakeup", 0) == mt.wakeups
                    and spans.get("demote instant", 0) == mt.demotions == 2 * n)
        ok = equal and got == want and spans_ok and mt.demotions == pool.n_demote
        leaf_bytes = {nm: nb for nm, _, nb, _ in pool._layout}
        nbytes = sum(leaf_bytes.values())
        log(f"phase {phase} sessions {cfg.name} {label} ({cfg.n_layers} layers, {slots} slot"
            f"{'s' if slots > 1 else ''}, {tiers}): {n} sessions x 2 turns of {SESSION_TURN} "
            f"tokens against a never-demoted run of {NEW_TOKENS} ({ref_s:.2f} s); tiered "
            f"{tiered_s:.2f} s, turn 2 {wake_s:.2f} s; wakeups {mt.wakeups}, refills "
            f"{pool.n_refill}, cold resumes {mt.cold_resumes} ({rows2} rows re-prefilled in "
            f"{groups2} groups), drops {pool.n_drop}, spills {pool.n_spill}, demotions "
            f"{mt.demotions}; modeled_tier_s {pool.modeled_tier_s:.6f}; streams "
            f"{'bit-identical' if equal else 'DIFFER'} {'ok' if ok else 'FAIL'}")
        log(f"phase {phase} {cfg.name} {label} spans: {spans} (prefill groups {mt.prefills}, "
            "decode "
            f"steps {mt.decode_steps})")
        if not cold:
            log(f"phase {phase} {cfg.name} {label} row {nbytes / 1e6:.3f} MB ("
                + ", ".join(f"{nm} {nb / 1e6:.3f}" for nm, nb in leaf_bytes.items())
                + f" MB); {_tier_figures(ob, nbytes, smi)}")
        else:
            recs = [r for r in ob.calibration.records if r.kind == "cold_prefill"]
            log(f"phase {phase} {cfg.name} {label} cold_prefill x{len(recs)}: predicted "
                f"{1e3 * sum(r.predicted_s for r in recs):.3f} ms, observed "
                f"{1e3 * sum(r.observed_s for r in recs):.3f} ms [{smi}]")
        if not ok:
            raise SystemExit(f"{cfg.name} {label} sessions: streams equal {equal}, (wakeups, "
                             f"cold resumes, refills, rows re-prefilled, drops) {got} want "
                             f"{want}, spans {spans}")
        del ref, eng, m, p
    launches = _launches()
    want = {k: sum(expected_launches(cfg, *c)[k] for c in counts) for k in launches}
    if launches != want:
        raise SystemExit(f"{cfg.name} sessions: launches {launches}, want {want}")
    n_attn, n_moe, n_ssm = layer_kinds(cfg)
    if n_attn and not flash_groups <= flash_checked:
        raise SystemExit("the sessions path launched flash_attention at shapes phase 2 did not "
                         f"check: {', '.join(map(str, flash_groups - flash_checked))}")
    if hybrid:
        if not lengths <= {int(x) for x in lens}:
            raise SystemExit(f"{cfg.name} sessions: prefills at lengths {sorted(lengths)}")
        tokens = list(lengths) + [slots]
        served_gmm = {s for t in tokens for s in expert_shapes(capacity(cfg, t), arch=arch)}
        served_ssd = {ssm_shape(1, b, arch=arch) for b in lengths}
        if not served_gmm <= gmm_checked or not served_ssd <= ssd_checked:
            raise SystemExit(f"{cfg.name} sessions: gmm or ssd_scan shapes phase 2 did not check")
    log(f"phase {phase} {cfg.name} wire format: {time_wire_format(model)} [{smi}]")
    log(f"phase {phase} sessions {cfg.name}: launches {launches} (= the engines' prefills and "
        "decode "
        f"steps; none per wakeup) in {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return launches


def _host_gib(field: str = "MemAvailable") -> float:
    """A field of the host's /proc/meminfo, in GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(field + ":"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def grads_card_vs_cpu(cfg, init: dict, batch: dict) -> dict:
    """One gradient pass of ``batch`` through ``cfg`` from copies of
    ``init`` on the card and on the CPU: the largest gap of a leaf relative
    to that leaf's largest value (``g_rel``), the loss gap relative
    (``loss_rel``), the number of leaves, the card's launches and each
    device's seconds."""
    runs = []
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        params = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(), init)
        before = _launches()
        t0 = time.perf_counter()
        grads, m = value_and_grads(model, params, batch)
        runs.append(([g.cpu() for g in tree_leaves(grads)], float(m["loss"]),
                     {k: n - before[k] for k, n in _launches().items()}, time.perf_counter() - t0))
        del params, grads
    (g_gpu, l_gpu, n_gpu, s_gpu), (g_cpu, l_cpu, _, s_cpu) = runs
    return {"g_rel": max(((a - b).abs().max() / b.abs().max()).item()
                         for a, b in zip(g_gpu, g_cpu)),
            "loss": (l_gpu, l_cpu), "loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
            "leaves": len(g_gpu), "launches": n_gpu, "s": (s_gpu, s_cpu)}


def phase_train_card_vs_cpu(arch: str, cfg=None) -> None:
    """``arch`` (or ``cfg``) cut to 2 layers of full width, in fp32, from the
    same params on the card and on the CPU: the gradients of the first
    batch, each leaf within 1e-4 of its largest value (``grads_card_vs_cpu``);
    then ``TRAIN_CPU_STEPS`` Trainer steps on the same batches, losses within
    1e-4 relative and params within 1e-4."""
    full = get_config(arch)
    cfg = two_layers(cfg or full)
    cut = ""
    if cfg.moe and cfg.moe.n_experts != full.moe.n_experts:
        cut = (f"; {layer_list(cfg)}; experts cut from {full.moe.n_experts} to "
               f"{cfg.moe.n_experts} (top-{cfg.moe.top_k}) for the host's memory, every width "
               f"kept; host memory available {_host_gib():.1f} of {_host_gib('MemTotal'):.1f} GiB")
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_CPU_SEQ, global_batch=TRAIN_CPU_BATCH,
                       seed=0)
    batches = [pipe.global_batch_arrays(i) for i in range(TRAIN_CPU_STEPS)]
    # drawn on the CPU: the param bound below holds for this draw; a draw on
    # the card (host_init) left granite's params 1.15e-4 to 1.37e-4 apart in
    # two runs (PERF.md section 7), AdamW's steps of near-zero gradients
    # taking other signs on the two devices
    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(init))
    gr = grads_card_vs_cpu(cfg, init, batches[0])
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        trainer = Trainer(model, _train_opt(TRAIN_STEPS, TRAIN_CPU_LR))
        params = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(), init)
        opt = adamw_init(params, trainer.opt_cfg)
        before = _launches()
        t0 = time.perf_counter()
        losses = []
        for batch in batches:
            params, opt, m = trainer.step(params, opt, batch)
            losses.append(float(m["loss"]))
        made = {k: n - before[k] for k, n in _launches().items()}
        runs[dev] = (losses, [t.detach().cpu() for t in tree_leaves(params)], made,
                     time.perf_counter() - t0)
    (l_gpu, p_gpu, n_gpu, s_gpu), (l_cpu, p_cpu, n_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    gaps = [(a - b).abs() for a, b in zip(p_gpu, p_cpu)]
    p_gap = max(d.max().item() for d in gaps)
    over = sum(int((d > 1e-5).sum()) for d in gaps)
    n_gpu = {k: n + gr["launches"][k] for k, n in n_gpu.items()}
    want_launches = train_launches(cfg, TRAIN_CPU_STEPS + 1)  # + the gradient pass
    ok = (max(gr["g_rel"], gr["loss_rel"], loss_rel, p_gap) <= TRAIN_CPU_TOL
          and n_gpu == want_launches)
    log(f"phase 6 train card vs cpu ({cfg.name} 2 layers fp32, {n_params / 1e9:.3f} B params"
        f"{cut}; B{TRAIN_CPU_BATCH} S{TRAIN_CPU_SEQ}, lr {TRAIN_CPU_LR:g}): gradients of batch 0 "
        f"within {gr['g_rel']:.3e} of each leaf's largest value, its loss within "
        f"{gr['loss_rel']:.3e} relative; {TRAIN_CPU_STEPS} steps, losses card "
        + " ".join(f"{x:.6f}" for x in l_gpu) + " cpu " + " ".join(f"{x:.6f}" for x in l_cpu)
        + f", max loss gap {loss_rel:.3e} relative, max param gap {p_gap:.3e} ({over} of "
        f"{sum(d.numel() for d in gaps)} elements over 1e-5); bound {TRAIN_CPU_TOL:g}; card "
        f"launches {n_gpu} (want {want_launches}), cpu {n_cpu}; {gr['s'][0] + s_gpu:.1f} s card, "
        f"{gr['s'][1] + s_cpu:.1f} s cpu; host peak rss {_peak_rss_gib():.1f} GiB "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("training on the card and on the CPU disagree")


def phase_grads_card_vs_cpu(arch: str) -> None:
    """Phase 9's train check on the card against the CPU: ``arch`` cut to 2
    layers (an encoder-decoder to 2 + 2) of full width, in fp32, from the
    same params (drawn on the card, ``host_init``): one gradient pass over a
    batch with its frontend rows or encoder frames held to phase 6's rule
    (``grads_card_vs_cpu``); phase 6's AdamW steps are not repeated here."""
    cfg = two_layers(get_config(arch))
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_CPU_SEQ, global_batch=TRAIN_CPU_BATCH,
                       seed=0)
    batch = {**pipe.global_batch_arrays(0), **family_inputs(cfg, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ)}
    init = host_init(cfg)
    gr = grads_card_vs_cpu(cfg, init, batch)
    want = train_launches(cfg, 1)
    ok = max(gr["g_rel"], gr["loss_rel"]) <= TRAIN_CPU_TOL and gr["launches"] == want
    inputs = "".join(f", {k} {v.shape}" for k, v in batch.items() if k not in ("tokens", "targets"))
    log(f"phase 9 train card vs cpu ({cfg.name} {'2 + 2' if cfg.enc_dec else '2'} layers "
        f"fp32, {sum(t.numel() for t in tree_leaves(init)) / 1e9:.3f} B params; B{TRAIN_CPU_BATCH} "
        f"S{TRAIN_CPU_SEQ}{inputs}): loss card {gr['loss'][0]:.6f} cpu {gr['loss'][1]:.6f} "
        f"({gr['loss_rel']:.3e} relative), gradients of all {gr['leaves']} leaves within "
        f"{gr['g_rel']:.3e} of each leaf's largest value (bound {TRAIN_CPU_TOL:g}); card launches "
        f"{ {k: n for k, n in gr['launches'].items() if n} } "
        f"(want { {k: n for k, n in want.items() if n} }); "
        f"{gr['s'][0]:.1f} s card, {gr['s'][1]:.1f} s cpu {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{cfg.name}: gradients on the card and on the CPU disagree")


def _peak_rss_gib() -> float:
    """This process's peak resident memory on the host, in GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _bit_identical(a, b) -> bool:
    """Two trees of tensors and Python numbers, leaf for leaf."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else type(x) is type(y) and x == y
        for x, y in zip(la, lb))


def phase_checkpoint() -> dict:
    """Checkpoints and restarts on the card: granite-moe-1b-a400m cut to 2
    layers at full width (bf16 compute, fp32 master params and moments;
    flash and gmm forward and backward) trained ``CKPT_STEPS`` steps
    straight, then again from the same seed through ``run_with_restarts``
    with a checkpoint every ``CKPT_EVERY`` steps and one failure injected
    after step ``CKPT_FAIL_AT``'s update (after the step-2 checkpoint: the
    loop restores it and runs step 3 again).  The final params, moments,
    optimizer step and losses must equal the straight run's bit for bit and
    the restarted run's launches those of ``CKPT_STEPS`` + 1 steps.  Then an
    ``AsyncCheckpointer`` save of the final state must pass
    ``verify_checkpoint``; the save, the verification and the restart's
    restore are timed, and the directory is removed.  Returns the
    restarted run's launches."""
    cfg = dataclasses.replace(get_config(MOE), n_layers=2)
    model = build_model(cfg)
    trainer = Trainer(model, _train_opt(CKPT_STEPS, TRAIN_LR))
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    batches = [pipe.global_batch_arrays(i) for i in range(CKPT_STEPS)]
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=build_dir))
    try:
        params, opt = trainer.init(torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(t.numel() for t in tree_leaves(params))
        t0 = time.perf_counter()
        losses = []
        for batch in batches:
            params, opt, m = trainer.step(params, opt, batch)
            losses.append(float(m["loss"]))
        straight_s = time.perf_counter() - t0

        state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
        got, restored_at, failed_at = {}, [], []

        def step_fn(state, step):
            p, o, m = trainer.step(*state, batches[step])
            got[step] = float(m["loss"])
            if step == CKPT_FAIL_AT and not failed_at:
                failed_at.append(time.perf_counter())
                raise RuntimeError(f"injected failure after step {step}'s update")
            return p, o

        def on_restore(n, step):  # the restore's seconds: from the failure to here
            torch.cuda.synchronize()
            restored_at.append((step, time.perf_counter() - failed_at[-1]))

        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        (params2, opt2), restarts = run_with_restarts(
            step_fn, state, CKPT_STEPS, str(root / "restarts"), ckpt_every=CKPT_EVERY,
            on_restore=on_restore)
        torch.cuda.synchronize()
        restarts_s = time.perf_counter() - t0
        launches = _launches()
        del state
        want = train_launches(cfg, CKPT_STEPS + 1)
        same = (_bit_identical((params, opt), (params2, opt2)) and opt2["step"] == CKPT_STEPS
                and [got[i] for i in range(CKPT_STEPS)] == losses)
        ok = (same and restarts == 1 and [s for s, _ in restored_at] == [CKPT_FAIL_AT]
              and launches == want)
        log(f"phase 7 checkpoint {cfg.name} 2 layers full width ({n_params / 1e9:.3f} B params, "
            f"fp32 master and moments, {cfg.compute_dtype} compute), B{TRAIN_BATCH} S{TRAIN_SEQ}: "
            f"{CKPT_STEPS} steps straight in {straight_s:.1f} s, losses "
            + " ".join(f"{x:.4f}" for x in losses) + f"; through run_with_restarts (a checkpoint "
            f"every {CKPT_EVERY} steps, a failure after step {CKPT_FAIL_AT}'s update) in "
            f"{restarts_s:.1f} s: {restarts} restart, resumed at step "
            f"{[s for s, _ in restored_at]}; params, "
            f"moments, step and losses {'bit-identical' if same else 'DIFFER'}; launches "
            f"{launches} (want {want}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the restarted run does not repeat the straight run")

        tree, step = (params2, opt2), CKPT_STEPS - 1
        with AsyncCheckpointer() as saver:
            t0 = time.perf_counter()
            saver.save(str(root / "async"), step, tree)
            snap_s = time.perf_counter() - t0
            saver.wait()
            async_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        intact = verify_checkpoint(str(root / "async"), step)
        verify_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in (root / "async" / f"step_{step:010d}").iterdir())
        restore_s = restored_at[0][1]
        log(f"phase 7 checkpoint {cfg.name}: {nbytes / 1e9:.3f} GB a checkpoint (params and "
            f"AdamW state, {len(tree_leaves(tree))} leaves); save: AsyncCheckpointer.save "
            f"returned after {snap_s:.2f} s (the host copy), written after {async_s:.2f} s "
            f"({nbytes / 1e9 / async_s:.2f} GB/s: host copy, npz, sha256); verify_checkpoint "
            f"{'ok' if intact else 'FAIL'} in {verify_s:.2f} s; restore in run_with_restarts, "
            f"failure to resumed state on the card, {restore_s:.2f} s "
            f"({nbytes / 1e9 / restore_s:.2f} GB/s: read, sha256, to the card)")
        if not intact:
            raise SystemExit("an AsyncCheckpointer save of the final state does not verify")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params, opt, params2, opt2, tree, model, trainer
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------- phase 10: the simulator
# tests/test_golden_tables.py's frozen tables of the JAX package's numpy
# simulator, keyed (m, L, mode, seed, messages a node); the golden engine's
# and the streaming engine's
SIM_GOLDEN = {
    (4, 2, "dense", 0, 3): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 2.15, "max_avg_load": 3.75, "avg_hops": 1.83},
        {"lvl": 2, "max_rds": 2, "avg_rds": 1.06, "max_avg_load": 3.0, "avg_hops": 1.0},
    ],
    (8, 2, "light", 1, 2): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 1.93, "max_avg_load": 2.38, "avg_hops": 1.83},
        {"lvl": 2, "max_rds": 1, "avg_rds": 1.0, "max_avg_load": 2.0, "avg_hops": 1.0},
    ],
    (4, 3, "dense", 2, 2): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 3.89, "max_avg_load": 3.75, "avg_hops": 3.47},
        {"lvl": 2, "max_rds": 2, "avg_rds": 2.02, "max_avg_load": 2.0, "avg_hops": 2.0},
        {"lvl": 3, "max_rds": 2, "avg_rds": 1.05, "max_avg_load": 2.0, "avg_hops": 1.0},
    ],
    (8, 3, "light", 3, 2): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 3.98, "max_avg_load": 3.5, "avg_hops": 3.72},
        {"lvl": 2, "max_rds": 1, "avg_rds": 2.0, "max_avg_load": 2.0, "avg_hops": 2.0},
        {"lvl": 3, "max_rds": 1, "avg_rds": 1.0, "max_avg_load": 2.0, "avg_hops": 1.0},
    ],
}
SIM_GOLDEN_STREAMING = {
    (4, 2, "dense", 0, 3): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 2.35, "max_avg_load": 4.25, "avg_hops": 1.96},
        {"lvl": 2, "max_rds": 2, "avg_rds": 1.06, "max_avg_load": 3.0, "avg_hops": 1.0},
    ],
    (8, 2, "light", 1, 2): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 1.92, "max_avg_load": 2.38, "avg_hops": 1.79},
        {"lvl": 2, "max_rds": 1, "avg_rds": 1.0, "max_avg_load": 2.0, "avg_hops": 1.0},
    ],
    (4, 3, "dense", 2, 2): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 4.06, "max_avg_load": 4.25, "avg_hops": 3.55},
        {"lvl": 2, "max_rds": 2, "avg_rds": 2.03, "max_avg_load": 2.0, "avg_hops": 2.0},
        {"lvl": 3, "max_rds": 2, "avg_rds": 1.02, "max_avg_load": 2.0, "avg_hops": 1.0},
    ],
    (8, 3, "light", 3, 2): [
        {"lvl": 1, "max_rds": 3, "avg_rds": 4.05, "max_avg_load": 3.62, "avg_hops": 3.76},
        {"lvl": 2, "max_rds": 1, "avg_rds": 2.0, "max_avg_load": 2.0, "avg_hops": 2.0},
        {"lvl": 3, "max_rds": 1, "avg_rds": 1.0, "max_avg_load": 2.0, "avg_hops": 1.0},
    ],
}
# The paper's experiment: C(1/4, 4) (m 32, L 4, 2^20 nodes), 28 messages a
# node, dense, seed 1, chunk 2^21, on the streaming engine; then the 102^3
# torus at 4 a node.  The rows, torus fields and factors are BENCH_sim.json's
# (``clex.rows``, ``torus``, ``factors``); the JAX package's numpy streaming
# engine, rerun on a CPU at those settings, gave the same rows and fields,
# and the exact sums, histogram and edge loads below.
PAPER_SEED, PAPER_CHUNK, PAPER_TORUS_K, PAPER_TORUS_MSGS = 1, 1 << 21, 102, 4
PAPER_ROWS = [
    {"lvl": 1, "max_rds": 7, "avg_rds": 13.51, "max_avg_load": 44.0, "avg_hops": 10.32},
    {"lvl": 2, "max_rds": 2, "avg_rds": 4.1, "max_avg_load": 28.46, "avg_hops": 4.0},
    {"lvl": 3, "max_rds": 2, "avg_rds": 2.05, "max_avg_load": 28.0, "avg_hops": 2.0},
    {"lvl": 4, "max_rds": 2, "avg_rds": 1.03, "max_avg_load": 28.0, "avg_hops": 1.0},
]
PAPER_LEVELS = {  # level: (max_rounds, rounds_total, hops_total, max_avg_load, detours)
    1: (7, 396633484.0, 303048533.0, 44.0, 0),
    2: (2, 120404954.0, 117440512.0, 28.458984375, 0),
    3: (2, 60226861.0, 58720256.0, 28.0, 0),
    4: (2, 30112152.0, 29360128.0, 28.0, 0),
}
PAPER_PHASE_HIST = {3: 228554, 4: 33590}  # A(1) instances by last phase; 51 entries
PAPER_EDGE_LOAD = {
    4: {"max_edge_load": 2, "messages": 29360128, "bundles_used": 1048576,
        "live_edges": 33554432},
    3: {"max_edge_load": 2, "messages": 58720256, "bundles_used": 2097152,
        "live_edges": 67108864},
    2: {"max_edge_load": 2, "messages": 117440512, "bundles_used": 4194304,
        "live_edges": 134217728},
}
PAPER_TORUS_ROW = {"avg_hops": 76.48, "max_hops": 153, "max_link_load": 92,
                   "mean_link_load": 50.99, "completion_rounds_lb": 153}
PAPER_FACTORS = {"bandwidth_utilization_factor": 8.8, "hop_delay_reduction": 7.4,
                 "propagation_ratio": 2.5, "path_length_factor_vs_torus_hops": 4.42}
PAPER_TORUS_EXACT = {"n_messages": 4244832, "links_used": 6367248,
                     "avg_hops": 76.4806677861456, "mean_link_load": 50.9871118574304}
MID_TOPO, MID_MSGS, MID_SEED = (16, 3), 14, 2  # 4096 nodes, about 0.9 m messages a node


def _sim_fields(res) -> dict:
    """Every field of a simulator result but its wall (and the golden
    engine's audit trace), in comparable form."""
    out = {}
    for f in dataclasses.fields(res):
        if f.name in ("wall_seconds", "audit"):
            continue
        v = getattr(res, f.name)
        if f.name == "levels":
            v = {lvl: dataclasses.asdict(st) for lvl, st in v.items()}
        elif isinstance(v, np.ndarray):
            v = (str(v.dtype), v.tolist())
        out[f.name] = v
    return out


def _sim_check(label: str, ok: bool, detail: str = "") -> None:
    log(f"phase 10 check {label}: {'ok' if ok else 'MISMATCH'}{'; ' + detail if detail else ''}")
    if not ok:
        raise SystemExit(f"phase 10: {label} differs")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check_hash_bits() -> None:
    """The hash RNG on 2^20 indices with salts whose top bit is set: card
    against CPU, bit for bit (mix64 on words whose top bit is set)."""
    g = torch.arange(1 << 20, dtype=torch.int64)
    salts = [s for s in (salt_for(i, "chip_smoke", "hash") for i in range(64)) if s >> 63][:2]
    bounds = (g * 7919) % 1000003 + 1
    for salt in salts:
        words = g * -7046029254386353131 + (salt - (1 << 64))  # wraps, as uint64 does
        outs = {}
        for dev in ("cuda", "cpu"):
            gd, wd, bd = g.to(dev), words.to(dev), bounds.to(dev)
            outs[dev] = [mix64(wd), hash_u01(gd, salt), hash_randint(gd, 1000003, salt),
                         hash_randint(gd, bd, salt), pseudo_permutation(gd, 29360128, salt)]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(outs["cuda"], outs["cpu"]))
        top = int((words < 0).sum())
        _sim_check(f"hash bits salt {salt:#018x}", same,
                   f"mix64, hash_u01, hash_randint (scalar and per-index bounds), "
                   f"pseudo_permutation over 2^20 indices ({top} words with the top bit set), "
                   "card == cpu")


def _check_frozen_tables() -> None:
    for engine, fn, tables in (("golden", simulate_point_to_point, SIM_GOLDEN),
                               ("streaming", simulate_point_to_point_streaming,
                                SIM_GOLDEN_STREAMING)):
        for (m, L, mode, seed, msgs), rows in tables.items():
            res = fn(CLEXTopology(m, L), msgs, mode=mode, seed=seed, device="cuda")
            _sim_check(f"frozen table {engine} m{m} L{L} {mode} seed {seed}",
                       res.table() == rows)


def _check_card_vs_cpu() -> None:
    """The middle size (m 16, L 3, 4096 nodes) on the card and on the CPU,
    every field equal; then the torus, the scenario matrix and the
    all-to-all."""
    topo = CLEXTopology(*MID_TOPO)
    faults = FaultSet.sample(topo, node_rate=0.01, rng=np.random.default_rng(MID_SEED))
    p2p = simulate_point_to_point
    stream = simulate_point_to_point_streaming
    cases = [
        ("golden dense", p2p, dict(mode="dense")),
        ("golden light", p2p, dict(mode="light")),
        ("golden dense, 1% node faults", p2p, dict(mode="dense", faults=faults)),
        ("golden light, Valiant level 2", p2p, dict(mode="light", valiant_level=2)),
        ("streaming dense", stream, dict(mode="dense")),
        ("streaming light", stream, dict(mode="light")),
        ("streaming dense, 1% node faults", stream, dict(mode="dense", faults=faults)),
        ("streaming light, 1% node faults", stream, dict(mode="light", faults=faults)),
        ("streaming dense, Valiant level 2", stream, dict(mode="dense", valiant_level=2)),
        ("streaming dense, chunk 2^10", stream, dict(mode="dense", chunk_size=1 << 10)),
    ]
    card_of = {}
    for label, fn, kw in cases:
        card, t_card = _timed(lambda: fn(topo, MID_MSGS, seed=MID_SEED, device="cuda", **kw))
        t0 = time.perf_counter()
        cpu = fn(topo, MID_MSGS, seed=MID_SEED, device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        card_of[label] = card
        extra = f"{card.total_detours} detours, " if card.total_detours else ""
        _sim_check(f"card vs cpu m16 L3 {label}", _sim_fields(card) == _sim_fields(cpu),
                   f"{card.n_messages} messages, {extra}{card.n_dropped_dead} dropped, "
                   f"sum avg rounds {card.sum_avg_rounds!r}; card {t_card:.2f} s, "
                   f"cpu {t_cpu:.2f} s (host clock)")
    small, big = card_of["streaming dense, chunk 2^10"], card_of["streaming dense"]
    small.chunk_size = big.chunk_size
    _sim_check("chunk 2^10 against chunk 2^20 on the card", _sim_fields(small) == _sim_fields(big))
    torus = TorusTopology.cube(16)
    card, t_card = _timed(lambda: simulate_torus_dor_streaming(torus, 4, seed=MID_SEED,
                                                               device="cuda"))
    cpu = simulate_torus_dor_streaming(torus, 4, seed=MID_SEED, device="cpu")
    _sim_check("card vs cpu torus streaming k16", _sim_fields(card) == _sim_fields(cpu),
               f"{card.row()}; card {t_card:.2f} s")
    rows, t_card = _timed(lambda: scenario_matrix(topo, torus, 4, seed=MID_SEED,
                                                  engine="streaming", device="cuda"))
    cpu_rows = scenario_matrix(topo, torus, 4, seed=MID_SEED, engine="streaming", device="cpu")
    _sim_check("card vs cpu scenario_matrix m16 L3 / k16, streaming", rows == cpu_rows,
               f"{len(rows)} rows ({', '.join(r['scenario'] for r in rows)}); card "
               f"{t_card:.2f} s")
    a2a = CLEXTopology(8, 3)
    a2a_faults = FaultSet.sample(a2a, node_rate=0.01, rng=np.random.default_rng(MID_SEED))
    for label, f in (("", None), (", 1% node faults", a2a_faults)):
        bw = asymmetric_bandwidth(a2a)
        card, t_card = _timed(lambda: simulate_all_to_all_streaming(
            a2a, bandwidth=bw, faults=f, seed=MID_SEED, device="cuda"))
        cpu = simulate_all_to_all_streaming(a2a, bandwidth=bw, faults=f, seed=MID_SEED,
                                            device="cpu")
        _sim_check(f"card vs cpu all-to-all streaming m8 L3{label}",
                   _sim_fields(card) == _sim_fields(cpu),
                   f"{card.row()}; card {t_card:.2f} s")


def _profile(fn) -> tuple[float, str]:
    """Device busy ms of one call of ``fn`` under torch.profiler, its
    kernel count and top kernels by device time."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return 0.0, "the profiler saw no device time (not measured)"
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return busy_ms, (f"{sum(e.count for e in events)} kernels; top device time: "
                     + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.1f} ms "
                                 f"x{e.count}" for e in top))


def _run_paper(smi: str) -> None:
    topo = PAPER_TOPOLOGIES["c14_4"]
    msgs = PAPER_TRAFFIC[("c14_4", "dense")]
    eng = StreamingEngine(chunk_size=PAPER_CHUNK, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prev = get_obs()
    set_obs(ob := Obs())  # the engine's chunk instants, in s since this line, time its parts
    try:
        res, wall = _timed(lambda: eng.run_clex(topo, msgs, mode="dense", seed=PAPER_SEED))
    finally:
        set_obs(prev)
    chunks = [e["ts"] for e in ob.tracer.events if e["name"] == "sim_chunk"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    levels = {lvl: (st.max_rounds, st.rounds_total, st.hops_total, st.max_avg_load, st.detours)
              for lvl, st in res.levels.items()}
    hist = {i: int(c) for i, c in enumerate(res.lb_phase_histogram) if c}
    exact = (res.table() == PAPER_ROWS and levels == PAPER_LEVELS and hist == PAPER_PHASE_HIST
             and len(res.lb_phase_histogram) == 51 and res.edge_load == PAPER_EDGE_LOAD
             and res.n_messages == topo.n * msgs and all(
                 st.n_messages == topo.n * msgs for st in res.levels.values()))
    paper = PAPER_TABLES["table1"]
    for row in res.table():
        log(f"phase 10 paper C(1/4, 4) dense: {row}; the paper's Table I: "
            f"{dict(zip(('max_rds', 'avg_rds', 'max_avg_load', 'avg_hops'), paper[row['lvl']]))}")
    _sim_check("paper C(1/4, 4) m32 L4, 2^20 nodes, 28 a node, dense, seed 1, chunk 2^21",
               exact, "rows equal BENCH_sim.json's clex.rows; rounds and hops totals, "
               "phase histogram and edge loads equal the numpy engine's")
    log(f"phase 10 paper C(1/4, 4): {res.n_messages} messages in {wall:.2f} s wall "
        f"({res.n_messages / wall / 1e6:.2f} M messages routed a second; the host's traffic "
        f"shuffle and the first chunk done at {chunks[0]:.2f} s, all {len(chunks)} chunks "
        f"routed at {chunks[-1]:.2f} s, the A(1) finalize replay and the rest "
        f"{wall - chunks[-1]:.2f} s), peak device memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); {smi}")
    busy_ms, top = _profile(lambda: eng.run_clex(topo, msgs, mode="dense", seed=PAPER_SEED))
    log(f"phase 10 paper C(1/4, 4) profile (a second run under torch.profiler): device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / 1e3 / wall:.1f}% of the unprofiled wall; {top}")
    tor_topo = TorusTopology.cube(PAPER_TORUS_K)
    torch.cuda.reset_peak_memory_stats()
    tor, t_wall = _timed(lambda: eng.run_torus(tor_topo, PAPER_TORUS_MSGS, seed=PAPER_SEED))
    t_peak = torch.cuda.max_memory_allocated() / 2**30
    exact = (tor.row() == PAPER_TORUS_ROW and all(
        getattr(tor, k) == v for k, v in PAPER_TORUS_EXACT.items()))
    _sim_check(f"paper torus k{PAPER_TORUS_K} ({tor_topo.n} nodes), {PAPER_TORUS_MSGS} a node",
               exact, f"{tor.row()}, links used {tor.links_used}, mean link load "
               f"{tor.mean_link_load!r}, avg hops {tor.avg_hops!r} equal BENCH_sim.json's "
               "torus and the numpy engine's")
    t_busy, t_top = _profile(lambda: eng.run_torus(tor_topo, PAPER_TORUS_MSGS, seed=PAPER_SEED))
    log(f"phase 10 paper torus: {tor.n_messages} messages in {t_wall:.2f} s wall "
        f"({tor.n_messages / t_wall / 1e6:.2f} M messages a second), peak device memory "
        f"{t_peak:.2f} GiB; profile: device busy {t_busy:.1f} ms; {t_top}; {smi}")
    derived = derive_comparison(res).row()
    factors = {"bandwidth_utilization_factor": derived["bandwidth_gain"],
               "hop_delay_reduction": derived["hop_delay_reduction"],
               "propagation_ratio": derived["propagation_ratio"],
               "path_length_factor_vs_torus_hops": round(
                   tor.avg_hops / max(res.sum_avg_hops, 1e-9), 2)}
    _sim_check("paper factors", factors == PAPER_FACTORS,
               f"{factors} equal BENCH_sim.json's factors; the paper's (propagation ratio, "
               f"hop-delay reduction, bandwidth gain) {PAPER_DERIVED[('c14_4', 'dense')]}")


def phase_simulator(smi: str) -> dict:
    """Phase 10: the CLEX simulator on the card.  It launches none of the
    three kernels (its work is sorts, histograms and hashes in plain
    PyTorch ops, as the reference computes it in numpy); the counters are
    set to 0 before and read after, and returned as the path's launches."""
    _reset_launches()
    t0 = time.perf_counter()
    _check_hash_bits()
    _check_frozen_tables()
    _check_card_vs_cpu()
    checks = time.perf_counter() - t0
    _run_paper(smi)
    launches = _launches()
    if any(launches.values()):
        raise SystemExit(f"phase 10: the simulator launched a model kernel: {launches}")
    log(f"phase 10 simulator: checks {checks:.1f} s, paper runs "
        f"{time.perf_counter() - t0 - checks:.1f} s (host clock); launches of the three "
        f"kernels {launches}: the simulator path runs none of them")
    return launches


def _kernel_entry(name, mod, replaces, launches, err, rep) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": str(mod.SOURCE.relative_to(Path(__file__).resolve().parent)),
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "shape": rep["shape"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    mark, walls = wall_marks()
    smi, kind = phase_card_and_build()
    mark("1 build")
    fa_err, fa_checked = phase_check_flash()
    gmm_err, gmm_checked = phase_check_gmm()
    ssd_err, ssd_checked = phase_check_ssd()
    ssd_bwd_err, ssd_grad_checked = phase_check_ssd_grads()
    mark("2 checks")
    fa_rows, gmm_rows, ssd_rows = phase_time_flash(), phase_time_gmm(), phase_time_ssd()
    ssd_bwd_rep = phase_time_ssd_backward()
    mark("3 times")
    # phase 8 runs on phase 4's weights, right after their path
    sessions, paths = {}, {}
    for arch in ARCHS:
        paths[arch] = phase_serve(arch, fa_checked, gmm_checked, ssd_checked,
                                  EARLIER_LAYERS[arch],
                                  sessions=sessions if arch == DENSE else None)
        mark(f"4 serve {arch}" + (", 8 sessions" if arch == DENSE else ""))
    paths[HYBRID] = phase_serve(HYBRID, fa_checked, gmm_checked, ssd_checked, HYBRID_LAYERS,
                                sessions=sessions)
    mark(f"4 serve {HYBRID}, 8 sessions")
    phase_ssm_prefill_vs_plain()
    phase_prefill_profile()
    mark("4 checks and profile")
    for arch in ARCHS:
        phase_card_vs_cpu(arch)
    phase_card_vs_cpu(HYBRID, cfg=hybrid_cut())
    mark("5 card vs cpu")
    fa_bwd_err, fa_grad_checked = phase_check_flash_grads()
    phase_check_gmm_grads()
    fa_bwd_rep = phase_time_flash_backward()
    mark("6 backward checks and times")
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=EARLIER_LAYERS[arch])
        paths[f"train {arch}"] = phase_train(arch, fa_checked, fa_grad_checked, gmm_checked,
                                             ssd_checked, ssd_grad_checked, cfg=cfg)
        mark(f"6 train {arch}")
    paths[f"train {HYBRID}"] = phase_train(HYBRID, fa_checked, fa_grad_checked, gmm_checked,
                                           ssd_checked, ssd_grad_checked, cfg=hybrid_cut())
    mark(f"6 train {HYBRID}")
    for arch in ARCHS:
        phase_train_card_vs_cpu(arch)
        mark(f"6 train card vs cpu {arch}")
    phase_train_card_vs_cpu(HYBRID, cfg=hybrid_cpu_cut())
    mark(f"6 train card vs cpu {HYBRID}")
    paths[f"checkpoint {MOE}"] = phase_checkpoint()
    paths.update(sessions)
    mark("7 checkpoints")
    paths.update(phase_families(fa_checked, fa_grad_checked))
    mark("9 families")
    paths["simulator"] = phase_simulator(smi)
    mark("10 simulator")
    log("walls by phase and path: " + ", ".join(f"{what} {w:.1f} s" for what, w in walls))
    fa_rep = next(r for r in fa_rows if r["shape"] == str(main_shape(4, 1024)))
    decode_c = capacity(get_config(MOE), N_SLOTS)
    gmm_rep = next(r for r in gmm_rows if r["shape"] == str(expert_shapes(decode_c)[0]))
    ssd_rep = next(r for r in ssd_rows if r["shape"] == str(ssm_shape(4, 512)))
    kernels = []
    for name, mod, replaces, err, rep in (
            ("flash_attention", fa_kernel, fa_kernel.REPLACES, fa_err, fa_rep),
            ("flash_attention_bwd", fa_kernel, fa_kernel.BWD_REPLACES, fa_bwd_err, fa_bwd_rep),
            ("moe_gmm", gmm_kernel, gmm_kernel.REPLACES, gmm_err, gmm_rep),
            ("ssd_scan", ssd_kernel, ssd_kernel.REPLACES, ssd_err, ssd_rep),
            ("ssd_scan_bwd", ssd_kernel, ssd_kernel.BWD_REPLACES, ssd_bwd_err, ssd_bwd_rep)):
        entry = _kernel_entry(name, mod, replaces, sum(p[name] for p in paths.values()), err, rep)
        entry["launches_by_path"] = {arch: p[name] for arch, p in paths.items()}
        kernels.append(entry)
    wgmma = sum(p["ssd_scan_bwd_wgmma"] for p in paths.values())
    ssd_bwd = next(e for e in kernels if e["name"] == "ssd_scan_bwd")
    ssd_bwd["launches_by_route"] = {"wgmma": wgmma, "fma": ssd_bwd["launches"] - wgmma}
    ssd_bwd["fma_route_ms"] = ssd_bwd_rep["fma_ms"]
    log(f"kernels: {', '.join(e['name'] for e in kernels)} (each launched on a main path, held "
        "against its plain version)")
    log(f"card: {smi}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
