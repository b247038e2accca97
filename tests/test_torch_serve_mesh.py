"""Serving on a mesh with a ``model`` axis: the port's engines on gloo ranks
of the CPU (``tests/torch_ranks.py``'s ``serve`` case, no JAX) against the
JAX package's engines on a JAX mesh of the same shape of the pytest
process's virtual CPU devices, from the same params (made by the JAX
package; each rank takes its block across the bridge, the reference
reshards them with its ``reshard_params``).

REDUCED configs in fp32 compute, 2 layers (jamba's 5: SSM layers 0 to 3,
MoE FFNs at 1 and 3, dense ones at 0, 2 and 4, its attention layer 4), 5
prompts of 4 to 11 tokens (seed 0), 6 greedy tokens, 3 slots, capacity
40.  Every rank's stream must equal the reference's token
for token: internlm2 on (data 2, model 2) and on (1, 4), where its 2 KV
heads do not split over 4 ranks; granite-moe on (2, 2) and (1, 2), both MoE
paths, whose streams differ from each other and from the meshless one, as
the reference's do (capacity is reckoned per rank); mamba2 on (1, 2), the
gated norm summed across the ranks; jamba on (2, 2); and
``ServingEngine.generate`` of internlm2 on (2, 2); and internlm2 on (2, 2)
with open-loop arrivals and a deadline on a virtual clock that each rank
skews by its rank, so that only rank 0's clock keeps the ranks' schedules
alike (one request is shed past its deadline).  A prefill's logits
within 1e-4 of their largest value of the reference's.  Single layers on
the same ranks: the MoE layer on each path (all-to-all, replicated with
the tokens split over ``data``, replicated whole) against the reference's
``moe_apply`` under ``use_mesh``, within 2e-5 as ``tests/test_moe.py``
holds it, with the groups each path sent bytes over; the SSM layer (a
prefill, then a decode step); GQA with KV heads that do not split.

The three meshes' ranks (10 processes, two threads each) run while the JAX
side computes."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses
import json
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs.base import get_config as jax_get_config
from repro.launch.jax_compat import make_mesh as jax_make_mesh
from repro.launch.jax_compat import use_mesh
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.runtime.serving import ContinuousBatchingEngine as JaxEngine
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro.runtime.sharding import reshard_params as jax_reshard

torch.set_num_threads(2)

LAYERS = {"internlm2-1.8b": 2, "granite-moe-1b-a400m": 2, "mamba2-1.3b": 2,
          "jamba-v0.1-52b": 5}
DENSE, MOE, SSM, HYBRID = LAYERS
MOE_INPUTS = {"a2a": (2, 8), "rep": (2, 1), "rep3": (3, 1)}  # [B, S] of the MoE layer's input
RUNS = {
    "2x2": [("continuous", DENSE), ("one_shot", DENSE), ("open_loop", DENSE),
            ("continuous", MOE), ("continuous", HYBRID)]
    + [("moe", MOE, name) for name in MOE_INPUTS],
    "1x4": [("continuous", DENSE), ("attn", DENSE, "x9")],
    "1x2": [("continuous", MOE), ("continuous", SSM), ("ssm", SSM, "x9")]
    + [("moe", MOE, name) for name in MOE_INPUTS],
}
STREAMS = [(mesh, kind, arch) for mesh, runs in RUNS.items()
           for kind, arch, *_ in runs if kind in ("continuous", "one_shot")]
WORLD = {"2x2": 4, "1x4": 4, "1x2": 2}
# the open-loop run, one clock unit an engine step: requests 0 and 1 at once,
# 2 at 1.5 (a rank whose clock ran 0.6 ahead would admit it a step early),
# 3 at 2.5 with a deadline of 3.2 (every slot is busy until step 4: shed),
# 4 at 20, after the engine has gone idle (run jumps the clock to it)
OPEN_LOOP = {"arrivals": [0.0, 0.0, 1.5, 2.5, 20.0],
             "deadlines": [None, None, None, 3.2, None], "skew": 0.6}
LOGITS_TOL = 1e-4
LAYER_TOL = 2e-5


def _cfg(arch):
    return dataclasses.replace(jax_get_config(arch, reduced=True), compute_dtype="float32",
                               n_layers=LAYERS[arch])


def _prompts(vocab):
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 12, 5)
    return [rng.integers(1, vocab, (int(n),)).astype(np.int32) for n in lens]


def _jmesh(mesh):
    d, m = (int(n) for n in mesh.split("x"))
    return jax_make_mesh((d, m), ("data", "model"), devices=jax.devices()[:d * m])


def _inputs():
    rng = np.random.default_rng(3)
    d = jax_get_config(MOE, reduced=True).d_model
    out = {name: rng.normal(size=(b, s, d)).astype(np.float32)
           for name, (b, s) in MOE_INPUTS.items()}
    out["x9"] = rng.normal(size=(2, 9, d)).astype(np.float32)
    prompts = _prompts(jax_get_config(DENSE, reduced=True).vocab)
    out.update({f"prompt{i}": p for i, p in enumerate(prompts)}, n_prompts=np.array(len(prompts)))
    return out


def _prefill_batch(prompts):
    toks = np.zeros((2, 16), np.int32)
    for i, p in enumerate(prompts[:2]):
        toks[i, :len(p)] = p
    return toks, np.array([len(p) - 1 for p in prompts[:2]], np.int32)


def _open_loop(engine, prompts):
    """The reference's open-loop run (``torch_ranks.open_loop`` with no skew)."""
    rids = [engine.submit(p, 6, arrival_time=a, deadline=d)
            for p, a, d in zip(prompts, OPEN_LOOP["arrivals"], OPEN_LOOP["deadlines"])]
    got = engine.run(clock=lambda: engine.metrics.steps)
    return [[engine.requests[r].state, [int(t) for t in got.get(r, [])]] for r in rids]


def _mixer(kind, cfg):
    """Layer 0's mixer over x [B, S, D]: a prefill of S - 1 tokens, then a
    decode step, concatenated."""
    def run(layer, x):
        b, s, _ = x.shape
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        if kind == "ssm":
            y, cache = jax_ssm.ssm_apply(layer, x[:, :-1], cfg, positions=pos[:, :-1],
                                         update_cache=True)
            step, _ = jax_ssm.ssm_apply(layer, x[:, -1:], cfg, positions=pos[:, -1:],
                                        cache=cache)
        else:
            y, cache = jax_attn.attention_apply(layer, x[:, :-1], cfg, positions=pos[:, :-1],
                                                update_cache=True)
            ring = {k: jnp.concatenate([v, jnp.zeros_like(v[:, :1])], axis=1)
                    for k, v in cache.items()}
            ring["pos"] = ring["pos"].at[:, -1].set(-1)
            step, _ = jax_attn.attention_apply(layer, x[:, -1:], cfg, positions=pos[:, -1:],
                                               cache=ring, ragged=True)
        return jnp.concatenate([y, step], axis=1)

    return jax.jit(run)


def _host(v):
    return [_host(o) for o in v] if isinstance(v, list) else (
        v if isinstance(v, (str, int)) else np.asarray(v))


def _layer0(params):
    """Layer 0 of the reference's stack: the first pattern position, its
    leaves' first repeat where the pattern repeats."""
    pattern = params["decoder"]
    if len(pattern) == 1 and pattern[0]["ln1"].ndim == 2:
        return jax.tree.map(lambda t: t[0], pattern[0])
    return pattern[0]


def _reference(models, params, inputs):
    """The JAX package's streams, logits and layers on each mesh, and the
    meshless granite stream, in threads (their compiles overlap): one a
    mesh, and jamba's run in one of its own."""
    prompts = [inputs[f"prompt{i}"] for i in range(int(inputs["n_prompts"]))]
    units = [(mesh, [r for r in runs if r[1] != HYBRID]) for mesh, runs in RUNS.items()]
    units += [(mesh, [r]) for mesh, runs in RUNS.items() for r in runs if r[1] == HYBRID]
    with ThreadPoolExecutor(len(units)) as pool:
        parts = [pool.submit(_reference_on, mesh, runs, models, params, inputs, prompts)
                 for mesh, runs in units]
        ref = {"meshless": _host(JaxEngine(models[MOE], params[MOE], n_slots=3, max_len=40)
                                 .generate(prompts, 6))}
        for part in parts:
            ref.update(part.result())
    return ref


def _reference_on(mesh, runs, models, params, inputs, prompts):
    """The reference's results of ``runs`` on ``mesh``."""
    ref = {}
    jm = _jmesh(mesh)
    for kind, arch, *rest in runs:
        model, p = models[arch], jax_reshard(models[arch].param_axes(), params[arch], jm)
        if kind == "continuous":
            ref[mesh, kind, arch] = JaxEngine(model, p, n_slots=3, max_len=40,
                                              mesh=jm).generate(prompts, 6)
            toks, last = _prefill_batch(prompts)
            ref[mesh, "logits", arch] = jax.jit(lambda p, t, l, model=model, jm=jm:
                                                model.prefill(p, {"tokens": t}, mesh=jm,
                                                              last_pos=l)[0])(p, toks, last)
        elif kind == "open_loop":
            ref[mesh, kind, arch] = _open_loop(
                JaxEngine(model, p, n_slots=3, max_len=40, mesh=jm), prompts)
        elif kind == "one_shot":
            short = min(len(q) for q in prompts)
            batch = np.stack([q[:short] for q in prompts])
            ref[mesh, kind, arch] = JaxServingEngine(model, p, max_len=40,
                                                     mesh=jm).generate(batch, 6)
        elif kind == "moe":
            layer = _layer0(params[arch])["ffn"]
            vcfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
                model.cfg.moe, valiant_shuffle=True))
            with use_mesh(jm):
                ref[mesh, kind, rest[0]] = jax.jit(
                    lambda lp, x, cfg=model.cfg: jax_moe.moe_apply(lp, x, cfg))(
                    layer, inputs[rest[0]])[0]
                ref[mesh, "valiant", rest[0]] = jax.jit(
                    lambda lp, x: jax_moe.moe_apply(lp, x, vcfg, key=jax.random.PRNGKey(7)))(
                    layer, inputs[rest[0]])[0]
        else:
            ref[mesh, kind, arch] = _mixer(kind, model.cfg)(
                _layer0(params[arch])["mixer"], inputs[rest[0]])
    return {k: _host(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs = _inputs()
    models = {arch: jax_build_model(_cfg(arch)) for arch in LAYERS}
    params = {arch: m.init(jax.random.PRNGKey(0)) for arch, m in models.items()}
    pending = {}
    for mesh, runs in RUNS.items():
        workdir = tmp_path_factory.mktemp(f"serve{mesh}")
        np.savez(workdir / "inputs.npz", **inputs)
        (workdir / "serve.json").write_text(json.dumps(
            [{"kind": kind, "arch": arch, "layers": LAYERS[arch],
              **({"input": rest[0]} if rest else {}),
              **(OPEN_LOOP if kind == "open_loop" else {})} for kind, arch, *rest in runs]))
        for arch in {arch for _, arch, *_ in runs}:
            with open(workdir / f"params_{arch}.pkl", "wb") as f:
                pickle.dump(jax.tree.map(np.asarray, params[arch]), f)
        pending[mesh] = torch_ranks.spawn("serve", workdir, world=WORLD[mesh], timeout=240.0,
                                          mesh=mesh, wait=False)
    ref = _reference(models, params, inputs)
    return {mesh: wait() for mesh, wait in pending.items()}, ref


@pytest.mark.parametrize("mesh,kind,arch", STREAMS, ids=[f"{k}-{a}-{m}" for m, k, a in STREAMS])
def test_every_rank_streams_the_reference_tokens(results, mesh, kind, arch):
    ranks, ref = results
    want = [list(map(int, o)) for o in ref[mesh, kind, arch]]
    for r, out in enumerate(ranks[mesh]):
        got = [list(map(int, o)) for o in out[f"{kind} {arch}"]]
        assert got == want, f"rank {r} on {mesh}"


def test_meshed_moe_streams_differ_from_the_meshless_one_as_the_reference_does(results):
    """Capacity per rank: granite's streams on (2, 2) and (1, 2) differ
    from each other and from the meshless stream, in the port as in the
    reference (the equality above holds them to the reference's)."""
    ranks, ref = results
    meshless = [list(map(int, o)) for o in ref["meshless"]]
    streams = {m: ranks[m][0][f"continuous {MOE}"] for m in ("2x2", "1x2")}
    assert streams["2x2"] != meshless and streams["1x2"] != meshless
    assert streams["2x2"] != streams["1x2"]


@pytest.mark.parametrize("mesh,arch", [(m, a) for m, k, a in STREAMS if k == "continuous"],
                         ids=[f"{a}-{m}" for m, k, a in STREAMS if k == "continuous"])
def test_prefill_logits_match_the_reference(results, mesh, arch):
    ranks, ref = results
    want = ref[mesh, "logits", arch]
    for r, out in enumerate(ranks[mesh]):
        got = out[f"logits {arch}"].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LOGITS_TOL * np.abs(want).max(), f"rank {r}"
        assert np.array_equal(got, ranks[mesh][0][f"logits {arch}"].numpy()), \
            f"rank {r}'s logits are not rank 0's bits"


def test_open_loop_ranks_schedule_by_rank_0s_clock(results):
    """Arrivals and a deadline on clocks that differ from rank to rank: the
    engine schedules every rank by rank 0's, so each admits and sheds as
    the reference's engine on the same mesh with that clock, token for
    token (a rank on its own clock would admit request 2 a step early and
    enter another collective than its peers)."""
    ranks, ref = results
    want = ref["2x2", "open_loop", DENSE]
    assert [state for state, _ in want] == ["finished"] * 3 + ["shed", "finished"]
    for r, out in enumerate(ranks["2x2"]):
        assert out[f"open_loop {DENSE}"] == want, f"rank {r}"


def _path(mesh, name):
    """The path the reference's ``moe_apply`` takes (``src/repro/models/
    moe.py:227-243``) and the groups it sends over in the port."""
    dp, m = (int(n) for n in mesh.split("x"))
    b, s = MOE_INPUTS[name]
    tokens, top_k = b * s, jax_get_config(MOE, reduced=True).moe.top_k
    if tokens % (dp * m) == 0 and tokens // (dp * m) >= top_k:
        return "a2a", {"model", "data,model"}
    split = dp > 1 and tokens % dp == 0 and tokens >= dp
    return "replicated", {"model", "data"} if split else {"model"}


MOE_CASES = [(m, n) for m in ("2x2", "1x2") for n in MOE_INPUTS]


@pytest.mark.parametrize("mesh,name", MOE_CASES, ids=[f"{n}-{m}" for m, n in MOE_CASES])
def test_moe_layer_takes_the_reference_path_and_output(results, mesh, name):
    ranks, ref = results
    path, groups = _path(mesh, name)
    assert (name == "a2a") == (path == "a2a")
    for r, out in enumerate(ranks[mesh]):
        np.testing.assert_allclose(out[f"moe {MOE} {name}"].numpy(), ref[mesh, "moe", name],
                                   atol=LAYER_TOL, rtol=0, err_msg=f"rank {r} ({path})")
        assert set(out[f"bytes {name}"]) == groups, f"rank {r} ({path})"
        np.testing.assert_allclose(out[f"valiant {name}"].numpy(), ref[mesh, "valiant", name],
                                   atol=LAYER_TOL, rtol=0, err_msg=f"rank {r} ({path}, Valiant)")
    if path == "a2a":  # the keyed shift moves the tokens between the blocks' buckets
        assert not np.allclose(ref[mesh, "valiant", name], ref[mesh, "moe", name],
                               atol=LAYER_TOL, rtol=0)


@pytest.mark.parametrize("mesh,kind,arch", [("1x2", "ssm", SSM), ("1x4", "attn", DENSE)],
                         ids=["ssm-1x2", "attn-kv2-1x4"])
def test_mixer_layer_prefill_and_decode_match_the_reference(results, mesh, kind, arch):
    """A prefill of 8 tokens, then a decode step, through this rank's heads
    (the SSM's gated norm summed across the ranks; GQA with 2 KV heads on
    4 ranks, each keeping the one its query head reads)."""
    ranks, ref = results
    for r, out in enumerate(ranks[mesh]):
        np.testing.assert_allclose(out[f"{kind} {arch}"].numpy(), ref[mesh, kind, arch],
                                   atol=LAYER_TOL, rtol=0, err_msg=f"rank {r}")
        if kind == "attn":
            assert out["kv heads"] == (r, 1, [r // 2])
