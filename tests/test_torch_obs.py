"""The port's copy of the observability package (``repro_torch.obs``) and the
train launcher's ``--trace`` and ``--metrics``: counterparts of the
single-device tests of ``tests/test_obs.py`` (trace round trips, the inert
``NULL_OBS``, ``set_obs``, the registry, the calibration summary, the
disabled path's allocation guard, provenance, log levels), the copy held
against the JAX package's on the same inputs, the launchers' trace smokes,
and the tiered serving engine's spans, instants and calibration records
held against the JAX engine's on the same weights."""

import dataclasses
import gc
import json
import os
import tracemalloc

import jax
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime import serving as jax_serving
from repro_torch import obs as obslib
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.runtime.serving import ContinuousBatchingEngine, TierConfig
from repro_torch.obs import NULL_OBS, NULL_SPAN, Obs, get_obs, log, provenance, set_obs
from repro_torch.obs.calibration import CalibrationLedger, summarize_records
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, load_chrome, load_jsonl

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_null_obs():
    """The process-wide bundle must never leak across tests."""
    yield
    set_obs(None)


def _demo_tracer(tr=None):
    tr = tr or Tracer()
    tr.step = 3
    with tr.span("train_step", "train"):
        pass
    with tr.span("remesh", "train", kind="device_loss", survivors=4) as sp:
        sp.set(reshard_s=0.05)
    tr.instant("sync_switch", "train", tier="compressed", switched=True)
    tr.step = 4
    with tr.span("decode", "serve"):
        pass
    return tr


def test_tracer_jsonl_roundtrip(tmp_path):
    path = _demo_tracer().export_jsonl(str(tmp_path / "t.jsonl"))
    events = load_jsonl(path)
    assert [e["name"] for e in events] == ["train_step", "remesh", "sync_switch", "decode"]
    remesh = events[1]
    assert remesh["args"] == {"kind": "device_loss", "survivors": 4, "reshard_s": 0.05}
    assert remesh["step"] == 3 and events[3]["step"] == 4
    assert remesh["ph"] == "X" and remesh["dur"] >= 0
    assert events[2]["ph"] == "i"
    first = json.loads(open(path).readline())
    assert first["meta"]["n_events"] == 4


def test_chrome_export_is_perfetto_loadable_and_reparses(tmp_path):
    path = _demo_tracer().export_chrome(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    assert isinstance(doc["traceEvents"], list)
    assert {e["ph"] for e in doc["traceEvents"]} <= {"X", "i", "M"}
    for e in doc["traceEvents"]:
        if e["ph"] == "M":
            continue
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        if e["ph"] == "X":
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
    tids = {e["cat"]: e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert tids["train"] != tids["serve"]
    events = load_chrome(path)
    assert [e["name"] for e in events] == ["train_step", "remesh", "sync_switch", "decode"]
    assert events[1]["args"]["kind"] == "device_loss" and events[1]["step"] == 3


def test_trace_files_read_the_same_in_both_packages(tmp_path):
    """The copy writes what the JAX package's readers read, and the other
    way round: the same events, names, steps and args."""
    ours = _demo_tracer()
    theirs = _demo_tracer(jax_obs.Tracer())
    for name, tr, read in (("ours", ours, jax_obs.load_chrome), ("theirs", theirs, load_chrome)):
        events = read(tr.export_chrome(str(tmp_path / f"{name}.json")))
        assert [(e["name"], e["step"], e.get("args")) for e in events] == [
            (e["name"], e["step"], e.get("args")) for e in load_jsonl(
                tr.export_jsonl(str(tmp_path / f"{name}.jsonl")))]
    assert ([(e["name"], e["step"], e.get("args")) for e in ours.events]
            == [(e["name"], e["step"], e.get("args")) for e in theirs.events])


def test_null_obs_is_inert():
    assert not NULL_OBS.enabled
    sp = NULL_OBS.span("anything", "train")
    assert sp is NULL_SPAN
    with sp as inner:
        inner.set(whatever=2)
    NULL_OBS.instant("x", "y")
    assert NULL_OBS.tracer is None and NULL_OBS.registry is None


def test_set_obs_installs_and_restores():
    assert get_obs() is NULL_OBS
    ob = set_obs(Obs())
    assert get_obs() is ob and ob.enabled
    set_obs(None)
    assert get_obs() is NULL_OBS


def test_metrics_registry_basics():
    reg = MetricsRegistry()
    c = reg.counter("train.useful_steps")
    c.inc()
    c.inc(2)
    assert reg["train.useful_steps"].value == 3
    reg.gauge("sim.stream.msgs_per_s").set(1234.5)
    h = reg.histogram("serve.decode_ms")
    h.observe(2.0)
    h.observe(4.0)
    assert h.mean == pytest.approx(3.0)
    assert reg.counter("train.useful_steps") is c
    with pytest.raises(TypeError):
        reg.gauge("train.useful_steps")
    reg.absorb("serve.pool", {"n_evict": 7, "high_water": 3})
    assert reg["serve.pool.n_evict"].value == 7
    d = reg.as_dict()
    assert d["sim.stream.msgs_per_s"] == 1234.5
    assert "serve.decode_ms" in reg.names()
    theirs = jax_obs.MetricsRegistry()
    theirs.counter("train.useful_steps").inc(3)
    theirs.gauge("sim.stream.msgs_per_s").set(1234.5)
    for x in (2.0, 4.0):
        theirs.histogram("serve.decode_ms").observe(x)
    theirs.absorb("serve.pool", {"n_evict": 7, "high_water": 3})
    assert reg.to_json() == theirs.to_json()


def test_calibration_ledger_and_summary():
    led = CalibrationLedger()
    r1 = led.record("grad_sync", 1.0, alternative_s=2.0, chosen="plain", step=1)
    led.observe(r1, 1.5)
    r2 = led.record("grad_sync", 1.0, alternative_s=2.0, chosen="plain", step=2)
    led.observe(r2, 3.0)
    led.record("migration", 0.5)
    s = led.summary()
    assert s["grad_sync"]["n"] == 2 and s["grad_sync"]["n_observed"] == 2
    assert s["grad_sync"]["decisions"] == 2 and s["grad_sync"]["flips"] == 1
    assert s["grad_sync"]["ratio"] == pytest.approx((1.5 * 3.0) ** 0.5)
    assert s["migration"]["n_observed"] == 0 and s["migration"]["ratio"] is None
    records = [r.to_json() for r in led.records]
    assert summarize_records(records) == s == jax_obs.summarize_records(records)


def test_disabled_path_allocates_no_trace_objects():
    """Driving every hot-path hook against NULL_OBS allocates nothing
    attributable to the port's obs package."""
    ob = NULL_OBS
    filters = [tracemalloc.Filter(True, os.path.join(os.path.dirname(obslib.__file__), "*"))]

    def hot_loop(n):
        for _ in range(n):
            if ob.enabled:
                raise AssertionError("NULL_OBS must stay disabled")
            with ob.span("train_step", "train"):
                pass
            with ob.span("ckpt", "train"):
                pass
            ob.instant("sync_switch", "train")

    n = 1000
    hot_loop(10)
    gc.collect()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(filters)
        hot_loop(n)
        gc.collect()
        after = tracemalloc.take_snapshot().filter_traces(filters)
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "lineno") if s.size_diff > 0]
    total = sum(s.size_diff for s in grown)
    blocks = sum(s.count_diff for s in grown)
    assert total < 1024 and blocks < 8, grown[:5]


def test_provenance_stamp_shape():
    p = provenance(argv=["x", "--flag"])
    assert {"git_sha", "argv", "host", "python", "timestamp_utc", "suite_version"} <= set(p)
    assert p["argv"] == ["x", "--flag"]
    assert "T" in p["timestamp_utc"]
    assert json.dumps(p)


def test_log_levels_honor_env(monkeypatch, capsys):
    monkeypatch.delenv("REPRO_LOG_LEVEL", raising=False)
    log.info("hello")
    log.debug("quiet")
    err = capsys.readouterr().err
    assert "[repro:info] hello" in err and "quiet" not in err
    monkeypatch.setenv("REPRO_LOG_LEVEL", "silent")
    log.error("nope")
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("REPRO_LOG_LEVEL", "debug")
    log.debug("loud")
    assert "loud" in capsys.readouterr().err


def test_train_launcher_trace_smoke(tmp_path, capsys):
    """``--trace`` and ``--metrics`` on a small CPU run with checkpoints: a
    Perfetto-loadable trace with a ``train_step`` span per step, tagged with
    its step, a ``ckpt`` span per save, the JSONL beside it, and the
    registry's step histogram printed."""
    trace = tmp_path / "train_trace.json"
    train_launcher.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every",
                         "2", "--trace", str(trace), "--metrics"])
    events = load_chrome(str(trace))
    steps = [e for e in events if e["name"] == "train_step"]
    assert [e["step"] for e in steps] == [0, 1, 2] and all(e["dur"] > 0 for e in steps)
    assert [e["step"] for e in events if e["name"] == "ckpt"] == [0, 2]
    assert (tmp_path / "train_trace.jsonl").exists()
    out = capsys.readouterr()
    assert "trace written" in out.err
    metrics = json.loads(out.out[out.out.index("{"):out.out.index('{\n  "calibration"')])
    assert metrics["train.step_ms"]["count"] == 3 and metrics["train.straggler_steps"] == 0


def _two_session_turns(engine, vocab):
    """Two sessions, two turns each, the second waking both."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, vocab, (5,)).astype(np.int32) for _ in range(2)]
    rids = [engine.submit(p, 3, session_id=i) for i, p in enumerate(prompts)]
    out = engine.run()
    for i in range(2):
        engine.submit(np.concatenate([prompts[i], out[rids[i]]]), 2, session_id=i)
    engine.run()


def _events(ob):
    """(span or instant name, phase) -> count, calibration kind -> count."""
    names, kinds = {}, {}
    for e in ob.tracer.events:
        names[(e["name"], e["ph"])] = names.get((e["name"], e["ph"]), 0) + 1
    for r in ob.calibration.records:
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
    return names, kinds


def test_tiered_serving_records_wakeup_and_tier_transfer():
    """Two session turns through the tiered pool, in both packages on the
    same weights: the same prefill, decode and wakeup spans, demote and
    shed instants and cold_prefill, tier_transfer and wakeup calibration
    records, each closed with an observed wall; every wakeup record priced
    against the cold prefill it displaced; the pool's counters absorbed
    into ``serve.pool.*``, last write winning."""
    over = dict(compute_dtype="float32", remat=False, n_layers=2)
    cfg_j = dataclasses.replace(jax_get_config("internlm2-1.8b", reduced=True), **over)
    cfg_t = dataclasses.replace(get_config("internlm2-1.8b", reduced=True), **over)
    mj = jax_build_model(cfg_j)
    pj = mj.init(jax.random.PRNGKey(1))
    mt = build_model(cfg_t, device="cpu")
    pt = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj))

    ref_ob, ob = jax_obs.Obs(), Obs()
    ref = jax_serving.ContinuousBatchingEngine(
        mj, pj, n_slots=2, max_len=32, seed=0, policy="fcfs",
        tiers=jax_serving.TierConfig(host_sessions=8), obs=ref_ob)
    eng = ContinuousBatchingEngine(mt, pt, n_slots=2, max_len=32, seed=0, policy="fcfs",
                                   tiers=TierConfig(host_sessions=8), obs=ob)
    for e in (ref, eng):
        _two_session_turns(e, cfg_t.vocab)
        e.submit(np.ones((4,), np.int32), 2)
        e.submit(np.ones((4,), np.int32), 2, deadline=-1.0)  # dropped at the next step
        e.run(clock=lambda: 0.0)
        e.shed_queue(0)  # nothing queued: no instant
    assert _events(ob) == _events(ref_ob)
    names, kinds = _events(ob)
    assert kinds["wakeup"] == 2 and kinds["tier_transfer"] == 4 and names[("shed", "i")] == 1
    assert {("prefill", "X"), ("decode", "X"), ("wakeup", "X"), ("demote", "i")} <= set(names)
    for r in ob.calibration.records:
        assert r.observed_s is not None and r.observed_s >= 0
        if r.kind == "wakeup":
            assert r.alternative_s is not None and r.chosen == "wakeup"
    assert eng.metrics.wakeups == 2 and eng.metrics.deadline_drops == 1

    eng.absorb_pool_metrics()
    reg = ob.registry
    assert reg["serve.pool.n_demote"].value == eng.pool.n_demote == 4
    assert reg["serve.engine.wakeups"].value == 2
    eng.absorb_pool_metrics()  # idempotent, not additive
    assert reg["serve.pool.n_demote"].value == 4
    ref.absorb_pool_metrics()
    assert {k: v for k, v in reg.as_dict().items() if k.startswith("serve.pool.")} == \
        {k: v for k, v in ref_ob.registry.as_dict().items() if k.startswith("serve.pool.")}


def test_serve_launcher_tiered_trace_smoke(tmp_path, capsys):
    """``--tiered --turns 2 --trace --metrics`` at ``--reduced`` on the CPU:
    the tiers line, a trace with prefill, decode and wakeup spans and demote
    instants (with the JSONL beside it), and the metrics with the pool's
    counters absorbed."""
    trace = tmp_path / "serve_trace.json"
    serve_launcher.main(["--reduced", "--device", "cpu", "--tiered", "--turns", "2",
                         "--requests", "4", "--slots", "2", "--prompt-len", "8",
                         "--new-tokens", "4", "--host-sessions", "2", "--pooled-sessions", "1",
                         "--trace", str(trace), "--metrics"])
    names = {e["name"] for e in load_chrome(str(trace))}
    assert {"prefill", "decode", "wakeup", "demote"} <= names
    assert (tmp_path / "serve_trace.jsonl").exists()
    out = capsys.readouterr()
    assert "trace written" in out.err
    tiers = next(line for line in out.out.splitlines() if line.startswith("tiers:"))
    assert "demotions=8" in tiers and "wakeups=3" in tiers and "cold_resumes=1" in tiers
    metrics = json.loads(out.out[out.out.index("{"):out.out.index('{\n  "calibration"')])
    assert metrics["serve.pool.n_demote"] == 8 and metrics["serve.engine.wakeups"] == 3
    assert metrics["serve.pool.n_drop"] >= 1
