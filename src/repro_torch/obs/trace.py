"""Span tracing (docs/OBSERVABILITY.md).

A :class:`Tracer` records *spans* — named wall-clock intervals tagged with
the host's monotonic step index — and *instants* (point events).  Hosts
open spans around every state transition (``remesh``, ``migrate``,
``sync_switch``, ``shed``, ``ckpt``, ``prefill``, ``decode``, ``demote``,
``wakeup``, …; the taxonomy lives in docs/OBSERVABILITY.md) and the
resulting event list exports two ways:

* :meth:`Tracer.export_jsonl` — one JSON object per line, seconds since
  the tracer epoch; the lossless archival format (:func:`load_jsonl`).
* :meth:`Tracer.export_chrome` — Chrome/Perfetto ``trace_event`` JSON
  (``{"traceEvents": [...]}``, microsecond timestamps, one ``tid`` lane
  per category) loadable in ``ui.perfetto.dev`` / ``chrome://tracing``
  (:func:`load_chrome` re-parses it back to event dicts).

Zero-cost discipline: the disabled path never reaches this module — the
:class:`~repro_torch.obs.Obs` bundle returns the preallocated :data:`NULL_SPAN`
singleton (whose ``__enter__``/``__exit__`` allocate nothing) without
constructing a tracer at all.  The overhead guard in ``tests/test_torch_obs.py``
pins this with ``tracemalloc``.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "load_chrome",
    "load_jsonl",
]


class _NullSpan:
    """Shared do-nothing span: ``with NULL_SPAN:`` costs two method calls
    and zero allocations."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """A live span; append-on-exit so a crash inside the body still leaves
    the tracer consistent (the unfinished span simply never lands)."""

    __slots__ = ("_tracer", "name", "cat", "step", "args", "_t0")

    def __init__(self, tracer, name, cat, step, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.step = step
        self.args = args

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. migrated slot count)."""
        if self.args is None:
            self.args = attrs
        else:
            self.args.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._tracer._finish(self, time.monotonic())
        return False


class Tracer:
    """Collects span/instant events relative to a single epoch.

    ``step`` is a host-settable monotonic index (training step or serving
    scheduling round); every event records the value current when it was
    *opened*.  Thread-safe appends: the serving engine and the async
    checkpointer may finish spans concurrently.
    """

    def __init__(self):
        self.events: list[dict] = []
        self.step = -1
        self._epoch_mono = time.monotonic()
        self._epoch_wall = time.time()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ recording

    def span(self, name: str, cat: str = "runtime", **attrs) -> Span:
        return Span(self, name, cat, self.step, attrs or None)

    def _finish(self, span: Span, t1: float) -> None:
        ev = {
            "name": span.name,
            "ph": "X",
            "cat": span.cat,
            "ts": span._t0 - self._epoch_mono,
            "dur": t1 - span._t0,
            "step": span.step,
        }
        if span.args:
            ev["args"] = span.args
        with self._lock:
            self.events.append(ev)

    def instant(self, name: str, cat: str = "runtime", **attrs) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "cat": cat,
            "ts": time.monotonic() - self._epoch_mono,
            "step": self.step,
        }
        if attrs:
            ev["args"] = attrs
        with self._lock:
            self.events.append(ev)

    # ------------------------------------------------------------ export

    def export_jsonl(self, path: str) -> str:
        """One event per line; a leading ``meta`` line carries the epoch so
        offsets can be re-anchored to wall-clock time."""
        with self._lock:
            events = list(self.events)
        with open(path, "w") as f:
            meta = {"meta": {"epoch_wall": self._epoch_wall, "n_events": len(events)}}
            f.write(json.dumps(meta) + "\n")
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        return path

    def export_chrome(self, path: str) -> str:
        """Chrome/Perfetto ``trace_event`` format: ``X`` (complete) and
        ``i`` (instant) events, µs timestamps, one ``tid`` lane per
        category plus ``M`` metadata rows naming the lanes."""
        with self._lock:
            events = list(self.events)
        pid = os.getpid()
        lanes: dict[str, int] = {}
        out = []
        for ev in events:
            cat = ev.get("cat", "runtime")
            tid = lanes.setdefault(cat, len(lanes))
            args = dict(ev.get("args") or {})
            args["step"] = ev.get("step", -1)
            rec = {
                "name": ev["name"],
                "ph": ev["ph"],
                "cat": cat,
                "ts": round(ev["ts"] * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
            if ev["ph"] == "X":
                rec["dur"] = round(ev["dur"] * 1e6, 3)
            elif ev["ph"] == "i":
                rec["s"] = "t"  # thread-scoped instant
            out.append(rec)
        meta = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "repro"}},
        ]
        for cat, tid in lanes.items():
            meta.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": cat}}
            )
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + out, "displayTimeUnit": "ms"}, f)
        return path


# ---------------------------------------------------------------- re-parse


def load_jsonl(path: str) -> list[dict]:
    """Re-parse :meth:`Tracer.export_jsonl` output (meta line skipped)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "meta" in obj:
                continue
            events.append(obj)
    return events


def load_chrome(path: str) -> list[dict]:
    """Re-parse :meth:`Tracer.export_chrome` output back to event dicts in
    tracer units (seconds); ``M`` metadata rows are dropped.  Validates the
    envelope a Perfetto/Chrome loader requires (``traceEvents`` list,
    numeric ``ts``/``dur``)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError(f"{path}: not a trace_event JSON (no traceEvents list)")
    events = []
    for rec in doc["traceEvents"]:
        ph = rec.get("ph")
        if ph not in ("X", "i"):
            continue
        if not isinstance(rec.get("ts"), (int, float)):
            raise ValueError(f"{path}: event {rec.get('name')!r} has no numeric ts")
        args = dict(rec.get("args") or {})
        ev = {
            "name": rec["name"],
            "ph": ph,
            "cat": rec.get("cat", "runtime"),
            "ts": rec["ts"] / 1e6,
            "step": args.pop("step", -1),
        }
        if ph == "X":
            if not isinstance(rec.get("dur"), (int, float)):
                raise ValueError(f"{path}: span {rec.get('name')!r} has no dur")
            ev["dur"] = rec["dur"] / 1e6
        if args:
            ev["args"] = args
        events.append(ev)
    return events
