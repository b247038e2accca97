"""Unified tracing, metrics, and cost-model calibration (docs/OBSERVABILITY.md).

The port's copy of the JAX package's ``obs`` package (module for module;
it imports no JAX), so that the port's launchers and hosts trace without
reaching into the reference.

One :class:`Obs` bundle threads through the training orchestrator, the
serving orchestrator/engine, and the simulator scenario engine:

* ``obs.tracer`` — span tracing (:mod:`repro_torch.obs.trace`), exportable as
  JSONL and Chrome/Perfetto ``trace_event`` JSON;
* ``obs.registry`` — the :class:`~repro_torch.obs.metrics.MetricsRegistry` the
  report classes view into;
* ``obs.calibration`` — the predicted-vs-observed
  :class:`~repro_torch.obs.calibration.CalibrationLedger` behind the
  EXPERIMENTS.md calibration table;
* ``obs.log`` — the leveled stderr logger (``REPRO_LOG_LEVEL``).

Disabled (the default ``NULL_OBS``), every hook costs one attribute check:
hot loops guard with ``if obs.enabled:``, and unconditional ``obs.span(...)``
calls return the preallocated ``NULL_SPAN`` without constructing anything
(the overhead guard in ``tests/test_torch_obs.py`` pins this with tracemalloc).

Hosts accept an ``obs=`` argument defaulting to :func:`get_obs`, the
process-wide current bundle the launchers install via :func:`set_obs`
when ``--trace``/``--metrics`` is passed.
"""

from __future__ import annotations

from .calibration import CalibrationLedger, CalibrationRecord, summarize_records
from .logging import log
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .provenance import SUITE_VERSION, provenance
from .trace import NULL_SPAN, Span, Tracer, load_chrome, load_jsonl

__all__ = [
    "CalibrationLedger",
    "CalibrationRecord",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_OBS",
    "NULL_SPAN",
    "Obs",
    "SUITE_VERSION",
    "Span",
    "Tracer",
    "get_obs",
    "load_chrome",
    "load_jsonl",
    "log",
    "provenance",
    "set_obs",
    "summarize_records",
]


class Obs:
    """The bundle hosts thread around.  ``enabled=False`` builds the null
    bundle: no tracer/registry/ledger is constructed, and every hook is a
    no-op behind a single attribute check."""

    __slots__ = ("enabled", "tracer", "registry", "calibration")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.tracer = Tracer() if enabled else None
        self.registry = MetricsRegistry() if enabled else None
        self.calibration = CalibrationLedger() if enabled else None

    # deliberately no **kwargs on either hook: a kwargs dict would be
    # allocated even on the disabled path (and pinned by the dict free
    # list, which the overhead guard flags).  Attribute-carrying spans and
    # instants go through ``obs.tracer`` behind an ``if obs.enabled:``.
    def span(self, name: str, cat: str = "runtime"):
        if not self.enabled:
            return NULL_SPAN
        return self.tracer.span(name, cat)

    def instant(self, name: str, cat: str = "runtime") -> None:
        if self.enabled:
            self.tracer.instant(name, cat)


NULL_OBS = Obs(enabled=False)

_CURRENT: Obs = NULL_OBS


def get_obs() -> Obs:
    """The process-wide current bundle (``NULL_OBS`` unless a launcher or
    test installed one) — the default for every host's ``obs=`` argument."""
    return _CURRENT


def set_obs(obs: Obs | None) -> Obs:
    """Install ``obs`` as the process-wide bundle (``None`` restores the
    null bundle).  Returns what was installed."""
    global _CURRENT
    _CURRENT = obs if obs is not None else NULL_OBS
    return _CURRENT
