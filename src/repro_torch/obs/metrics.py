"""Named counters/gauges/histograms (docs/OBSERVABILITY.md).

A :class:`MetricsRegistry` is the single home for the run counters that
used to live as ad-hoc fields on ``OrchestratorReport`` / ``ServingReport``
/ ``EngineMetrics`` and as bare attributes on the KV pools.  The report
classes are now thin views: each scalar field is a property over a
registry metric (``train.useful_steps``, ``serve.tokens``, …), so the same
number has exactly one storage location and ``--metrics`` can dump the
whole run state uniformly.

All three metric kinds expose a plain ``.value`` (histograms expose a
summary dict), use ``__slots__``, and never allocate on update beyond the
Python numbers themselves — the disabled-path overhead guard in
``tests/test_torch_obs.py`` depends on that.
"""

from __future__ import annotations

import json

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry_field"]


class Counter:
    """A monotonically-driven number (int or float).  ``value`` is directly
    assignable so legacy ``report.field = x`` writes keep working."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value

    def inc(self, n=1):
        self.value += n
        return self.value


class Gauge:
    """A last-write-wins sample (queue depth, link factor, wall seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0.0):
        self.name = name
        self.value = value

    def set(self, v):
        self.value = v
        return v


class Histogram:
    """Streaming min/max/sum/count — enough for throughput and latency
    summaries without keeping every sample."""

    __slots__ = ("name", "count", "total", "vmin", "vmax")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def observe(self, v):
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    @property
    def value(self) -> dict:
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics.  Re-requesting a name
    returns the existing object; asking for it as a different kind raises
    (that is the deduplication contract — one name, one storage cell)."""

    def __init__(self):
        self._metrics: dict = {}

    # ------------------------------------------------------------ factories

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}"
            )
        return m

    def counter(self, name: str, initial=0) -> Counter:
        return self._get(name, Counter, initial)

    def gauge(self, name: str, initial=0.0) -> Gauge:
        return self._get(name, Gauge, initial)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # ------------------------------------------------------------ access

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def absorb(self, prefix: str, mapping: dict) -> None:
        """Copy a plain ``{name: number}`` dict (e.g. ``KVPool`` counter
        attributes) into namespaced counters — last write wins, so
        re-absorbing after a migration refreshes rather than duplicates."""
        for k, v in mapping.items():
            self.counter(f"{prefix}.{k}").value = v

    def as_dict(self) -> dict:
        """``{name: value}`` snapshot, sorted by name; histograms render as
        their summary dict."""
        return {name: self._metrics[name].value for name in self.names()}

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), indent=2, sort_keys=True)


def registry_field(metric: str):
    """Property factory for the report classes: exposes registry metric
    ``metric`` as a plain read/write attribute on any object carrying a
    ``registry`` — the thin-view contract that keeps legacy report fields
    (``report.useful_steps += 1``) bit-compatible while the registry owns
    the storage."""

    def _get(self):
        return self.registry[metric].value

    def _set(self, v):
        self.registry[metric].value = v

    return property(_get, _set)
