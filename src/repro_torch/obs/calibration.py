"""Cost-model calibration ledger (docs/OBSERVABILITY.md).

Every time a :class:`~repro_torch.core.cost_model.CollectiveCostModel`
prediction gates a runtime decision — grad-sync tiering, straggler-drain
pricing, KV tier transfers, wakeup-vs-cold-prefill admission, migration
pricing — the deciding site records the predicted seconds (and, for
either/or decisions, the alternative it was weighed against).  When the
decision's real cost is later measurable, :meth:`CalibrationLedger.observe`
closes the record with observed seconds.

:meth:`CalibrationLedger.summary` folds the records per decision kind into
the calibration table ``benchmarks/make_report.py`` renders into
EXPERIMENTS.md:

* ``ratio``  — geometric mean of observed/predicted (1.0 = perfectly
  calibrated; >1 the model is optimistic, <1 pessimistic);
* ``bias``   — mean log10 of that ratio (signed orders of magnitude);
* ``flips``  — decisions that would have gone the *other way* had the
  observed cost been known when the predicted one was used (only defined
  for records carrying an ``alternative_s``).
"""

from __future__ import annotations

import json
import math

__all__ = ["CalibrationLedger", "CalibrationRecord", "summarize_records"]


class CalibrationRecord:
    """One priced decision.  ``observed_s`` stays ``None`` until the real
    cost lands (some decisions — a drain *tolerated* — never execute the
    priced action, so their records legitimately close unobserved)."""

    __slots__ = (
        "kind", "predicted_s", "alternative_s", "chosen",
        "observed_s", "step", "note",
    )

    def __init__(self, kind, predicted_s, alternative_s=None, chosen=None,
                 step=-1, note=""):
        self.kind = kind
        self.predicted_s = float(predicted_s)
        self.alternative_s = None if alternative_s is None else float(alternative_s)
        self.chosen = chosen
        self.observed_s = None
        self.step = step
        self.note = note

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "predicted_s": self.predicted_s,
            "alternative_s": self.alternative_s,
            "chosen": self.chosen,
            "observed_s": self.observed_s,
            "step": self.step,
            "note": self.note,
        }


class CalibrationLedger:
    """Append-only list of :class:`CalibrationRecord`."""

    def __init__(self):
        self.records: list[CalibrationRecord] = []

    def record(self, kind: str, predicted_s: float, alternative_s=None,
               chosen=None, step: int = -1, note: str = "") -> CalibrationRecord:
        rec = CalibrationRecord(kind, predicted_s, alternative_s, chosen,
                                step, note)
        self.records.append(rec)
        return rec

    @staticmethod
    def observe(rec: CalibrationRecord, observed_s: float) -> CalibrationRecord:
        rec.observed_s = float(observed_s)
        return rec

    def kinds(self) -> list[str]:
        return sorted({r.kind for r in self.records})

    def summary(self) -> dict:
        return summarize_records(self.records)

    def to_json(self) -> dict:
        return {
            "records": [r.to_json() for r in self.records],
            "summary": self.summary(),
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return path


def summarize_records(records) -> dict:
    """Per-kind calibration stats over record objects *or* their
    ``to_json`` dicts (so ``make_report.py`` can fold a BENCH_*.json blob
    without importing the runtime)."""
    by_kind: dict[str, list] = {}
    for r in records:
        if isinstance(r, dict):
            kind, pred = r["kind"], r["predicted_s"]
            obs, alt = r.get("observed_s"), r.get("alternative_s")
        else:
            kind, pred = r.kind, r.predicted_s
            obs, alt = r.observed_s, r.alternative_s
        by_kind.setdefault(kind, []).append((pred, obs, alt))
    out = {}
    for kind, rows in sorted(by_kind.items()):
        n_observed = 0
        log_ratios = []
        flips = 0
        n_decisions = 0
        for pred, obs, alt in rows:
            if obs is not None:
                n_observed += 1
                if pred > 0 and obs > 0:
                    log_ratios.append(math.log10(obs / pred))
                if alt is not None:
                    n_decisions += 1
                    if (pred < alt) != (obs < alt):
                        flips += 1
        bias = sum(log_ratios) / len(log_ratios) if log_ratios else None
        out[kind] = {
            "n": len(rows),
            "n_observed": n_observed,
            "ratio": (10.0 ** bias) if bias is not None else None,
            "bias_log10": bias,
            "decisions": n_decisions,
            "flips": flips,
        }
    return out
