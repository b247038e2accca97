"""Leveled stderr logger honoring ``REPRO_LOG_LEVEL`` (docs/OBSERVABILITY.md).

Replaces the ad-hoc ``print(...)`` progress lines in the launchers and
benchmarks so chaos-harness CI output stays quiet by default:

* ``debug`` — per-step/per-scenario progress chatter (hidden by default);
* ``info``  — run summaries and milestones (the default level);
* ``warn`` / ``error`` — always worth seeing.

``REPRO_LOG_LEVEL`` is re-read on every call (the launchers and tests set
it after import); data output that *is* the program's product — CSV rows,
JSON blobs — must stay on ``print``/stdout, not move here.
"""

from __future__ import annotations

import os
import sys

__all__ = ["log"]

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "silent": 100}


class _Log:
    __slots__ = ()

    @staticmethod
    def threshold() -> int:
        name = os.environ.get("REPRO_LOG_LEVEL", "info").strip().lower()
        return _LEVELS.get(name, 20)

    def _emit(self, level: int, tag: str, msg: str) -> None:
        if level >= self.threshold():
            print(f"[repro:{tag}] {msg}", file=sys.stderr)

    def debug(self, msg: str) -> None:
        self._emit(10, "debug", msg)

    def info(self, msg: str) -> None:
        self._emit(20, "info", msg)

    def warn(self, msg: str) -> None:
        self._emit(30, "warn", msg)

    def error(self, msg: str) -> None:
        self._emit(40, "error", msg)


log = _Log()
