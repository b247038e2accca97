"""Run provenance stamp (docs/OBSERVABILITY.md).

Every ``BENCH_*.json`` artifact carries a ``provenance`` dict so a number
in EXPERIMENTS.md can be traced back to the commit, host, and command line
that produced it.  Readers must tolerate (ignore) the key — it is additive
metadata, never load-bearing.
"""

from __future__ import annotations

import platform
import subprocess
import sys
from datetime import datetime, timezone
from pathlib import Path

__all__ = ["SUITE_VERSION", "provenance"]

# bumped when the bench suite's scenario set or output schema changes shape
SUITE_VERSION = "9"


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=Path(__file__).resolve().parents[3],
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def provenance(argv=None) -> dict:
    """The stamp written into bench artifacts: enough to reproduce the run
    (commit + argv) and to spot environment drift (host + python)."""
    return {
        "git_sha": _git_sha(),
        "argv": list(sys.argv if argv is None else argv),
        "host": platform.node(),
        "python": sys.version.split()[0],
        "timestamp_utc": datetime.now(timezone.utc).isoformat(),
        "suite_version": SUITE_VERSION,
    }
