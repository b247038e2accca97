"""Deterministic synthetic LM data pipeline.

A copy of the JAX package's ``data/pipeline.py``: numpy only, so its
batches are the same bytes.

Design goals mirror a production pipeline at 1000-node scale:

* **Stateless indexing** — batch ``i`` is a pure function of (seed, i), so
  resume-after-failure is exact *skip-ahead* (no pipeline state to
  checkpoint beyond the step counter), and any host can compute any shard.
* **Shard-aware** — ``host_batch(step, host_id, n_hosts)`` returns only the
  host's slice; identical global batch regardless of host count (elastic
  re-mesh keeps the data order).
* **Structured tokens** — sequences follow a repeating-ngram language so a
  ~100M model shows a clearly decreasing loss in the end-to-end example
  (pure-uniform tokens would have constant loss = log V).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "Batch"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram: int = 3  # order of the synthetic Markov structure

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row])
        )

    def _sequence(self, step: int, row: int) -> np.ndarray:
        """Markov chain whose transition table is derived from small hash
        mixing — deterministic, vocabulary-wide, learnable."""
        rng = self._rng(step, row)
        v = self.vocab
        toks = np.empty(self.seq_len + 1, dtype=np.int64)
        toks[0] = rng.integers(0, v)
        # mixing constants (fixed across the dataset => learnable structure)
        a, b, c = 1103515245, 12345, max(v - 1, 1)
        noise = rng.random(self.seq_len)
        jump = rng.integers(0, v, size=self.seq_len)
        for t in range(self.seq_len):
            nxt = (toks[t] * a + b) % v
            toks[t + 1] = nxt if noise[t] < 0.9 else jump[t]
        return toks

    def global_batch_arrays(self, step: int) -> dict[str, np.ndarray]:
        rows = [self._sequence(step, r) for r in range(self.global_batch)]
        arr = np.stack(rows)
        return {
            "tokens": arr[:, :-1].astype(np.int32),
            "targets": arr[:, 1:].astype(np.int32),
        }

    def replay(self, start: int, stop: int):
        """Deterministic skip-ahead: yield (step, batch) for steps
        ``start .. stop-1``.  Because batch = f(seed, step), replay after a
        fault (from the step boundary the orchestrator resumes at, or from a
        restored checkpoint step) regenerates byte-identical batches with no
        pipeline state to restore."""
        for step in range(start, stop):
            yield step, self.global_batch_arrays(step)

    def host_batch(self, step: int, host_id: int, n_hosts: int) -> dict[str, np.ndarray]:
        assert self.global_batch % n_hosts == 0
        per = self.global_batch // n_hosts
        rows = [self._sequence(step, host_id * per + r) for r in range(per)]
        arr = np.stack(rows)
        return {
            "tokens": arr[:, :-1].astype(np.int32),
            "targets": arr[:, 1:].astype(np.int32),
        }


Batch = dict
