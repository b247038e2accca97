"""Collective cost model for the serving scheduler.

A pure-Python copy of the fields of the JAX package's
``core/collectives.py::CollectiveCostModel`` and of the hooks the
``cost_aware`` scheduler and the tiered KV pool call.  The constants
describe the TPU machine of that package (ICI and DCN links), not an H100:
on one card they only order admission, as they do there.  The tier prices
(``hbm_host_*``, a PCIe-class staging link; ``host_pooled_*``, a CXL-class
far-memory fabric) are modeled prices too, not measurements of this card's
host link: the tiered pool bills its transfers with them, and the
calibration ledger sets them beside the walls the transfers took.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CollectiveCostModel"]


@dataclasses.dataclass(frozen=True)
class CollectiveCostModel:
    ici_bw: float = 50e9
    dcn_bw: float = 6.25e9
    ici_latency: float = 1e-6
    dcn_latency: float = 10e-6
    quant_bw: float = 100e9
    hbm_host_bw: float = 16e9
    hbm_host_latency: float = 25e-6
    host_pooled_bw: float = 4e9
    host_pooled_latency: float = 150e-6
    prefill_s_per_token: float = 2e-5

    def flat_all_to_all(self, bytes_per_chip: float, n_low: int, n_pods: int) -> float:
        """Direct flows to every peer; cross-pod bytes ride the slow link."""
        group = n_low * n_pods
        cross = bytes_per_chip * (group - n_low) / group
        local = bytes_per_chip * (n_low - 1) / group
        wire = max(cross / self.dcn_bw, local / self.ici_bw) if n_pods > 1 else (
            local / self.ici_bw
        )
        lat = (n_low - 1) * self.ici_latency + (group - n_low) * self.dcn_latency
        return wire + lat

    def two_stage_all_to_all(self, bytes_per_chip: float, n_low: int, n_pods: int) -> float:
        """Aggregate inside the clique, then n_pods - 1 large bundle hops."""
        stage1 = bytes_per_chip * (n_low - 1) / n_low / self.ici_bw + (n_low - 1) * self.ici_latency
        stage2 = (
            bytes_per_chip * (n_pods - 1) / n_pods / self.dcn_bw
            + (n_pods - 1) * self.dcn_latency
            if n_pods > 1
            else 0.0
        )
        return stage1 + stage2

    _KV_TIERS = ("hbm", "host", "pooled")

    def tier_transfer_cost(self, nbytes: float, src: str, dst: str) -> float:
        """Modeled seconds to move ``nbytes`` of cache between memory tiers.
        Adjacent hops are hbm<->host and host<->pooled; an hbm<->pooled move
        pays both hops (store and forward)."""
        order = self._KV_TIERS
        if src not in order or dst not in order:
            raise ValueError(f"unknown tier in {src!r} -> {dst!r}; tiers are {order}")
        i, j = order.index(src), order.index(dst)
        hop_bw = (self.hbm_host_bw, self.host_pooled_bw)
        hop_lat = (self.hbm_host_latency, self.host_pooled_latency)
        return sum(nbytes / hop_bw[h] + hop_lat[h] for h in range(min(i, j), max(i, j)))

    def wakeup_cost(self, nbytes: float, tier: str = "host") -> float:
        """Modeled seconds to page a demoted session's cache row back into HBM."""
        return self.tier_transfer_cost(nbytes, tier, "hbm")

    def cold_prefill_cost(self, prompt_tokens: int) -> float:
        """Modeled seconds to build a cache by prefilling from scratch."""
        return max(float(prompt_tokens), 0.0) * self.prefill_s_per_token

    def moe_dispatch_cost(self, tokens: float, d_model: int, top_k: int, n_low: int,
                          n_pods: int, bytes_per_elem: float = 2.0,
                          hierarchical: bool = True) -> float:
        """Seconds for one MoE dispatch (or combine) all-to-all of ``tokens``
        activations of width ``d_model`` to ``top_k`` experts."""
        if tokens <= 0 or top_k <= 0:
            return 0.0
        chips = max(n_low, 1) * max(n_pods, 1)
        bytes_per_chip = tokens * top_k * d_model * bytes_per_elem / chips
        fn = self.two_stage_all_to_all if hierarchical else self.flat_all_to_all
        return fn(bytes_per_chip, n_low, n_pods)

    def decode_step_a2a_cost(self, batch: float, d_model: int, top_k: int, n_moe_layers: int,
                             n_low: int, n_pods: int, bytes_per_elem: float = 2.0,
                             hierarchical: bool = True) -> float:
        """All-to-all seconds of one decode step of ``batch`` co-scheduled
        requests: dispatch + combine per MoE layer."""
        if n_moe_layers <= 0 or batch <= 0:
            return 0.0
        one = self.moe_dispatch_cost(batch, d_model, top_k, n_low, n_pods, bytes_per_elem,
                                     hierarchical)
        return 2.0 * n_moe_layers * one

    def coschedule_gain(self, batch: int, d_model: int, top_k: int, n_moe_layers: int,
                        n_low: int, n_pods: int, bytes_per_elem: float = 2.0) -> float:
        """Per-request seconds saved by batching ``batch`` MoE-heavy requests
        into one decode step instead of ``batch`` separate steps."""
        if batch <= 1 or n_moe_layers <= 0:
            return 0.0
        solo = self.decode_step_a2a_cost(1, d_model, top_k, n_moe_layers, n_low, n_pods,
                                         bytes_per_elem)
        together = self.decode_step_a2a_cost(batch, d_model, top_k, n_moe_layers, n_low,
                                             n_pods, bytes_per_elem) / batch
        return solo - together
