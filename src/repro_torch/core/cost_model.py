"""Collective cost model: the prices of the gradient sync, the MoE
all-to-all and the KV tiers.

A pure-Python copy of the JAX package's
``core/collectives.py::CollectiveCostModel``, re-exported from
``core/collectives.py`` as there.  Its constants are the reference's
*modeled* values for the TPU machine of that package (ICI links inside a
pod, DCN links across pods, an int8 quantise rate), not facts about an
H100 or its host: on one card they only order choices, as they do there.
The ``cost_aware`` scheduler prices admission with the all-to-all hooks;
the grad-sync hooks (``flat_all_reduce``, ``hierarchical_all_reduce``,
``grad_sync_cost``, ``degraded``) price the trainer's sync tiers, and
``chip_smoke.py`` sets their byte terms beside the bytes the collectives
counted.  The tier prices (``hbm_host_*``, a PCIe-class staging link;
``host_pooled_*``, a CXL-class far-memory fabric) are modeled prices too,
not measurements of this card's host link: the tiered pool bills its
transfers with them, and the calibration ledger sets them beside the walls
the transfers took.
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

    def degraded(self, dcn_factor: float) -> "CollectiveCostModel":
        """The same machine with the scarce top-level links at ``dcn_factor``
        of their nominal bandwidth (a top-level bundle fault)."""
        if not 0.0 < dcn_factor:
            raise ValueError(f"dcn_factor must be positive, got {dcn_factor}")
        return dataclasses.replace(self, dcn_bw=self.dcn_bw * dcn_factor)

    def flat_all_reduce(self, bytes_per_chip: float, n_low: int, n_pods: int) -> float:
        """Ring all-reduce over the whole (low x pod) group: every byte
        crosses the pod boundary about once; the slow link bounds it."""
        group = n_low * n_pods
        wire = 2.0 * bytes_per_chip * (group - 1) / group
        bw = self.dcn_bw if n_pods > 1 else self.ici_bw
        lat = self.dcn_latency if n_pods > 1 else self.ici_latency
        return wire / bw + 2 * (group - 1) * lat

    def hierarchical_all_reduce(self, bytes_per_chip: float, n_low: int, n_pods: int,
                                compress_ratio: float = 1.0) -> float:
        """Reduce-scatter over the low axis, an all-reduce of the 1/n_low
        shard (times ``compress_ratio``) across the pods, all-gather back."""
        rs = bytes_per_chip * (n_low - 1) / n_low / self.ici_bw + (n_low - 1) * self.ici_latency
        shard = bytes_per_chip / n_low * compress_ratio
        ar_high = (
            2.0 * shard * (n_pods - 1) / n_pods / self.dcn_bw
            + 2 * (n_pods - 1) * self.dcn_latency
            if n_pods > 1
            else 0.0
        )
        ag = bytes_per_chip * (n_low - 1) / n_low / self.ici_bw + (n_low - 1) * self.ici_latency
        return rs + ar_high + ag

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

    def grad_sync_cost(self, bytes_per_chip: float, n_low: int, n_pods: int,
                       compressed: bool = False, compress_ratio: float = 0.26) -> float:
        """Seconds of one staged gradient sync.  With ``compressed`` the
        cross-pod shard moves int8 and a scale (``compress_ratio`` of the
        fp32 bytes) but pays a quantise and a dequantise pass over the shard
        at ``quant_bw``."""
        base = self.hierarchical_all_reduce(
            bytes_per_chip, n_low, n_pods,
            compress_ratio=compress_ratio if compressed else 1.0)
        if not compressed or n_pods <= 1:
            return base
        shard = bytes_per_chip / max(n_low, 1)
        return base + 2.0 * shard / self.quant_bw

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

    def migration_cost(self, nbytes: float, overhead_s: float = 0.0) -> float:
        """Modeled seconds to move ``nbytes`` of live state onto a new mesh:
        a device -> host -> device round trip over the staging link, plus a
        flat ``overhead_s``."""
        return (2.0 * (max(nbytes, 0.0) / self.hbm_host_bw + self.hbm_host_latency)
                + max(overhead_s, 0.0))

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
