"""MemoryOracle: the bridge from Shuhai measurements to framework decisions.

The paper's closing argument is that accurate memory characterization lets a
developer "select the best approach".  This module operationalizes that for
an accelerator framework: the oracle owns (a) the chip constants used by
the roofline analysis and (b) a *derating curve* for non-ideal access
patterns, obtained from the calibrated RST model — the paper's own claim
(Sec. IV-D) is that per-channel HBM characteristics generalize across
devices, so the relative efficiency curve transfers while the absolute
peak is the chip's.

The defaults are the reference's (``chip=TPU_V5E``, the U280 ``HBM``
model); ``MemoryOracle(chip=H100_SXM)`` spells the CUDA card.  Every
number the oracle returns is modeled — a data-sheet peak times the U280
model's derating — not a measurement.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

from repro_torch.core.address_mapping import get_mapping
from repro_torch.core.hwspec import HBM, TPU_V5E, ChipSpec, MemorySpec
from repro_torch.core.params import RSTParams
from repro_torch.core.timing_model import throughput


@dataclasses.dataclass(frozen=True)
class AccessPattern:
    """A stylized access descriptor the autotuner can score.

    burst_bytes: contiguous bytes fetched per access (innermost run).
    stride_bytes: distance between consecutive access starts.
    working_set_bytes: size of the region traversed repeatedly.
    """

    burst_bytes: int
    stride_bytes: int
    working_set_bytes: int

    def to_rst(self, spec: MemorySpec) -> RSTParams:
        def pow2_ceil(x):
            v = 1
            while v < x:
                v <<= 1
            return v
        # Cap the modeled burst: beyond 64 KiB a burst is fully sequential
        # and the per-byte cost is identical, so larger values only slow
        # the simulation without changing the efficiency estimate.
        b = max(spec.min_burst, min(pow2_ceil(self.burst_bytes), 1 << 16))
        w = max(pow2_ceil(self.working_set_bytes), 4 * b)
        s = min(max(b, pow2_ceil(self.stride_bytes)), w)
        return RSTParams(n=2048, b=b, s=s, w=w)


@dataclasses.dataclass(frozen=True)
class MemoryOracle:
    chip: ChipSpec = TPU_V5E
    reference_spec: MemorySpec = HBM

    # ---------------------------------------------------------- derating
    @functools.lru_cache(maxsize=4096)
    def _efficiency_cached(self, b: int, s: int, w: int) -> float:
        p = RSTParams(n=4096, b=b, s=s, w=w)
        mapping = get_mapping(self.reference_spec)
        res = throughput(p, mapping, self.reference_spec)
        return res.gbps / self.reference_spec.peak_channel_gbps

    def efficiency(self, pattern: AccessPattern) -> float:
        """Fraction of peak HBM bandwidth this pattern achieves (0..1]."""
        p = pattern.to_rst(self.reference_spec)
        return self._efficiency_cached(p.b, p.s, p.w)

    def effective_bandwidth(self, pattern: AccessPattern) -> float:
        """Bytes/s this pattern sustains on the target chip."""
        return self.efficiency(pattern) * self.chip.hbm_bandwidth

    # ---------------------------------------------------------- roofline terms
    def time_compute(self, flops: float, chips: int = 1) -> float:
        return flops / (chips * self.chip.peak_bf16_flops)

    def time_hbm(self, bytes_: float, chips: int = 1) -> float:
        return bytes_ / (chips * self.chip.hbm_bandwidth)

    def time_ici(self, collective_bytes: float, chips: int = 1) -> float:
        return collective_bytes / (chips * self.chip.ici_link_bandwidth)

    def roofline_terms(self, flops: float, hbm_bytes: float,
                       collective_bytes: float, chips: int
                       ) -> Dict[str, float]:
        terms = {
            "compute_s": self.time_compute(flops, chips),
            "memory_s": self.time_hbm(hbm_bytes, chips),
            "collective_s": self.time_ici(collective_bytes, chips),
        }
        terms["dominant"] = max(
            ("compute_s", "memory_s", "collective_s"), key=terms.get)
        return terms

    # ---------------------------------------------------------- sizing helpers
    def arithmetic_intensity_needed(self) -> float:
        """FLOP/byte needed to be compute-bound (the v5e ridge point)."""
        return self.chip.ridge_intensity

    def hbm_fits(self, bytes_per_device: float, slack: float = 0.9) -> bool:
        return bytes_per_device <= self.chip.hbm_bytes * slack
