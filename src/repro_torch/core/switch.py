"""Model of the inter-channel switch in front of a memory fabric (Sec. VI).

The switch behavior is topology-parametric: a :class:`SwitchModel` wraps any
:class:`~repro_torch.core.channels.SwitchTopology` (the U280 crossbar, the modeled
HBM3-class fabric, a flat DDR-style fabric — see ``core/channels.py``) and
reproduces the paper's measured switch facts for it:

* Enabling the switch costs a flat per-spec penalty even for local access
  (footnote 9: Table VI channel 0-3 page hit = 55 = 48 + 7 on the U280).
* Crossing mini-switches adds distance-dependent latency from the
  topology's crossing table (Table VI: up to 22 cycles on the U280); all
  AXI channels of one mini-switch see identical latency (the mini-switch
  is fully implemented).
* Throughput is location-independent for a *single* requester (Fig. 8): the
  switch is non-blocking on the datapath, in both traffic directions.
* With the switch disabled, an AXI channel can only reach its own pseudo
  channel (Sec. II) — enforced by :meth:`SwitchModel.check_reachable` on
  every topology, not just the U280's.

Beyond the paper's single-requester measurements, the switch is where
*cross-channel contention* lives (DESIGN.md §9).  Multi-engine traffic
shares two fabric resources the single-requester experiments never
saturate, exposed here as placement-dependent capacity caps
(:meth:`SwitchModel.capacity_cap_gbps`):

* ``same_switch`` — engines on different channels of one mini-switch share
  its internal aggregate datapath (``SwitchTopology.switch_agg_gbps``; a
  full crossbar on the U280, a binding shared datapath on the modeled
  HBM3 fabric);
* ``cross_switch`` — engines whose address windows land on channels of a
  *different* mini-switch additionally serialize on the lateral bridge
  between adjacent switches (``SwitchTopology.lateral_gbps``) — the term
  that moves real multi-PE designs between ~90% and ~30% of nominal
  bandwidth (Choi et al. 2020).

``Engine.evaluate_contention(placement=...)`` distributes engines over a
mini-switch's ports, runs each port through the DRAM-side contention model
(``timing_model.contended_throughput``) and applies these caps to the
aggregate; ``same_channel`` placement never consults them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.channels import U280_CROSSBAR, SwitchTopology

# Where a multi-engine layout's address windows land, relative to the
# issuing engines' mini-switch (DESIGN.md §9).
PLACEMENTS = ("same_channel", "same_switch", "cross_switch")


@dataclasses.dataclass(frozen=True)
class SwitchModel:
    topology: SwitchTopology = U280_CROSSBAR
    enabled: bool = True

    def check_reachable(self, axi_channel: int, pseudo_channel: int) -> None:
        if self.enabled:
            self.topology._check(axi_channel)
            self.topology._check(pseudo_channel)
            return
        if self.topology.local_pseudo_channel(axi_channel) != pseudo_channel:
            raise PermissionError(
                f"switch disabled: AXI channel {axi_channel} can only access "
                f"pseudo channel {axi_channel}, not {pseudo_channel} "
                f"(topology {self.topology.name})")

    def distance_extra_cycles(self, axi_channel: int, pseudo_channel: int) -> int:
        """Distance-dependent extra latency (on top of the flat switch
        penalty), per the topology's crossing table (Table VI style)."""
        self.check_reachable(axi_channel, pseudo_channel)
        if not self.enabled:
            return 0
        return self.topology.crossing_extra_cycles(axi_channel, pseudo_channel)

    def total_extra_cycles(self, axi_channel: int, pseudo_channel: int) -> int:
        """Flat penalty + distance; what serial latency runs consume."""
        if not self.enabled:
            self.check_reachable(axi_channel, pseudo_channel)
            return 0
        return self.distance_extra_cycles(axi_channel, pseudo_channel)

    def throughput_scale(self, axi_channel: int, pseudo_channel: int) -> float:
        """Fig. 8: single-requester throughput does not depend on location
        (reads and writes alike — the datapath is non-blocking)."""
        self.check_reachable(axi_channel, pseudo_channel)
        return 1.0

    # -- multi-engine capacity terms (DESIGN.md §9) --------------------------
    def capacity_cap_gbps(self, placement: str) -> Optional[float]:
        """The fabric-side cap on a multi-engine *aggregate* for a placement.

        ``same_channel`` traffic never touches the fabric's shared
        resources beyond its own port (the DRAM-side model already clamps
        at the port's wire rate) — no cap.  ``same_switch`` aggregates are
        bounded by the mini-switch's internal datapath; ``cross_switch``
        aggregates additionally serialize on the lateral bridge, so the
        *tighter* of the two terms applies.  Returns ``None`` when the
        placement is uncapped (flat fabrics leave both terms unset).

        On the measured U280 the caps reproduce Fig. 8's location-
        independent single-requester throughput automatically: the
        lateral bridge is a full channel width, so one stream is never
        capped.  A fabric modeled with *narrower* bridges (the HBM3
        instance) honestly caps even a single crossing stream — the
        Fig. 8 fact is a property of the U280's bridge width, not of the
        model.
        """
        if placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {placement!r}; valid: {PLACEMENTS}")
        if placement == "same_channel":
            return None
        caps = [self.topology.switch_agg_gbps]
        if placement == "cross_switch":
            caps.append(self.topology.lateral_gbps)
        caps = [c for c in caps if c is not None]
        return min(caps) if caps else None

    def can_cross_switch(self) -> bool:
        """Whether the fabric has a second mini-switch to cross at all —
        flat (single-switch) fabrics degrade cross_switch to same_switch."""
        return self.topology.mini_switches > 1
