"""Parametric switch-fabric topologies between AXI channels and memory.

The paper describes one concrete fabric — the U280's HBM subsystem (Sec. II,
Fig. 1): two HBM2 stacks -> 16 memory channels -> 32 pseudo channels, 32 AXI
channels served by eight fully-implemented mini-switches of 4 AXI channels
each, adjacent mini-switches bridged for global addressing.  Its closing
claim is that the design generalizes to other boards and memory generations,
so the fabric is a *parameter* here, not a constant:

* :class:`SwitchTopology` describes any such fabric —
  ``(num_stacks, mini_switches, axi_per_switch, crossing latency table)`` —
  and computes Table-VI-style distance latencies for it.
* :class:`CrossingLatencyTable` holds the measured/modeled extra cycles for
  crossing mini-switches (same-stack table + cross-stack base/step).
* Two *capacity* terms bound multi-engine aggregates (DESIGN.md §9):
  ``switch_agg_gbps`` is the mini-switch's internal aggregate datapath
  (a full crossbar on the U280 — present but non-binding, matching the
  non-blocking single-requester datapath of Fig. 8), and ``lateral_gbps``
  is the bridge between adjacent mini-switches that cross-switch traffic
  serializes on — the term that collapses cross-switch multi-engine
  layouts to a fraction of nominal (Choi et al. 2020).  ``None`` means
  unconstrained (flat DDR fabrics have neither).
* A registry attaches one topology to each registered
  :class:`~repro_torch.core.hwspec.MemorySpec` by name
  (:func:`register_topology` / :func:`topology_for`), mirroring the spec and
  policy registries of DESIGN.md §6/§7.

Three proof instances ship registered: the U280 8×4 crossbar (measured,
Table VI), a modeled HBM3-class fabric (two stacks of eight 2-channel
switches over the 16-channel HBM3 stacks), and flat DDR-style fabrics for
the DDR4/DDR3 controllers (no switch: every engine owns its channel).
`HBMTopology` / `DDR4Topology` remain as deprecated accessors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.hwspec import HBM, HBM3, MemorySpec

# U280 constants, kept for readers of the paper (Sec. II) and for the
# registered U280 instance below.
NUM_STACKS = 2
MEM_CHANNELS_PER_STACK = 8
PSEUDO_PER_MEM_CHANNEL = 2
NUM_AXI_CHANNELS = 32
AXI_PER_MINI_SWITCH = 4
NUM_MINI_SWITCHES = NUM_AXI_CHANNELS // AXI_PER_MINI_SWITCH  # 8

# ---------------------------------------------------------------------------
# Published calibration anchors (DESIGN.md §13 calibration table).  The
# capacity terms registered below are *derived* from these, and
# tests/core/test_calibration.py pins model outputs against them with
# explicit tolerances — changing a term means changing its anchor (or its
# derivation), never a bare magic number.
# ---------------------------------------------------------------------------

#: U280 pseudo-channel wire rate: 64-bit pseudo channel at 1800 MT/s
#: (HBM2 @ 900 MHz DDR, paper Sec. II) = 14.4 GB/s.  Matches
#: ``HBM.peak_channel_gbps`` by construction.
U280_CHANNEL_WIRE_GBPS = 14.4

#: Shuhai Table V: measured sequential-read throughput of one U280
#: channel, 13.27 GB/s (92.2% of wire rate).  The timing model's
#: sequential operating point must land within 1% of this.
SHUHAI_TABLE5_SEQ_GBPS = 13.27

#: Choi et al. 2020 ("When HLS Meets FPGA HBM"): multi-engine layouts
#: swing between ~30% (switch-crossing placements serialized on the
#: lateral bridge) and ~90% (well-placed) of nominal aggregate.
CHOI_CROSS_SWITCH_FRACTION = 0.30
CHOI_WELL_PLACED_FRACTION = 0.90

#: HBM3 fabric derivation ratios (modeled, Sec. VII generalization): the
#: finer 2-channel mini-switch shares one internal datapath at 1.5x the
#: channel wire rate, and its lateral bridges carry half a channel.
HBM3_AGG_RATIO = 1.5
HBM3_LATERAL_RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class CrossingLatencyTable:
    """Extra cycles for reaching a pseudo channel `d` mini-switches away.

    `same_stack[d]` is the addition when source and target mini-switch share
    a stack (U280: Table VI rows 0-3, page hit 55,56,58,60 minus local 55).
    Crossing stacks costs `cross_stack_base` plus `cross_stack_step` per
    switch-distance hop beyond one stack's width (U280: rows 4-7, 71..77
    minus 55 -> 16,18,20,22 at |d| = 4..7).
    """

    same_stack: tuple
    cross_stack_base: int = 0
    cross_stack_step: int = 0

    def __post_init__(self):
        if not self.same_stack or self.same_stack[0] != 0:
            raise ValueError(
                f"same_stack table must start at 0 extra cycles for the "
                f"local mini-switch, got {self.same_stack}")
        if list(self.same_stack) != sorted(self.same_stack):
            raise ValueError(
                f"crossing latency must be monotone in distance, got "
                f"{self.same_stack}")
        if self.cross_stack_base < 0 or self.cross_stack_step < 0:
            raise ValueError("cross-stack latencies must be non-negative")


@dataclasses.dataclass(frozen=True)
class SwitchTopology:
    """One switch fabric between AXI masters and pseudo channels.

    ``mini_switches`` is the total across all stacks; each mini-switch is
    fully implemented (all of its AXI channels see identical latency, paper
    observation 2), and the AXI-facing view is 1:1 — AXI channel *i* owns
    pseudo channel *i* when the switch is off (Sec. II).

    ``switch_agg_gbps`` / ``lateral_gbps`` are the fabric's two capacity
    terms (DESIGN.md §9): the per-mini-switch aggregate datapath
    bandwidth, and the bandwidth of the lateral bridge cross-switch
    traffic takes to the neighbouring mini-switch.  ``None`` leaves a
    term unconstrained (flat fabrics; or a fabric whose crossbar is
    provably never the bottleneck).  Single-requester throughput is never
    capped by either (Fig. 8's non-blocking datapath) — the terms only
    bound *multi-engine aggregates* in
    ``Engine.evaluate_contention(placement=...)``.
    """

    name: str
    num_stacks: int
    mini_switches: int
    axi_per_switch: int
    crossing: CrossingLatencyTable
    capacity_bytes: int = 8 * 1024**3
    switch_agg_gbps: Optional[float] = None
    lateral_gbps: Optional[float] = None

    def __post_init__(self):
        if self.num_stacks <= 0 or self.mini_switches <= 0 \
                or self.axi_per_switch <= 0:
            raise ValueError(
                f"{self.name}: num_stacks, mini_switches and axi_per_switch "
                f"must be positive")
        if self.mini_switches % self.num_stacks:
            raise ValueError(
                f"{self.name}: {self.mini_switches} mini-switches do not "
                f"divide evenly over {self.num_stacks} stacks")
        if len(self.crossing.same_stack) < self.switches_per_stack:
            raise ValueError(
                f"{self.name}: same-stack crossing table covers "
                f"{len(self.crossing.same_stack)} distances but a stack has "
                f"{self.switches_per_stack} mini-switches")
        if self.capacity_bytes <= 0:
            raise ValueError(f"{self.name}: capacity_bytes must be positive")
        for field in ("switch_agg_gbps", "lateral_gbps"):
            cap = getattr(self, field)
            if cap is not None and cap <= 0:
                raise ValueError(
                    f"{self.name}: {field} must be positive when set, "
                    f"got {cap}")
        if (self.switch_agg_gbps is not None and self.lateral_gbps is not None
                and self.lateral_gbps > self.switch_agg_gbps):
            raise ValueError(
                f"{self.name}: the lateral bridge ({self.lateral_gbps} GB/s) "
                f"cannot outrun the mini-switch aggregate "
                f"({self.switch_agg_gbps} GB/s) it feeds")

    # -- geometry ------------------------------------------------------------
    @property
    def switches_per_stack(self) -> int:
        return self.mini_switches // self.num_stacks

    @property
    def num_axi_channels(self) -> int:
        return self.mini_switches * self.axi_per_switch

    @property
    def num_pseudo_channels(self) -> int:
        """AXI-facing pseudo channels (1:1 with AXI channels, Sec. II)."""
        return self.num_axi_channels

    def mini_switch_of(self, axi_channel: int) -> int:
        self._check(axi_channel)
        return axi_channel // self.axi_per_switch

    def stack_of(self, axi_channel: int) -> int:
        self._check(axi_channel)
        return self.mini_switch_of(axi_channel) // self.switches_per_stack

    def local_pseudo_channel(self, axi_channel: int) -> int:
        """The pseudo channel an AXI channel reaches with the switch OFF."""
        self._check(axi_channel)
        return axi_channel

    def channel_address_base(self, pseudo_channel: int) -> int:
        """Byte base of a pseudo channel's private region."""
        self._check(pseudo_channel)
        region = self.capacity_bytes // self.num_pseudo_channels
        return pseudo_channel * region

    def channels_in_switch(self, switch: int) -> List[int]:
        if not 0 <= switch < self.mini_switches:
            raise ValueError(f"mini-switch {switch} out of range")
        lo = switch * self.axi_per_switch
        return list(range(lo, lo + self.axi_per_switch))

    def _check(self, ch: int) -> None:
        if not 0 <= ch < self.num_axi_channels:
            raise ValueError(
                f"channel {ch} out of range [0, {self.num_axi_channels})")

    # -- Table-VI-style latency ----------------------------------------------
    def crossing_extra_cycles(self, axi_channel: int,
                              pseudo_channel: int) -> int:
        """Distance-dependent extra cycles from an AXI channel to a pseudo
        channel with the switch enabled (on top of the spec's flat switch
        penalty), per the fabric's crossing table."""
        src = self.mini_switch_of(axi_channel)
        dst = self.mini_switch_of(pseudo_channel)
        d = abs(src - dst)
        if self.stack_of(axi_channel) == self.stack_of(pseudo_channel):
            return self.crossing.same_stack[d]
        # Extrapolation beyond the measured dst=0 column: crossing stacks
        # dominates; each switch-distance hop beyond one stack's width adds
        # the per-hop step.
        return (self.crossing.cross_stack_base
                + self.crossing.cross_stack_step
                * max(0, d - self.switches_per_stack))


def flat_topology(name: str, num_channels: int, *,
                  capacity_bytes: int = 8 * 1024**3) -> SwitchTopology:
    """A DDR-style flat fabric: no mini-switch crossing, every engine wired
    straight to its channel (one degenerate 'switch' serving all channels,
    zero crossing latency everywhere)."""
    return SwitchTopology(
        name=name, num_stacks=1, mini_switches=1,
        axi_per_switch=num_channels,
        crossing=CrossingLatencyTable(same_stack=(0,)),
        capacity_bytes=capacity_bytes)


# ---------------------------------------------------------------------------
# Topology registry: one fabric per registered memory spec
# ---------------------------------------------------------------------------

_TOPOLOGY_REGISTRY: Dict[str, SwitchTopology] = {}


def register_topology(spec_name: str, topology: SwitchTopology, *,
                      override: bool = False) -> SwitchTopology:
    """Attach a switch topology to a registered memory spec by name.

    Returns the topology for chaining.  Like the spec/policy registries
    (DESIGN.md §6), refuses to silently replace an entry unless
    ``override=True``.
    """
    if spec_name in _TOPOLOGY_REGISTRY and not override:
        raise ValueError(
            f"topology for spec {spec_name!r} already registered; pass "
            f"override=True to replace it")
    _TOPOLOGY_REGISTRY[spec_name] = topology
    return topology


def available_topologies() -> List[str]:
    """Spec names with a registered topology, registration order."""
    return list(_TOPOLOGY_REGISTRY)


def topology_for(spec: MemorySpec) -> SwitchTopology:
    """Resolve the switch topology registered for a memory spec.

    Fails loudly (at engine construction, not deep in a sweep) when the
    spec has no registered topology or the registered fabric does not match
    the spec's channel count.
    """
    topo = _TOPOLOGY_REGISTRY.get(spec.name)
    if topo is None:
        raise ValueError(
            f"no switch topology registered for spec {spec.name!r}; call "
            f"register_topology({spec.name!r}, SwitchTopology(...)) "
            f"(have {available_topologies()})")
    if topo.num_axi_channels != spec.num_channels:
        raise ValueError(
            f"topology {topo.name!r} models {topo.num_axi_channels} AXI "
            f"channels but spec {spec.name!r} has {spec.num_channels}; "
            f"register a matching topology")
    return topo


# The U280's measured crossbar (paper Sec. II / Table VI): 2 HBM2 stacks,
# 8 mini-switches x 4 AXI channels, 8 GB total.  Capacity terms derived
# from the published wire rate: each mini-switch is a full 4x4 crossbar
# (4 x 14.4 GB/s — present but non-binding for any legal traffic,
# matching Fig. 8's non-blocking datapath), while the lateral bridge to
# the adjacent mini-switch is one channel-width link (14.4 GB/s) that all
# cross-switch masters share — the collapse Choi et al. 2020 measure for
# switch-crossing placements.
U280_CROSSBAR = register_topology("hbm", SwitchTopology(
    name="u280_8x4_crossbar",
    num_stacks=2,
    mini_switches=NUM_MINI_SWITCHES,
    axi_per_switch=AXI_PER_MINI_SWITCH,
    crossing=CrossingLatencyTable(same_stack=(0, 1, 3, 5),
                                  cross_stack_base=16, cross_stack_step=2),
    capacity_bytes=8 * 1024**3,
    # 4 AXI x wire rate: full crossbar (= 57.6 GB/s)
    switch_agg_gbps=AXI_PER_MINI_SWITCH * U280_CHANNEL_WIRE_GBPS,
    # one channel-width bridge per neighbour (= 14.4 GB/s)
    lateral_gbps=U280_CHANNEL_WIRE_GBPS,
))

# Modeled HBM3-class fabric (Sec. VII generalization target): an HBM3 stack
# exposes 16 memory channels, so the fabric is two stacks of eight
# mini-switches, each serving one memory channel's 2 AXI/pseudo channels.
# Finer switches cross more often but each hop is cheaper (shorter wires at
# the higher controller clock): a linear same-stack ladder and a smaller
# stack-crossing base than the U280's.  Modeled, not measured — like the
# HBM3 MemorySpec it attaches to.
# Capacity terms (modeled): the finer 2-channel mini-switches share one
# internal datapath at 1.5x channel rate — 38.4 GB/s, *below* the 51.2
# GB/s two saturated ports would need, so the same-switch aggregate term
# binds on this fabric (unlike the U280's full crossbar) — and the
# narrower lateral bridges carry half a channel (12.8 GB/s).
HBM3_FABRIC = register_topology("hbm3", SwitchTopology(
    name="hbm3_2x8_fabric",
    num_stacks=2,
    mini_switches=16,
    axi_per_switch=2,
    crossing=CrossingLatencyTable(same_stack=(0, 1, 2, 3, 4, 5, 6, 7),
                                  cross_stack_base=12, cross_stack_step=1),
    capacity_bytes=32 * 1024**3,
    # shared internal datapath, 1.5x channel rate (= 38.4 GB/s, *below*
    # the 51.2 GB/s two saturated ports would need -> binding)
    switch_agg_gbps=HBM3_AGG_RATIO * HBM3.peak_channel_gbps,
    # half-channel bridges between fine switches (= 12.8 GB/s)
    lateral_gbps=HBM3_LATERAL_RATIO * HBM3.peak_channel_gbps,
))

# Flat DDR-style fabrics: the U280 DDR4 controller and the VCU709-class
# DDR3 SODIMM have no inter-channel switch (spec.has_switch=False) — each
# engine owns its channel outright.
DDR4_FLAT = register_topology(
    "ddr4", flat_topology("ddr4_flat", 2, capacity_bytes=32 * 1024**3))
DDR3_FLAT = register_topology(
    "ddr3", flat_topology("ddr3_flat", 1, capacity_bytes=4 * 1024**3))


# ---------------------------------------------------------------------------
# Deprecated accessors (pre-parametric API)
# ---------------------------------------------------------------------------


def HBMTopology(spec: MemorySpec = HBM) -> SwitchTopology:
    """Deprecated: resolve the registered topology with `topology_for`.

    Kept because the pre-parametric class of this name was the only way to
    reach the U280 fabric; it now returns the registered
    :class:`SwitchTopology` for the spec (with the same channel-count
    check the old constructor performed).
    """
    return topology_for(spec)


def DDR4Topology(num_channels: int = 2) -> SwitchTopology:
    """Deprecated: flat fabrics are `flat_topology(...)` instances now."""
    if num_channels == DDR4_FLAT.num_axi_channels:
        return DDR4_FLAT
    return flat_topology(f"ddr_flat_{num_channels}", num_channels)
