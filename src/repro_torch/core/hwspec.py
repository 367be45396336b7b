"""Hardware specifications for the benchmarked / targeted memory systems.

Two families live here (the accelerator chip specs of the reference
package arrive with the roofline port):

* The paper's platforms — the Xilinx Alveo U280 HBM2 subsystem and its DDR4
  channels (Section II / IV-A of the paper).  These drive the timing
  simulator that reproduces the paper's tables and figures.
* The generalization targets the paper names in Sec. VII — HBM3 and DDR3 —
  as *modeled* specs: geometry and timings come from the respective JEDEC
  generations, latency anchors are scaled from the measured U280 numbers.
  They are the proof that the framework is spec-driven, not measurements.

Specs are *registrable*: :func:`register_spec` adds a new memory system to
the library, and every layer above (address mapping, engines, sweeps, the
experiment registry) resolves specs through :func:`spec_by_name` /
:func:`available_specs`.  See DESIGN.md §6 for the extension recipe.

All times are kept in *nanoseconds* and converted to controller clock cycles
on demand, mirroring how the paper reports "cycles" at the AXI clock.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

# ---------------------------------------------------------------------------
# DRAM-side specs (paper platforms)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    """One memory system as seen from a single engine/AXI channel."""

    name: str
    # Controller ("AXI") clock in MHz — the engine module is clocked at this.
    axi_mhz: float
    # Bytes transferred per AXI clock per channel (data-bus width).
    bus_bytes_per_cycle: int
    # Number of independent channels an engine can attach to.
    num_channels: int
    # Minimum legal burst size B in bytes (paper Sec. III-B).
    min_burst: int
    # Address-mapping geometry (bits of the application address).
    row_bits: int
    bankgroup_bits: int
    bank_bits: int
    column_bits: int
    # Transaction granularity: app_addr low bits not part of the mapping.
    addr_lsb: int
    # --- idle latency anchor points, in AXI cycles (paper Table IV) -------
    lat_page_hit: int
    lat_page_closed: int
    lat_page_miss: int
    # Extra cycles when the inter-channel switch sits on the path (HBM only).
    switch_penalty: int
    # --- dynamic timing, in nanoseconds -----------------------------------
    t_refi_ns: float      # refresh interval
    t_rfc_ns: float       # refresh cycle duration (bank unavailable)
    t_rc_ns: float        # row cycle: min time between ACTs to same bank
    t_ccd_l_ns: float     # column-to-column, same bank group
    t_ccd_s_ns: float     # column-to-column, different bank group
    t_faw_ns: float       # four-activate window
    # Scheduling inefficiency of the real controller beyond refresh
    # (calibrated so sequential-read efficiency matches the paper).
    sched_overhead: float
    # Whether an inter-channel switch sits between engines and channels
    # (the U280 HBM crossbar of Sec. II; DDR-style controllers have none).
    has_switch: bool = False
    # Where the numbers come from: "measured" (paper Tables IV-VI) or
    # "modeled" (JEDEC-derived generalization targets, Sec. VII).
    provenance: str = "measured"
    # --- write-path timing, in nanoseconds --------------------------------
    # The paper's engine has a full write module (Sec. III-C-1); these feed
    # the write/duplex direction of the timing model (DESIGN.md §7).
    t_wr_ns: float = 15.0    # write recovery: last write data -> precharge
    t_wtr_ns: float = 7.5    # write->read bus turnaround
    t_rtw_ns: float = 7.5    # read->write bus turnaround

    # -- derived ------------------------------------------------------------
    @property
    def cycle_ns(self) -> float:
        return 1e3 / self.axi_mhz

    def ns_to_cycles(self, ns: float) -> float:
        return ns / self.cycle_ns

    def cycles_to_ns(self, cycles: float) -> float:
        return cycles * self.cycle_ns

    @property
    def peak_channel_gbps(self) -> float:
        """Theoretical bandwidth of one channel in GB/s."""
        return self.bus_bytes_per_cycle * self.axi_mhz * 1e6 / 1e9

    @property
    def peak_total_gbps(self) -> float:
        return self.peak_channel_gbps * self.num_channels

    @property
    def mapped_bits(self) -> int:
        return (self.row_bits + self.bankgroup_bits + self.bank_bits
                + self.column_bits)

    @property
    def page_bytes(self) -> int:
        """Row-buffer (page) coverage of the application address space."""
        return (1 << self.column_bits) << self.addr_lsb

    @property
    def num_banks(self) -> int:
        return 1 << (self.bankgroup_bits + self.bank_bits)

    def validate(self) -> "MemorySpec":
        """Check internal consistency; raises ValueError on a bad spec.

        Run on every :func:`register_spec` call so a third-party spec fails
        loudly at registration time, not deep inside the timing model.
        """
        def pow2(x):
            return x > 0 and (x & (x - 1)) == 0

        if not self.name or not self.name.islower():
            raise ValueError(f"spec name {self.name!r} must be a non-empty "
                             "lowercase identifier")
        if self.axi_mhz <= 0:
            raise ValueError(f"{self.name}: axi_mhz must be positive")
        if not pow2(self.bus_bytes_per_cycle):
            raise ValueError(f"{self.name}: bus_bytes_per_cycle must be a "
                             f"power of 2, got {self.bus_bytes_per_cycle}")
        if not pow2(self.min_burst) or self.min_burst < self.bus_bytes_per_cycle:
            raise ValueError(
                f"{self.name}: min_burst ({self.min_burst}) must be a power "
                f"of 2 >= bus width ({self.bus_bytes_per_cycle})")
        if self.num_channels <= 0:
            raise ValueError(f"{self.name}: num_channels must be positive")
        for field in ("row_bits", "bankgroup_bits", "bank_bits",
                      "column_bits", "addr_lsb"):
            if getattr(self, field) < 0:
                raise ValueError(f"{self.name}: {field} must be >= 0")
        if self.row_bits == 0 or self.column_bits == 0:
            raise ValueError(f"{self.name}: row_bits and column_bits must "
                             "be positive")
        if not (0 < self.lat_page_hit <= self.lat_page_closed
                <= self.lat_page_miss):
            raise ValueError(
                f"{self.name}: latency anchors must satisfy "
                f"0 < hit <= closed <= miss, got "
                f"{(self.lat_page_hit, self.lat_page_closed, self.lat_page_miss)}")
        if not 0 < self.t_rfc_ns < self.t_refi_ns:
            raise ValueError(f"{self.name}: need 0 < tRFC < tREFI, got "
                             f"tRFC={self.t_rfc_ns} tREFI={self.t_refi_ns}")
        for field in ("t_rc_ns", "t_ccd_l_ns", "t_ccd_s_ns", "t_faw_ns",
                      "t_wr_ns"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{self.name}: {field} must be positive")
        for field in ("t_wtr_ns", "t_rtw_ns"):
            if getattr(self, field) < 0:
                raise ValueError(f"{self.name}: {field} must be >= 0")
        if not 0 <= self.sched_overhead < 1:
            raise ValueError(f"{self.name}: sched_overhead must be in [0, 1)")
        if self.provenance not in ("measured", "modeled"):
            raise ValueError(f"{self.name}: provenance must be 'measured' or "
                             f"'modeled', got {self.provenance!r}")
        return self


# Xilinx Alveo U280, HBM2 pseudo-channel as seen from one AXI3 channel.
# 450 MHz AXI clock, 256-bit data => 32 B/cycle => 14.4 GB/s theoretical;
# paper measures 13.27 GB/s. app_addr[27:5] => 23 mapped bits:
# 14R + 2BG + 2B + 5C (RBC ordering), 32 B transaction granularity.
HBM = MemorySpec(
    name="hbm",
    axi_mhz=450.0,
    bus_bytes_per_cycle=32,
    num_channels=32,
    min_burst=32,
    row_bits=14,
    bankgroup_bits=2,
    bank_bits=2,
    column_bits=5,
    addr_lsb=5,
    lat_page_hit=48,       # 106.7 ns  (Table IV)
    lat_page_closed=55,    # 122.2 ns
    lat_page_miss=62,      # 137.8 ns
    switch_penalty=7,      # footnote 9
    t_refi_ns=3900.0,
    t_rfc_ns=260.0,
    t_rc_ns=47.0,
    t_ccd_l_ns=2 / 0.45,   # 4 memory-clock (900 MHz) = 2 AXI cycles, same BG
    t_ccd_s_ns=1 / 0.45,   # 1 AXI cycle, different bank group
    t_faw_ns=8.0,          # HBM2 four-activate window (per pseudo channel)
    sched_overhead=0.012,
    has_switch=True,       # the Sec. II crossbar of mini-switches
    t_wr_ns=16.0,          # HBM2 write recovery
    t_wtr_ns=8.0,          # write->read turnaround
    t_rtw_ns=8.0,          # read->write turnaround
)

# Alveo U280 DDR4 channel: 300 MHz AXI, 512-bit => 64 B/cycle => 19.2 GB/s
# theoretical; paper measures 18 GB/s/channel. app_addr[33:6] => 28 mapped
# bits: 17R + 2BG + 2B + 7C, 64 B granularity.
DDR4 = MemorySpec(
    name="ddr4",
    axi_mhz=300.0,
    bus_bytes_per_cycle=64,
    num_channels=2,
    min_burst=64,
    row_bits=17,
    bankgroup_bits=2,
    bank_bits=2,
    column_bits=7,
    addr_lsb=6,
    lat_page_hit=22,       # 73.3 ns  (Table IV)
    lat_page_closed=27,    # 89.9 ns
    lat_page_miss=32,      # 106.6 ns
    switch_penalty=0,      # no switch in the DDR4 controller
    t_refi_ns=7800.0,
    t_rfc_ns=350.0,
    t_rc_ns=47.0,
    t_ccd_l_ns=4 / 0.3,
    t_ccd_s_ns=1 / 0.3,
    t_faw_ns=30.0,
    sched_overhead=0.015,
    t_wr_ns=15.0,          # DDR4 JEDEC tWR
    t_wtr_ns=7.5,          # tWTR_L
    t_rtw_ns=7.5,
)

# HBM3 stack behind the same AXI pseudo-channel fabric (the paper's Sec. VII
# generalization target).  Modeled, not measured: a 6.4 Gb/s/pin, 1024-bit
# stack delivers ~819 GB/s, i.e. ~25.6 GB/s per pseudo channel; we keep the
# U280's 32-pseudo-channel topology and the HBM2 mapping geometry (the
# AXI-facing view is unchanged) and take JEDEC HBM3 timing deltas: shorter
# tRFC, same-order tRC, per-bank refresh left out as in the HBM2 model.
# Latency anchors scale the measured HBM2 cycles to the faster 800 MHz
# controller clock (absolute ns slightly improved, as HBM3 specifies).
HBM3 = MemorySpec(
    name="hbm3",
    axi_mhz=800.0,
    bus_bytes_per_cycle=32,   # 25.6 GB/s per pseudo channel
    num_channels=32,
    min_burst=32,
    row_bits=14,
    bankgroup_bits=2,
    bank_bits=2,
    column_bits=5,
    addr_lsb=5,
    # Anchor spacing mirrors the measured HBM2 ladder (7 controller cycles
    # per step); the paper's spike/classify heuristics assume that shape.
    lat_page_hit=78,          # ~97.5 ns
    lat_page_closed=85,       # ~106.3 ns
    lat_page_miss=92,         # ~115.0 ns
    switch_penalty=7,         # same crossbar fabric as the U280 subsystem
    t_refi_ns=3900.0,
    t_rfc_ns=160.0,           # HBM3 all-bank refresh is much shorter
    t_rc_ns=45.0,
    t_ccd_l_ns=2 / 0.8,       # 2 AXI cycles, same bank group
    t_ccd_s_ns=1 / 0.8,
    t_faw_ns=7.0,
    sched_overhead=0.012,
    has_switch=True,
    provenance="modeled",
    t_wr_ns=14.0,          # HBM3 shortens write recovery slightly
    t_wtr_ns=6.0,
    t_rtw_ns=6.0,
)

# DDR3-1866 SODIMM as on the VCU709-class boards the paper's Sec. VII
# points at.  Modeled: 64-bit bus at 233 MHz AXI => 14.9 GB/s theoretical.
# DDR3 has no bank groups (bankgroup_bits=0): column-to-column spacing is a
# single tCCD for everything, so t_ccd_l == t_ccd_s ~= one AXI cycle.
# Geometry of a 4 Gb x8 part: 16 row bits, 8 banks, 8 KB page => 7 mapped
# column bits above the 64 B transaction granularity.
DDR3 = MemorySpec(
    name="ddr3",
    axi_mhz=233.0,
    bus_bytes_per_cycle=64,
    num_channels=1,
    min_burst=64,
    row_bits=16,
    bankgroup_bits=0,
    bank_bits=3,
    column_bits=7,
    addr_lsb=6,
    lat_page_hit=20,          # ~85.8 ns
    lat_page_closed=25,       # ~107.3 ns
    lat_page_miss=30,         # ~128.8 ns
    switch_penalty=0,
    t_refi_ns=7800.0,
    t_rfc_ns=260.0,           # 4 Gb DDR3
    t_rc_ns=47.9,             # DDR3-1866 tRC
    t_ccd_l_ns=4 / 0.933,     # tCCD = 4 tCK at 933 MHz; no bank groups
    t_ccd_s_ns=4 / 0.933,
    t_faw_ns=27.0,
    sched_overhead=0.015,
    provenance="modeled",
    t_wr_ns=15.0,          # DDR3-1866 tWR
    t_wtr_ns=7.5,
    t_rtw_ns=7.5,
)


# ---------------------------------------------------------------------------
# Memory-spec registry
# ---------------------------------------------------------------------------

_SPEC_REGISTRY: Dict[str, MemorySpec] = {}


def register_spec(spec: MemorySpec, *, override: bool = False) -> MemorySpec:
    """Register a memory system so every layer can resolve it by name.

    Validates the spec first; refuses to silently replace an existing entry
    unless ``override=True``.  Returns the spec for chaining.  Address-mapping
    policies are registered separately (``address_mapping.register_policies``)
    because they describe the *controller*, not the DRAM device.
    """
    spec.validate()
    if spec.name in _SPEC_REGISTRY and not override:
        raise ValueError(
            f"memory spec {spec.name!r} already registered; pass "
            f"override=True to replace it")
    _SPEC_REGISTRY[spec.name] = spec
    return spec


def available_specs() -> List[str]:
    """Names of every registered memory spec, registration order."""
    return list(_SPEC_REGISTRY)


def spec_by_name(name: str) -> MemorySpec:
    spec = _SPEC_REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown memory spec {name!r}; have {available_specs()}")
    return spec


for _spec in (HBM, DDR4, HBM3, DDR3):
    register_spec(_spec)
del _spec
