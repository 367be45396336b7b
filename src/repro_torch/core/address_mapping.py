"""Address-mapping policies of the Xilinx memory controllers (paper Table II).

A policy is an ordered list of (field, nbits) pairs, MSB-first, that slices
the application address `app_addr[hi:lo]` into row / bank-group / bank /
column fields.  Notation follows the paper: ``14R-1BG-2B-5C-1BG`` means the
most-significant 14 mapped bits select the row, then 1 bank-group bit, 2
bank bits, 5 column bits, and the least-significant mapped bit is the second
bank-group bit (policy RGBCG, the HBM default).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.hwspec import MemorySpec

Field = Tuple[str, int]   # ("R" | "BG" | "B" | "C", nbits)


def parse_policy(desc: str) -> List[Field]:
    """Parse "14R-1BG-2B-5C-1BG" into [("R",14),("BG",1),("B",2),...]."""
    fields: List[Field] = []
    for tok in desc.split("-"):
        tok = tok.strip()
        i = 0
        while i < len(tok) and tok[i].isdigit():
            i += 1
        if i == 0 or i == len(tok):
            raise ValueError(f"bad policy token {tok!r} in {desc!r}")
        fields.append((tok[i:], int(tok[:i])))
    return fields


@dataclasses.dataclass(frozen=True)
class AddressMapping:
    """Bit-slicing decoder/encoder for one policy on one memory spec."""

    name: str
    fields: Tuple[Field, ...]
    spec: MemorySpec

    def __post_init__(self):
        totals: Dict[str, int] = {}
        for f, n in self.fields:
            if f not in ("R", "BG", "B", "C"):
                raise ValueError(f"unknown field {f!r} in policy {self.name}")
            totals[f] = totals.get(f, 0) + n
        expect = {"R": self.spec.row_bits, "BG": self.spec.bankgroup_bits,
                  "B": self.spec.bank_bits, "C": self.spec.column_bits}
        # Zero-width fields (e.g. DDR3 has no bank groups) are simply
        # absent from the policy string.
        for f, width in expect.items():
            if width == 0:
                totals.setdefault(f, 0)
        if totals != expect:
            raise ValueError(
                f"policy {self.name} field widths {totals} do not match "
                f"spec {self.spec.name} geometry {expect}")

    @property
    def mapped_bits(self) -> int:
        return sum(n for _, n in self.fields)

    def decode(self, app_addr):
        """Vectorized app_addr -> dict(R=..., BG=..., B=..., C=...).

        `app_addr` is in bytes; bits below spec.addr_lsb are intra-burst and
        ignored, as in the controller (app_addr[27:5] for HBM).
        """
        a = np.asarray(app_addr, dtype=np.int64) >> self.spec.addr_lsb
        out: Dict[str, np.ndarray] = {}
        pos = self.mapped_bits
        for f, n in self.fields:           # MSB-first
            pos -= n
            piece = (a >> pos) & ((1 << n) - 1)
            prev = out.get(f)
            out[f] = piece if prev is None else (prev << n) | piece
        for f in ("R", "BG", "B", "C"):    # zero-width fields, if any
            out.setdefault(f, np.zeros_like(a))
        return out

    def bank_id_from(self, decoded: Dict[str, np.ndarray]):
        """Flat bank index from already-decoded fields (avoids re-decoding
        the address stream on the timing model's hot path)."""
        return decoded["BG"] * (1 << self.spec.bank_bits) + decoded["B"]

    def encode(self, r, bg, b, c):
        """Inverse of decode: fields -> byte address (LSBs zero)."""
        r = np.asarray(r, dtype=np.int64)
        bg = np.asarray(bg, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        remaining = {"R": r, "BG": bg, "B": b, "C": c}
        widths = {"R": self.spec.row_bits, "BG": self.spec.bankgroup_bits,
                  "B": self.spec.bank_bits, "C": self.spec.column_bits}
        consumed = {k: 0 for k in widths}
        addr = np.zeros(np.broadcast(r, bg, b, c).shape, dtype=np.int64)
        pos = self.mapped_bits
        for f, n in self.fields:           # MSB-first, consume MSBs first
            pos -= n
            consumed[f] += n
            shift = widths[f] - consumed[f]
            piece = (remaining[f] >> shift) & ((1 << n) - 1)
            addr = addr | (piece << pos)
        return addr << self.spec.addr_lsb

    def bank_id(self, app_addr):
        """Flat bank index combining bank-group and bank fields."""
        return self.bank_id_from(self.decode(app_addr))


# --- policy-table registry -------------------------------------------------
# One controller policy table per memory spec name.  The paper's Table II
# entries (hbm, ddr4) are built in; a registered spec (hwspec.register_spec)
# brings its own table through register_policies — see DESIGN.md §6.

_POLICY_TABLES: Dict[str, Dict[str, str]] = {}
# Public mutable mapping spec-name -> default policy name (kept as a plain
# dict for backward compatibility with `DEFAULT_POLICY[...]` lookups).
DEFAULT_POLICY: Dict[str, str] = {}


@functools.lru_cache(maxsize=None)
def _policies_for_cached(spec: MemorySpec) -> Dict[str, AddressMapping]:
    # Mappings are immutable and specs are frozen dataclasses, so the parsed
    # policy table can be built once per spec — get_mapping sits on the
    # timing model's hot path and is called once per sweep point.
    table = _POLICY_TABLES.get(spec.name)
    if table is None:
        raise ValueError(
            f"no address-mapping policies registered for spec "
            f"{spec.name!r}; call register_policies first "
            f"(have {sorted(_POLICY_TABLES)})")
    return {name: AddressMapping(name, tuple(parse_policy(desc)), spec)
            for name, desc in table.items()}


def register_policies(spec_name: str, table: Dict[str, str], *,
                      default: str, override: bool = False) -> None:
    """Register the address-mapping policy table of one memory spec.

    `table` maps policy name -> field string ("14R-2BG-2B-5C"); `default`
    names the controller's default policy.  Parsing/geometry validation is
    deferred to first use (the spec object may carry any geometry), but the
    default must be a key of the table.
    """
    if spec_name in _POLICY_TABLES and not override:
        raise ValueError(
            f"policies for {spec_name!r} already registered; pass "
            f"override=True to replace them")
    if default not in table:
        raise ValueError(
            f"default policy {default!r} for {spec_name!r} is not in its "
            f"table {sorted(table)}")
    _POLICY_TABLES[spec_name] = dict(table)
    DEFAULT_POLICY[spec_name] = default
    _policies_for_cached.cache_clear()


# Paper Table II.  HBM3 (hwspec.HBM3) keeps the HBM2 pseudo-channel AXI
# view, so both spec names register the same table object.
_HBM_PSEUDO_CHANNEL_POLICIES = {
    "RBC":   "14R-2BG-2B-5C",
    "RCB":   "14R-5C-2BG-2B",
    "BRC":   "2BG-2B-14R-5C",
    "RGBCG": "14R-1BG-2B-5C-1BG",   # default (blue in the paper)
    "BRGCG": "2B-14R-1BG-5C-1BG",
}
register_policies("hbm", _HBM_PSEUDO_CHANNEL_POLICIES, default="RGBCG")
register_policies("hbm3", _HBM_PSEUDO_CHANNEL_POLICIES, default="RGBCG")

register_policies("ddr4", {
    "RBC":  "17R-2BG-2B-7C",
    "RCB":  "17R-7C-2B-2BG",        # default
    "BRC":  "2BG-2B-17R-7C",
    "RCBI": "17R-6C-2B-1C-2BG",
}, default="RCB")

# DDR3 (hwspec.DDR3) has no bank groups: policies carry no BG field.
register_policies("ddr3", {
    "RBC": "16R-3B-7C",             # Xilinx MIG DDR3 default
    "RCB": "16R-7C-3B",
    "BRC": "3B-16R-7C",
}, default="RBC")


def policies_for(spec: MemorySpec) -> Dict[str, AddressMapping]:
    return dict(_policies_for_cached(spec))


def get_mapping(spec: MemorySpec, policy: str | None = None) -> AddressMapping:
    policy = policy or DEFAULT_POLICY[spec.name]
    pols = _policies_for_cached(spec)
    if policy not in pols:
        raise ValueError(
            f"policy {policy!r} not available for {spec.name}; "
            f"have {sorted(pols)}")
    return pols[policy]
