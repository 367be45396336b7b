"""Runtime parameters of a Shuhai engine (paper Table I) + register packing.

The paper's parameter module stores each engine's runtime parameters in a
256-bit control register (Sec. III-C-3): W, S, B, A take 32 bits each, N
takes 64 bits, and 32+ bits are reserved.  We reproduce that packing exactly
so a "single compiled image" (here: a single jitted kernel) can be re-tasked
by rewriting registers only — the paper's ease-of-use challenge C2.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hwspec import MemorySpec

_MASK32 = (1 << 32) - 1
_MASK64 = (1 << 64) - 1

# Bit offsets inside the 256-bit register, LSB first.
_OFF_W, _OFF_S, _OFF_B, _OFF_A, _OFF_N = 0, 32, 64, 96, 128
# bits [192, 256) reserved for future use (paper keeps 32 reserved).


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class RSTParams:
    """Repetitive Sequential Traversal parameters (paper Table I, Eq. 1).

    T[i] = A + (i * S) mod W for i in [0, N).
    """

    n: int          # number of read/write transactions
    b: int          # burst size in bytes (power of 2)
    w: int          # working-set size in bytes (power of 2, > 16)
    s: int          # stride in bytes (power of 2, <= W)
    a: int = 0      # initial address in bytes

    def validate(self, spec: MemorySpec | None = None) -> "RSTParams":
        if self.n <= 0:
            raise ValueError(f"N must be positive, got {self.n}")
        if not _is_pow2(self.b):
            raise ValueError(f"B must be a power of 2, got {self.b}")
        if not _is_pow2(self.s):
            raise ValueError(f"S must be a power of 2, got {self.s}")
        if not (_is_pow2(self.w) and self.w > 16):
            raise ValueError(f"W must be a power of 2 > 16, got {self.w}")
        if self.s > self.w:
            raise ValueError(f"S ({self.s}) must not exceed W ({self.w})")
        if self.a < 0:
            raise ValueError(f"A must be non-negative, got {self.a}")
        if spec is not None and self.b < spec.min_burst:
            raise ValueError(
                f"B ({self.b}) below minimum burst {spec.min_burst} for "
                f"{spec.name} (memory application data width constraint)")
        return self

    # -- Eq. 1 ---------------------------------------------------------------
    def address(self, i: int) -> int:
        return self.a + (i * self.s) % self.w

    @property
    def period(self) -> int:
        """Number of transactions before the address stream repeats."""
        # S and W are powers of two, so the period is W // gcd(S, W).
        return max(1, self.w // min(self.s, self.w))

    @property
    def total_bytes(self) -> int:
        return self.n * self.b

    # -- 256-bit control register packing -------------------------------------
    def pack(self) -> int:
        for name, val, mask in (
            ("w", self.w, _MASK32), ("s", self.s, _MASK32),
            ("b", self.b, _MASK32), ("a", self.a, _MASK32),
            ("n", self.n, _MASK64),
        ):
            if val & ~mask:
                raise ValueError(f"{name}={val} overflows its register field")
        reg = 0
        reg |= (self.w & _MASK32) << _OFF_W
        reg |= (self.s & _MASK32) << _OFF_S
        reg |= (self.b & _MASK32) << _OFF_B
        reg |= (self.a & _MASK32) << _OFF_A
        reg |= (self.n & _MASK64) << _OFF_N
        return reg

    @staticmethod
    def unpack(reg: int) -> "RSTParams":
        if reg < 0 or reg >= (1 << 256):
            raise ValueError("register value out of 256-bit range")
        return RSTParams(
            w=(reg >> _OFF_W) & _MASK32,
            s=(reg >> _OFF_S) & _MASK32,
            b=(reg >> _OFF_B) & _MASK32,
            a=(reg >> _OFF_A) & _MASK32,
            n=(reg >> _OFF_N) & _MASK64,
        )


@dataclasses.dataclass(frozen=True)
class EngineRegisters:
    """Per-engine register file: one read + one write control register.

    Matches Sec. III-C-3: "each [engine] needs two 256-bit control registers
    ... one register for the read module and the other register for the
    write module".  The 64-bit status register carries the throughput count
    back to the host.
    """

    read_reg: int = 0
    write_reg: int = 0
    status: int = 0       # 64-bit: transactions completed

    def with_read(self, p: RSTParams) -> "EngineRegisters":
        return dataclasses.replace(self, read_reg=p.pack())

    def with_write(self, p: RSTParams) -> "EngineRegisters":
        return dataclasses.replace(self, write_reg=p.pack())

    @property
    def read_params(self) -> RSTParams:
        return RSTParams.unpack(self.read_reg)

    @property
    def write_params(self) -> RSTParams:
        return RSTParams.unpack(self.write_reg)
