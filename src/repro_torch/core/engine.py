"""Engine modules: the benchmarking workers, one per channel.

Faithful to Sec. III-C-1: an engine owns one channel, has independent read
and write modules, is configured purely through runtime registers, and is
never the bottleneck.  Backends are *pluggable*: a :class:`Backend`
implements the two primitive measurements (throughput, serial latency) for
one execution substrate and registers itself by name.  Two ship built in:

* ``sim``  — the calibrated DRAM timing model (reproduces the paper's
             U280 numbers on the host);
* ``cuda`` — the RST engines as hand-written CUDA kernels
             (kernels/rst_read.py, rst_write.py) on the card; their plain
             PyTorch versions serve a backend built with ``device="cpu"``.

`register_backend` adds a third; everything above (Engine, Sweep, the
experiment registry) resolves backends through `get_backend` — see
DESIGN.md §6.

The register-driven methods (`read_throughput`, `read_latency`, ...) mirror
the paper's configure-then-trigger flow.  The `evaluate_*` methods take
RSTParams directly and never touch the register file; `core/sweep.py` uses
them to batch-evaluate whole campaign grids with memoization.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import timing_model
from repro_torch.core.address_mapping import AddressMapping, get_mapping
from repro_torch.core.channels import topology_for
from repro_torch.core.engine_mix import EngineMix, normalize_mix
from repro_torch.core.hwspec import HBM, MemorySpec
from repro_torch.core.latency import (DEFAULT_COUNTER_BITS, DEFAULT_DEPTH,
                                LatencyModule)
from repro_torch.core.params import EngineRegisters, RSTParams
from repro_torch.core.switch import PLACEMENTS, SwitchModel


class UnsupportedCapability(NotImplementedError):
    """A backend lacks the capability a measurement needs.

    Raised (with the backend name and the requested op in the message)
    instead of silently substituting a different measurement — e.g. a
    serial *write*-latency capture on a backend without per-transaction
    timers must not quietly return read anchors.  Subclasses
    NotImplementedError so pre-existing handlers keep working.
    """


# ---------------------------------------------------------------------------
# Backend error taxonomy (DESIGN.md §10)
#
# Every failure a backend can raise maps onto exactly one of three
# categories, which is what the campaign service's resilience layer keys
# its policy decisions off:
#
#   TransientBackendError  -> retry with backoff (the same call may succeed)
#   PermanentBackendError  -> fail fast, never retry (the call is invalid
#                             or the substrate is durably broken)
#   UnsupportedCapability  -> degrade: route to a backend that has the
#                             capability (cuda -> sim), never retry
# ---------------------------------------------------------------------------


class BackendError(RuntimeError):
    """Base for classified backend execution failures."""


class TransientBackendError(BackendError):
    """A retryable failure: the identical call may succeed on retry
    (scheduler hiccup, collective timeout, resource pressure)."""


class PermanentBackendError(BackendError):
    """A non-retryable failure: the call itself is invalid or the
    substrate is durably broken; retrying burns budget for nothing."""


class BackendTimeout(TransientBackendError):
    """A call exceeded its time budget.  Transient (the next attempt may
    be fast); `seconds` carries the elapsed time so a virtual-clock
    caller (the campaign service) can charge it against the request's
    deadline without any wall-clock dependence."""

    def __init__(self, message: str, seconds: float = 0.0):
        super().__init__(message)
        self.seconds = seconds


# Exception types/markers that signal a retryable substrate hiccup when a
# backend raises outside the taxonomy.  PyTorch reports a failed
# allocation on the card as torch.cuda.OutOfMemoryError; every other CUDA
# runtime failure arrives as a plain RuntimeError whose message starts
# with "CUDA error", and only the status text says whether the same call
# can succeed later.  Faults such as an illegal address leave the CUDA
# context unusable, so they stay permanent.
_TRANSIENT_EXC_TYPES = (TimeoutError, ConnectionError, InterruptedError,
                        torch.cuda.OutOfMemoryError)
_CUDA_ERROR_PREFIX = "CUDA error"
_CUDA_TRANSIENT_MARKERS = ("out of memory", "launch timed out",
                           "busy or unavailable", "launch out of resources")


def classify_backend_error(exc: BaseException) -> type:
    """Map an arbitrary backend exception onto the error taxonomy.

    Returns one of :class:`TransientBackendError`,
    :class:`PermanentBackendError`, or :class:`UnsupportedCapability`
    (the class, not an instance).  Already-classified exceptions keep
    their category; OS-level timeouts/connection drops, CUDA
    out-of-memory and the transient CUDA runtime statuses classify
    transient; everything else — bad
    arguments (ValueError/TypeError), assertion failures, arbitrary
    backend bugs — classifies permanent, because retrying an invalid call
    can never succeed (DESIGN.md §10).
    """
    if isinstance(exc, UnsupportedCapability):
        return UnsupportedCapability
    if isinstance(exc, TransientBackendError):
        return TransientBackendError
    if isinstance(exc, PermanentBackendError):
        return PermanentBackendError
    if isinstance(exc, _TRANSIENT_EXC_TYPES):
        return TransientBackendError
    msg = str(exc)
    if (isinstance(exc, RuntimeError) and msg.startswith(_CUDA_ERROR_PREFIX)
            and any(marker in msg for marker in _CUDA_TRANSIENT_MARKERS)):
        return TransientBackendError
    return PermanentBackendError


def _contention_kwargs(num_engines: int, arbitration: str,
                       burst_beats: int,
                       mix: Optional[EngineMix] = None) -> dict:
    """The arbitration-axis kwargs, only when they deviate from the
    pre-§9 defaults — so backends registered against the older protocol
    signature keep working until a caller actually engages the axes.
    A (genuinely mixed, already-normalized) `mix` is likewise forwarded
    only when present, so pre-§13 backends keep serving homogeneous
    contention unchanged."""
    kwargs = {}
    if (num_engines, arbitration, burst_beats) != (1, "round_robin", 1):
        kwargs = {"num_engines": num_engines, "arbitration": arbitration,
                  "burst_beats": burst_beats}
    if mix is not None:
        kwargs["mix"] = mix
    return kwargs


def _arbitration_kwargs(arbitration: str, burst_beats: int,
                        mix: Optional[EngineMix] = None) -> dict:
    """Like `_contention_kwargs` for `Backend.contended_throughput`, whose
    pre-§9 protocol already took num_engines — only the grant axes (and,
    when present, the heterogeneous mix) are conditionally forwarded."""
    kwargs = {}
    if (arbitration, burst_beats) != ("round_robin", 1):
        kwargs = {"arbitration": arbitration, "burst_beats": burst_beats}
    if mix is not None:
        kwargs["mix"] = mix
    return kwargs


# ---------------------------------------------------------------------------
# Placement decomposition
# ---------------------------------------------------------------------------


def placement_port_counts(switch: SwitchModel, placement: str,
                          num_engines: int) -> Tuple[str, List[int]]:
    """(effective placement, engines per mini-switch port) for one
    contention placement.

    ``same_channel`` keeps all N engines on one port.  The cross-channel
    placements spread them over the mini-switch's AXI ports as evenly as
    possible; on a single-switch (flat) fabric ``cross_switch`` degrades
    to ``same_switch`` (there is no switch to cross).  Pure planning —
    no DRAM-side evaluation.
    """
    if placement not in PLACEMENTS:
        raise ValueError(
            f"unknown placement {placement!r}; valid: {PLACEMENTS}")
    if placement == "same_channel":
        return placement, [num_engines]
    effective = placement
    if placement == "cross_switch" and not switch.can_cross_switch():
        effective = "same_switch"
    ports = min(num_engines, switch.topology.axi_per_switch)
    counts = [num_engines // ports + (1 if i < num_engines % ports else 0)
              for i in range(ports)]
    return effective, counts


def placement_mix_slices(counts: List[int]) -> List[Tuple[int, int]]:
    """Contiguous ``(lo, hi)`` entry slices assigning an EngineMix's
    entries to the per-port engine counts of `placement_port_counts`.

    Entry order is grant order, so the decomposition is *contiguous*:
    port 0 gets entries ``[0:counts[0])``, port 1 the next ``counts[1]``,
    and so on — a deterministic placement rule, so cache keys built from
    the sub-mixes agree across paths.
    """
    slices = []
    lo = 0
    for c in counts:
        slices.append((lo, lo + c))
        lo += c
    return slices


def combine_placement_ports(switch: SwitchModel, placement: str,
                            effective: str, num_engines: int,
                            ports: List[Tuple[int,
                                              "timing_model.ContentionResult"]],
                            *, arbitration: str, burst_beats: int,
                            mix: Optional[EngineMix] = None
                            ) -> "timing_model.ContentionResult":
    """Fold an *ordered* list of per-port ``(count, result)`` pairs into
    one placement result.

    The general form of :func:`combine_placement`: the count-keyed
    mapping cannot represent a heterogeneous placement where two ports
    carry the same engine count but different sub-mixes, so the batch and
    Engine mix paths hand over the per-port results positionally.  The
    summed aggregate is capped by the fabric's capacity terms — the
    mini-switch aggregate datapath for ``same_switch``, additionally the
    lateral bridge for ``cross_switch`` — and the queueing delay is the
    engine-weighted mean of the per-port delays.  `mix`, when given, is
    recorded on the combined result.
    """
    topo = switch.topology
    raw_aggregate = sum(res.aggregate_gbps for _, res in ports)
    queueing = sum(c * res.queueing_delay_cycles
                   for c, res in ports) / num_engines
    dominant = max(ports, key=lambda cr: cr[0])[1]
    max_count = max(c for c, _ in ports)
    aggregate, bound = raw_aggregate, dominant.bound
    cap = switch.capacity_cap_gbps(effective)
    if cap is not None and raw_aggregate > cap:
        aggregate = cap
        lateral = topo.lateral_gbps
        bound = ("lateral"
                 if effective == "cross_switch" and lateral is not None
                 and cap == lateral else "switch")
    detail = {**dominant.detail,
              "ports": float(len(ports)),
              "engines_per_port_max": float(max_count),
              "uncapped_aggregate_gbps": raw_aggregate,
              "capacity_cap_gbps":
                  cap if cap is not None else float("inf"),
              "placement_degraded":
                  1.0 if effective != placement else 0.0}
    return timing_model.ContentionResult(
        num_engines=num_engines, aggregate_gbps=aggregate, bound=bound,
        queueing_delay_cycles=queueing, detail=detail,
        arbitration=arbitration, burst_beats=burst_beats,
        placement=placement, mix=mix)


def combine_placement(switch: SwitchModel, placement: str, effective: str,
                      num_engines: int, counts: List[int],
                      per_count: Dict[int, "timing_model.ContentionResult"],
                      *, arbitration: str, burst_beats: int
                      ) -> "timing_model.ContentionResult":
    """Fold per-port contention results into one placement result.

    `per_count` maps each distinct per-port engine count to that port's
    DRAM-side result (same_channel model) — sufficient for homogeneous
    placements, where every port with the same count is interchangeable.
    Thin wrapper over :func:`combine_placement_ports` (the ordered
    general form the heterogeneous paths use).
    """
    return combine_placement_ports(
        switch, placement, effective, num_engines,
        [(c, per_count[c]) for c in counts],
        arbitration=arbitration, burst_beats=burst_beats)


# ---------------------------------------------------------------------------
# Backend protocol + registry
# ---------------------------------------------------------------------------


class Backend:
    """One execution substrate for the RST measurements.

    Subclass, set the class attributes, implement `throughput` (and
    `latency` if the substrate has per-transaction timers), then
    `register_backend(MyBackend())`.

    `throughput` returns the *unscaled* per-channel result — the switch
    datapath scale (Fig. 8) is applied by the Engine/Sweep layer, which
    knows channel positions.  `deterministic` declares that results are a
    pure function of (spec, params, policy, op); the sweep layer memoizes
    and channel-broadcasts only deterministic backends.

    The §9 contention axes (`num_engines`/`arbitration`/`burst_beats` on
    `latency`, `arbitration`/`burst_beats` on `contended_throughput`) are
    forwarded by the Engine only when they deviate from their defaults, so
    a backend registered against the pre-§9 signatures keeps serving
    uncontended measurements and fails with a plain TypeError only when a
    caller actually engages the new axes.
    """

    name: str = ""
    deterministic: bool = False
    supports_latency: bool = False
    supports_contention: bool = False

    def throughput(self, spec: MemorySpec, p: RSTParams,
                   mapping: AddressMapping, *,
                   op: str = "read") -> timing_model.ThroughputResult:
        raise NotImplementedError

    def latency(self, spec: MemorySpec, p: RSTParams,
                mapping: AddressMapping, *, switch_enabled: bool,
                switch_extra_cycles: int, op: str = "read",
                num_engines: int = 1, arbitration: str = "round_robin",
                burst_beats: int = 1,
                mix: Optional[EngineMix] = None
                ) -> timing_model.LatencyTrace:
        raise UnsupportedCapability(
            f"backend {self.name!r} has no per-transaction timers "
            f"(supports_latency=False); cannot measure serial {op!r} "
            f"latencies — use the sim backend (DESIGN.md §2)")

    def contended_throughput(self, spec: MemorySpec, p: RSTParams,
                             mapping: AddressMapping, *, num_engines: int,
                             op: str = "read",
                             arbitration: str = "round_robin",
                             burst_beats: int = 1,
                             mix: Optional[EngineMix] = None
                             ) -> timing_model.ContentionResult:
        raise UnsupportedCapability(
            f"backend {self.name!r} has no multi-engine contention path "
            f"(supports_contention=False); use the sim backend "
            f"(DESIGN.md §8)")


class SimBackend(Backend):
    """Calibrated DRAM timing model (core/timing_model.py)."""

    name = "sim"
    deterministic = True
    supports_latency = True
    supports_contention = True

    def throughput(self, spec, p, mapping, *, op="read"):
        return timing_model.throughput(p, mapping, spec, op=op)

    def latency(self, spec, p, mapping, *, switch_enabled,
                switch_extra_cycles, op="read", num_engines=1,
                arbitration="round_robin", burst_beats=1, mix=None):
        return timing_model.serial_latencies(
            p, mapping, spec, op=op, switch_enabled=switch_enabled,
            switch_extra_cycles=switch_extra_cycles,
            num_engines=num_engines, arbitration=arbitration,
            burst_beats=burst_beats, mix=mix)

    def contended_throughput(self, spec, p, mapping, *, num_engines,
                             op="read", arbitration="round_robin",
                             burst_beats=1, mix=None):
        if mix is not None:
            return timing_model.contended_throughput_mix(
                mix, mapping, spec, arbitration=arbitration,
                burst_beats=burst_beats)
        return timing_model.contended_throughput(
            p, mapping, spec, num_engines=num_engines, op=op,
            arbitration=arbitration, burst_beats=burst_beats)


class CudaBackend(Backend):
    """The RST engines on the CUDA card (kernels/rst_read.py,
    rst_write.py).

    All three traffic directions are wired: ``read`` -> rst_read,
    ``write`` -> rst_write, ``duplex`` -> both over one buffer
    (ops.measure_duplex_bandwidth).  The kernels traverse a working buffer
    through the card's own memory controller, so `spec` and `mapping` are
    ignored.  `device` is the card by default; ``device="cpu"`` runs the
    kernels' plain PyTorch versions (a correctness path whose seconds are
    host time, not a device measurement).  Latency raises: the card has no
    per-transaction timers.  Multi-engine contention waits for its
    kernels (rst_contend_read / rst_contend_mix_read), so
    ``supports_contention`` is False and `contended_throughput` raises.
    """

    name = "cuda"
    deterministic = False
    supports_latency = False
    supports_contention = False

    def __init__(self, device: "torch.device | str | None" = None):
        self.device = device

    def throughput(self, spec, p, mapping, *, op="read"):
        del spec, mapping  # the device's controller, not the model's
        # Deferred: kernels.ops imports repro_torch.core, whose package
        # import reaches this module.
        from repro_torch.kernels import ops
        measurers = {"read": ops.measure_read_bandwidth,
                     "write": ops.measure_write_bandwidth,
                     "duplex": ops.measure_duplex_bandwidth}
        if op not in measurers:
            raise ValueError(
                f"unknown op {op!r} for the cuda backend; valid: "
                f"{sorted(measurers)}")
        sample = measurers[op](p, device=self.device)
        # The checksum's sum lets a caller check that the kernels touched
        # the bytes they were asked to move.
        return timing_model.ThroughputResult(
            gbps=sample.gbps, bound="measured",
            detail={"seconds": sample.seconds,
                    "bytes": float(sample.bytes_moved),
                    "checksum": float(np.sum(sample.checksum,
                                             dtype=np.float64))})


_BACKEND_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend, *, override: bool = False) -> Backend:
    """Register a Backend instance under its `name`; returns it."""
    if not backend.name:
        raise ValueError("backend must set a non-empty `name`")
    if backend.name in _BACKEND_REGISTRY and not override:
        raise ValueError(
            f"backend {backend.name!r} already registered; pass "
            f"override=True to replace it")
    _BACKEND_REGISTRY[backend.name] = backend
    return backend


def available_backends() -> List[str]:
    """Names of every registered backend, registration order."""
    return list(_BACKEND_REGISTRY)


def get_backend(name: str) -> Backend:
    backend = _BACKEND_REGISTRY.get(name)
    if backend is None:
        raise ValueError(
            f"unknown backend {name!r}; registered: {available_backends()}")
    return backend


register_backend(SimBackend())
register_backend(CudaBackend())


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Engine:
    """One engine module attached to one AXI channel."""

    channel: int
    spec: MemorySpec = HBM
    backend: str = "sim"
    switch: Optional[SwitchModel] = None
    registers: EngineRegisters = dataclasses.field(default_factory=EngineRegisters)

    def __post_init__(self):
        self.backend_impl: Backend = get_backend(self.backend)
        # Per-port contended results shared across placements/ladder rungs
        # (deterministic backends only): the cross-channel placements
        # decompose into the same (count, grant) DRAM-side evaluations
        # over and over — e.g. every placement's N=1 port is the same run.
        self._port_cache: Dict[Tuple, timing_model.ContentionResult] = {}
        if self.switch is None and self.spec.has_switch:
            # Resolve the spec's registered fabric (core/channels.py); an
            # unregistered or mismatched topology fails here, not deep in
            # a sweep with wrong distances.
            self.switch = SwitchModel(topology_for(self.spec), enabled=True)

    # -- register plumbing (parameter module side) ---------------------------
    def configure_read(self, p: RSTParams) -> None:
        p.validate(self.spec)
        self.registers = self.registers.with_read(p)

    def configure_write(self, p: RSTParams) -> None:
        p.validate(self.spec)
        self.registers = self.registers.with_write(p)

    def _mapping(self, policy: Optional[str]) -> AddressMapping:
        return get_mapping(self.spec, policy)

    def _switch_extra(self, dst_channel: Optional[int]) -> int:
        if not self.spec.has_switch or self.switch is None:
            return 0
        dst = self.channel if dst_channel is None else dst_channel
        return self.switch.total_extra_cycles(self.channel, dst)

    def throughput_scale(self, dst_channel: Optional[int]) -> float:
        """Switch datapath scale for a read hitting `dst_channel` (Fig. 8)."""
        if not self.spec.has_switch or self.switch is None:
            return 1.0
        dst = self.channel if dst_channel is None else dst_channel
        return self.switch.throughput_scale(self.channel, dst)

    # -- parameter-direct evaluation (used by register methods and sweeps) ---
    def evaluate_throughput(self, p: RSTParams, *,
                            policy: Optional[str] = None,
                            dst_channel: Optional[int] = None,
                            op: str = "read") -> timing_model.ThroughputResult:
        """Evaluate one throughput point without touching the register file."""
        p = p.validate(self.spec)
        res = self.backend_impl.throughput(self.spec, p,
                                           self._mapping(policy), op=op)
        if self.backend_impl.deterministic:
            # Model backends see the switch through the datapath scale (the
            # same non-blocking path carries reads, writes and duplex,
            # Fig. 8); a measuring backend's number already includes the
            # real switch.
            scale = self.throughput_scale(dst_channel)
            if scale != 1.0:
                res = dataclasses.replace(res, gbps=res.gbps * scale)
        return res

    def latency_config(self, dst_channel: Optional[int] = None,
                       switch_enabled: Optional[bool] = None
                       ) -> Tuple[bool, int]:
        """Resolve (switch_enabled, extra_cycles) for a latency run.  The
        switch is DISABLED by default, matching paper footnote 6."""
        enabled = (False if switch_enabled is None else switch_enabled)
        extra = 0
        if enabled and self.spec.has_switch and self.switch is not None:
            sw = dataclasses.replace(self.switch, enabled=True)
            dst = self.channel if dst_channel is None else dst_channel
            extra = sw.distance_extra_cycles(self.channel, dst)
        return enabled, extra

    def evaluate_latency(self, p: RSTParams, *,
                         policy: Optional[str] = None,
                         dst_channel: Optional[int] = None,
                         switch_enabled: Optional[bool] = None,
                         op: str = "read",
                         num_engines: int = 1,
                         arbitration: str = "round_robin",
                         burst_beats: int = 1,
                         mix: Optional[EngineMix] = None
                         ) -> timing_model.LatencyTrace:
        """Evaluate one serial-latency point without the register file.

        ``num_engines > 1`` yields a *contended* trace: the shared port's
        queueing delay is fed back into the per-transaction latencies at
        the requested arbitration granularity (DESIGN.md §9).  `mix`
        names the full heterogeneous engine set sharing the port; the
        observed engine stays ``(p, op)`` and must be one of the mix
        entries (DESIGN.md §13).  A uniform mix equal to the observed
        engine reduces to the homogeneous spelling before the backend is
        consulted, so legacy backends and memo keys never see it."""
        p = p.validate(self.spec)
        if mix is not None:
            if mix.uniform_entry() == (p, op):
                num_engines, mix = len(mix), None
            else:
                num_engines = len(mix)
        enabled, extra = self.latency_config(dst_channel, switch_enabled)
        # Forward the contention axes only when engaged: a third-party
        # backend implementing the pre-§9 protocol signature keeps
        # serving uncontended captures unchanged, and fails with a clear
        # TypeError only when actually asked for the new axes.
        contended_kw = _contention_kwargs(num_engines, arbitration,
                                          burst_beats, mix)
        return self.backend_impl.latency(
            self.spec, p, self._mapping(policy),
            switch_enabled=enabled, switch_extra_cycles=extra, op=op,
            **contended_kw)

    def _switch_model(self) -> SwitchModel:
        """The fabric the contention placements consult: the engine's own
        switch on switched specs, the spec's registered (flat) topology
        otherwise."""
        if self.switch is not None:
            return self.switch
        return SwitchModel(topology_for(self.spec), enabled=True)

    def _port_contended(self, p: RSTParams, *, num_engines: int,
                        policy: Optional[str], op: str, arbitration: str,
                        burst_beats: int,
                        mix: Optional[EngineMix] = None
                        ) -> timing_model.ContentionResult:
        """One shared-port DRAM-side contention result, memoized per engine
        on deterministic backends (the placement decomposition re-asks for
        the same (count, grant) evaluation across placements and ladder
        rungs).  `mix` is already normalized (None or genuinely mixed) and
        participates in the memo key.  The arbitration axes are forwarded
        only when engaged — see `_contention_kwargs` /
        `_arbitration_kwargs`."""
        kwargs = _arbitration_kwargs(arbitration, burst_beats, mix)
        if not self.backend_impl.deterministic:
            return self.backend_impl.contended_throughput(
                self.spec, p, self._mapping(policy),
                num_engines=num_engines, op=op, **kwargs)
        key = (p, policy, op, num_engines, arbitration, burst_beats, mix)
        res = self._port_cache.get(key)
        if res is None:
            res = self.backend_impl.contended_throughput(
                self.spec, p, self._mapping(policy),
                num_engines=num_engines, op=op, **kwargs)
            self._port_cache[key] = res
        return res

    def _contention_unscaled(self, p: RSTParams, *, num_engines: int,
                             policy: Optional[str], op: str,
                             arbitration: str, burst_beats: int,
                             placement: str,
                             mix: Optional[EngineMix] = None
                             ) -> timing_model.ContentionResult:
        """Placement-routed contention result, before the switch scale.

        ``same_channel`` is the DRAM-side model: N engines multiplexed
        onto one channel port.  The cross-channel placements (DESIGN.md
        §9) spread the engines over the mini-switch's ports — each port's
        engines run through the same DRAM-side model — and cap the summed
        aggregate with the fabric's capacity terms: the mini-switch
        aggregate datapath for ``same_switch``, additionally the lateral
        bridge for ``cross_switch``.  On a single-switch (flat) fabric
        ``cross_switch`` degrades to ``same_switch`` (there is no switch
        to cross; ``detail["placement_degraded"]`` records it).  A
        heterogeneous `mix` decomposes its entry tuple *contiguously*
        across the per-port counts (`placement_mix_slices`), each port's
        sub-mix re-normalized so uniform ports share the homogeneous
        memo entries, and recombines through `combine_placement_ports`.
        """
        if placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {placement!r}; valid: {PLACEMENTS}")
        if placement == "same_channel":
            return self._port_contended(
                p, num_engines=num_engines, policy=policy, op=op,
                arbitration=arbitration, burst_beats=burst_beats, mix=mix)
        sw = self._switch_model()
        effective, counts = placement_port_counts(sw, placement,
                                                  num_engines)
        if mix is not None:
            ports = []
            for lo, hi in placement_mix_slices(counts):
                sub = EngineMix.of(mix.entries[lo:hi])
                sub_mix, sp, sop, sn = normalize_mix(sub, p, op, hi - lo)
                ports.append((hi - lo, self._port_contended(
                    sp, num_engines=sn, policy=policy, op=sop,
                    arbitration=arbitration, burst_beats=burst_beats,
                    mix=sub_mix)))
            return combine_placement_ports(
                sw, placement, effective, num_engines, ports,
                arbitration=arbitration, burst_beats=burst_beats, mix=mix)
        per_count = {
            c: self._port_contended(
                p, num_engines=c, policy=policy, op=op,
                arbitration=arbitration, burst_beats=burst_beats)
            for c in set(counts)}
        return combine_placement(sw, placement, effective, num_engines,
                                 counts, per_count,
                                 arbitration=arbitration,
                                 burst_beats=burst_beats)

    def evaluate_contention(self, p: RSTParams, *,
                            num_engines: int = 1,
                            policy: Optional[str] = None,
                            dst_channel: Optional[int] = None,
                            op: str = "read",
                            arbitration: str = "round_robin",
                            burst_beats: int = 1,
                            placement: str = "same_channel",
                            mix: Optional[EngineMix] = None
                            ) -> timing_model.ContentionResult:
        """N engines' streams through the selected arbitration granularity
        and fabric placement (the Choi et al. 2020 multi-PE scenarios;
        DESIGN.md §8/§9).  `mix` names a heterogeneous per-engine
        ``(params, op)`` tuple (DESIGN.md §13); when given it supersedes
        ``p``/``op``/``num_engines``, and a *uniform* mix normalizes back
        to the homogeneous spelling first, so both spellings hit the same
        memo entries and return bit-identical results."""
        mix, p, op, num_engines = normalize_mix(mix, p, op, num_engines)
        p = p.validate(self.spec)
        if mix is not None:
            mix.validate(self.spec)
        res = self._contention_unscaled(
            p, num_engines=num_engines, policy=policy, op=op,
            arbitration=arbitration, burst_beats=burst_beats,
            placement=placement, mix=mix)
        if self.backend_impl.deterministic:
            scale = self.throughput_scale(dst_channel)
            if scale != 1.0:
                res = dataclasses.replace(
                    res, aggregate_gbps=res.aggregate_gbps * scale)
        return res

    # -- read module ---------------------------------------------------------
    def read_throughput(self, policy: Optional[str] = None,
                        dst_channel: Optional[int] = None
                        ) -> timing_model.ThroughputResult:
        p = self.registers.read_params.validate(self.spec)
        res = self.evaluate_throughput(p, policy=policy,
                                       dst_channel=dst_channel, op="read")
        if self.backend_impl.deterministic:
            self.registers = dataclasses.replace(self.registers, status=p.n)
        return res

    def read_latency(self, policy: Optional[str] = None,
                     dst_channel: Optional[int] = None,
                     switch_enabled: Optional[bool] = None
                     ) -> timing_model.LatencyTrace:
        """Serial read latencies.  By default the switch is DISABLED for
        latency runs, matching paper footnote 6; pass switch_enabled=True
        for the Table VI experiments."""
        p = self.registers.read_params.validate(self.spec)
        return self.evaluate_latency(p, policy=policy, dst_channel=dst_channel,
                                     switch_enabled=switch_enabled)

    # -- write module ----------------------------------------------------------
    def write_throughput(self, policy: Optional[str] = None
                         ) -> timing_model.ThroughputResult:
        p = self.registers.write_params.validate(self.spec)
        return self.evaluate_throughput(p, policy=policy, op="write")

    def write_latency(self, policy: Optional[str] = None,
                      dst_channel: Optional[int] = None,
                      switch_enabled: Optional[bool] = None
                      ) -> timing_model.LatencyTrace:
        """Serial write latencies from the write register (tWR on the
        page-miss path; switch disabled by default like read_latency)."""
        p = self.registers.write_params.validate(self.spec)
        return self.evaluate_latency(p, policy=policy,
                                     dst_channel=dst_channel,
                                     switch_enabled=switch_enabled,
                                     op="write")

    def duplex_throughput(self, policy: Optional[str] = None
                          ) -> timing_model.ThroughputResult:
        """Read and write modules driving one channel concurrently; the
        params come from the read register (both modules share the RST
        tuple in this measurement, Sec. IV)."""
        p = self.registers.read_params.validate(self.spec)
        return self.evaluate_throughput(p, policy=policy, op="duplex")

    # -- latency module --------------------------------------------------------
    def capture_latency_list(self, op: str = "read", *,
                             depth: int = DEFAULT_DEPTH,
                             counter_bits: int = DEFAULT_COUNTER_BITS,
                             policy: Optional[str] = None,
                             dst_channel: Optional[int] = None,
                             switch_enabled: Optional[bool] = None,
                             num_engines: int = 1,
                             arbitration: str = "round_robin",
                             burst_beats: int = 1,
                             mix: Optional[EngineMix] = None) -> np.ndarray:
        """Capture up to `depth` serial latencies from the selected module.

        `op` picks the engine module whose register params drive the run
        (``"read"`` -> read register, ``"write"`` -> write register) and is
        threaded through ``evaluate_latency(op=...)``, so ``op="write"``
        captures serial *write* latencies (the tWR-bearing page-miss path)
        — the old capture path hard-wired ``read_latency`` and silently
        returned read latencies for every module.  `depth`/`counter_bits`
        are the capture list's synthesis parameters (DESIGN.md §8).

        ``num_engines > 1`` captures a *contended* list: the shared
        port's queueing delay at the requested arbitration granularity is
        fed back into the trace (every sample shifted under round robin,
        grant heads only under burst grants — the bimodal distribution
        ``LatencyModule.classify_contended`` separates; DESIGN.md §9).

        Backends without per-transaction timers cannot serve *any*
        serial capture; this raises :class:`UnsupportedCapability` (with
        the backend name and op) up front rather than falling through to
        a read-shaped substitute.
        """
        if op not in timing_model.SERIAL_OPS:
            raise ValueError(
                f"the capture list holds serial latencies; op must be one "
                f"of {timing_model.SERIAL_OPS}, got {op!r}")
        if not self.backend_impl.supports_latency:
            raise UnsupportedCapability(
                f"backend {self.backend!r} has no per-transaction timers "
                f"(supports_latency=False); cannot capture serial {op!r} "
                f"latencies — use the sim backend (DESIGN.md §2)")
        regs = (self.registers.read_params if op == "read"
                else self.registers.write_params)
        p = regs.validate(self.spec)
        trace = self.evaluate_latency(p, policy=policy,
                                      dst_channel=dst_channel,
                                      switch_enabled=switch_enabled, op=op,
                                      num_engines=num_engines,
                                      arbitration=arbitration,
                                      burst_beats=burst_beats, mix=mix)
        return LatencyModule(depth=depth, counter_bits=counter_bits,
                             op=op).capture(trace)
