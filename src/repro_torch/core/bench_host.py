"""Software component: the host-side campaign driver (paper Sec. III-B).

`ShuhaiCampaign` plays the role of the CPU software talking to the parameter
module over PCIe.  Since the experiment-registry redesign the suites
themselves live in :mod:`repro_torch.core.experiments` — one declarative
:class:`~repro_torch.core.experiments.Experiment` per paper table/figure, lowered
onto a batched :class:`~repro_torch.core.sweep.Sweep` by
:func:`~repro_torch.core.experiments.run_experiment`.

The `suite_*` methods below are **deprecated shims**: each one forwards its
arguments to the registered experiment of the same artifact and returns the
identical result structure.  They are kept so existing callers (and the
paper-era reading order: "every table/figure has a suite_* method") keep
working; new code should call `run_experiment` directly:

    from repro_torch.core.experiments import run_experiment
    run_experiment("fig6_address_mapping", spec=HBM3, backend="sim")

The campaign still owns M engines (M = spec.num_channels, Fig. 3) so the
register-faithful configure-then-trigger flow of the paper remains
demonstrable through `self.engines`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

from repro_torch.core.engine import Engine
from repro_torch.core.experiments import run_experiment
from repro_torch.core.hwspec import HBM, MemorySpec, available_specs, spec_by_name


def _deprecated(suite: str, experiment: str) -> None:
    # stacklevel: _deprecated(1) -> _run(2) -> suite_*(3) -> caller(4).
    warnings.warn(
        f"ShuhaiCampaign.{suite} is a deprecated shim; use "
        f"run_experiment({experiment!r}, spec, backend) instead",
        DeprecationWarning, stacklevel=4)


@dataclasses.dataclass
class ShuhaiCampaign:
    spec: MemorySpec = HBM
    backend: str = "sim"

    def __post_init__(self):
        m = self.spec.num_channels  # M engines, Fig. 3
        self.engines: List[Engine] = [
            Engine(channel=c, spec=self.spec, backend=self.backend)
            for c in range(m)
        ]

    # ------------------------------------------------------------------ utils
    def _engine(self, ch: int) -> Engine:
        return self.engines[ch]

    def _run(self, suite: str, experiment: str, **options):
        _deprecated(suite, experiment)
        return run_experiment(experiment, self.spec, self.backend, **options)

    # --------------------------------------------------------------- Fig. 4
    def suite_refresh(self, n: int = 1024) -> Dict[str, object]:
        """Deprecated shim for the ``fig4_refresh`` experiment."""
        return self._run("suite_refresh", "fig4_refresh", n=n)

    # ------------------------------------------------- Fig. 5 / Table IV
    def suite_idle_latency(self) -> Dict[str, Dict[str, float]]:
        """Deprecated shim for the ``table4_idle_latency`` experiment."""
        return self._run("suite_idle_latency", "table4_idle_latency")

    # --------------------------------------------------------------- Fig. 6
    def suite_address_mapping(
        self,
        strides: Optional[Sequence[int]] = None,
        bursts: Optional[Sequence[int]] = None,
        w: Optional[int] = None,
        n: Optional[int] = None,
    ) -> Dict[str, Dict[int, Dict[int, float]]]:
        """Deprecated shim for the ``fig6_address_mapping`` experiment."""
        return self._run("suite_address_mapping", "fig6_address_mapping",
                         strides=strides, bursts=bursts, w=w, n=n)

    # --------------------------------------------------------------- Fig. 7
    def suite_locality(
        self,
        strides: Optional[Sequence[int]] = None,
        bursts: Optional[Sequence[int]] = None,
        n: Optional[int] = None,
    ) -> Dict[int, Dict[int, Dict[int, float]]]:
        """Deprecated shim for the ``fig7_locality`` experiment.

        RST-invalid combinations (S < B or S > W, Table I) are omitted from
        the result, so consumers must guard lookups.
        """
        return self._run("suite_locality", "fig7_locality",
                         strides=strides, bursts=bursts, n=n)

    # --------------------------------------------------------------- Table V
    def suite_total_throughput(self) -> Dict[str, float]:
        """Deprecated shim for the ``table5_total_throughput`` experiment.

        Keeps the paper's register flow observable: every engine's read
        register is configured with the run's params and (on deterministic
        backends) the status register mirrors the completion count, as
        `read_throughput` would have (Sec. III-C-3).
        """
        res = self._run("suite_total_throughput", "table5_total_throughput")
        # The old suite returned numeric entries only; keep that contract
        # and use the grid's params for the register mirror instead.
        p = res.pop("params")
        for eng in self.engines:
            eng.configure_read(p)
            if eng.backend_impl.deterministic:
                eng.registers = dataclasses.replace(eng.registers,
                                                    status=p.n)
        return res

    # -------------------------------------------------------------- Table VI
    def suite_switch_latency(self, dst_channel: int = 0
                             ) -> Dict[int, Dict[str, float]]:
        """Deprecated shim for the ``table6_switch_latency`` experiment."""
        return self._run("suite_switch_latency", "table6_switch_latency",
                         dst_channel=dst_channel)

    # --------------------------------------------------------------- Fig. 8
    def suite_switch_throughput(
        self, dst_channel: int = 0,
        strides: Optional[Sequence[int]] = None,
    ) -> Dict[int, Dict[int, float]]:
        """Deprecated shim for the ``fig8_switch_throughput`` experiment."""
        return self._run("suite_switch_throughput", "fig8_switch_throughput",
                         dst_channel=dst_channel, strides=strides)


def default_campaigns(backend: str = "sim", *,
                      specs: Optional[Sequence[str]] = None
                      ) -> Dict[str, ShuhaiCampaign]:
    """One campaign per memory spec (default: every registered spec)."""
    names = list(specs) if specs else available_specs()
    return {name: ShuhaiCampaign(spec_by_name(name), backend)
            for name in names}
