"""Shuhai core, ported to PyTorch: the paper's contribution as a library.

Public surface (each name mirrors `repro.core`):
  RSTParams, EngineRegisters        — runtime parameters (Table I) + packing
  addresses_np / addresses_torch    — Eq. 1 address streams
  AddressMapping, get_mapping       — Table II policies (registrable:
                                      register_policies)
  serial_read_latencies, throughput — the calibrated timing model
  contended_throughput              — N engines sharing one channel port
                                      (ARBITRATION_POLICIES grant axis)
  Engine, Backend                   — engines + pluggable measurement
                                      backends (register_backend): `sim`,
                                      `cuda` and `torchgrid`;
                                      UnsupportedCapability marks missing
                                      backend abilities
  MemorySpec, register_spec         — registrable memory systems; HBM/DDR4
                                      (measured) + HBM3/DDR3 (modeled)
  ChipSpec, register_chip           — accelerator peaks for rooflines:
                                      TPU_V5E, H100_SXM
  measure_envelope, RooflineEnvelope — the measured (ERT-style) roofline
  Experiment, run_experiment        — declarative paper-artifact registry
                                      (catalog_markdown renders it)
  ShuhaiCampaign                    — deprecated suite shims over the registry
  Sweep                             — batch-first campaign grids (memoized)
  SwitchModel, SwitchTopology       — Sec. II / VI switch + parametric
                                      fabrics (register_topology)
  MemoryOracle, AccessPattern       — chip constants + modeled derating
  choose_layout, advise_microbatch  — the technique as a framework feature
  tune_layout, LayoutTuner          — measured knob search (layout_autotune)
"""
from repro_torch.core.address_mapping import (AddressMapping, get_mapping,
                                              policies_for,
                                              register_policies)
from repro_torch.core.autotune import (LayoutCandidate, LayoutConfig,
                                       LayoutTuner, TuneReport, TuneRound,
                                       advise_microbatch, advise_remat,
                                       choose_layout, score_layouts,
                                       tune_layout)
from repro_torch.core.bench_host import ShuhaiCampaign, default_campaigns
from repro_torch.core.channels import (CrossingLatencyTable, DDR4Topology,
                                       HBMTopology, SwitchTopology,
                                       available_topologies, flat_topology,
                                       register_topology, topology_for)
from repro_torch.core.engine import (Backend, CudaBackend, Engine,
                                     TorchGridBackend,
                                     UnsupportedCapability,
                                     available_backends, get_backend,
                                     register_backend)
from repro_torch.core.engine_mix import EngineMix
from repro_torch.core.experiments import (Experiment, all_experiments,
                                          catalog_markdown, experiments_for,
                                          get_experiment,
                                          register_experiment,
                                          run_experiment)
from repro_torch.core.hwspec import (DDR3, DDR4, H100_SXM, HBM, HBM3,
                                     TPU_V5E, ChipSpec, MemorySpec,
                                     available_chips, available_specs,
                                     chip_by_name, register_chip,
                                     register_spec, spec_by_name)
from repro_torch.core.latency import LatencyModule
from repro_torch.core.oracle import AccessPattern, MemoryOracle
from repro_torch.core.params import EngineRegisters, RSTParams
from repro_torch.core.roofline_empirical import (EnvelopePoint,
                                                 RooflineEnvelope,
                                                 build_envelope,
                                                 config_ceiling_gbps,
                                                 measure_envelope)
from repro_torch.core.rst import addresses_np, addresses_torch, block_params
from repro_torch.core.sweep import Sweep, SweepPoint, SweepResult
from repro_torch.core.switch import PLACEMENTS, SwitchModel
from repro_torch.core.timing_model import (ARBITRATION_POLICIES,
                                           ContentionResult, LatencyTrace,
                                           ThroughputResult,
                                           contended_throughput,
                                           refresh_interval_estimate,
                                           serial_latencies,
                                           serial_read_latencies, throughput)

__all__ = [
    "AddressMapping", "get_mapping", "policies_for", "register_policies",
    "LayoutCandidate", "LayoutConfig", "LayoutTuner", "TuneReport",
    "TuneRound", "advise_microbatch", "advise_remat", "choose_layout",
    "score_layouts", "tune_layout",
    "ShuhaiCampaign", "default_campaigns",
    "CrossingLatencyTable", "DDR4Topology", "HBMTopology", "SwitchTopology",
    "available_topologies", "flat_topology", "register_topology",
    "topology_for",
    "EnvelopePoint", "RooflineEnvelope", "build_envelope",
    "config_ceiling_gbps", "measure_envelope",
    "Backend", "CudaBackend", "Engine", "TorchGridBackend",
    "UnsupportedCapability",
    "available_backends", "get_backend", "register_backend",
    "EngineMix",
    "Experiment", "all_experiments", "catalog_markdown", "experiments_for",
    "get_experiment", "register_experiment", "run_experiment",
    "DDR3", "DDR4", "HBM", "HBM3", "H100_SXM", "TPU_V5E", "ChipSpec",
    "MemorySpec", "available_chips", "available_specs", "chip_by_name",
    "register_chip", "register_spec", "spec_by_name",
    "LatencyModule", "AccessPattern", "MemoryOracle",
    "EngineRegisters", "RSTParams",
    "addresses_np", "addresses_torch", "block_params",
    "Sweep", "SweepPoint", "SweepResult",
    "SwitchModel", "LatencyTrace", "ThroughputResult", "ContentionResult",
    "ARBITRATION_POLICIES", "PLACEMENTS",
    "contended_throughput", "refresh_interval_estimate", "serial_latencies",
    "serial_read_latencies", "throughput",
]
