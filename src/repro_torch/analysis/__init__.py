"""repro-lint for the PyTorch/CUDA port: AST-driven invariant analysis of
``src/repro_torch`` and its tests.

The families are the reference's (``repro.analysis``), copied so the port
imports nothing of it, and pointed at the port's own files:

* ``cache_keys``     — REPRO-C*: memo/dedup key completeness in
  core/sweep.py, service/campaign.py and the tuner's probe cache.
* ``oracle_parity``  — REPRO-O*: every public timing-model function has a
  loop oracle and a parity test referencing both; every public
  ``timing_torch`` function a differential test against the NumPy model;
  every public envelope function a test.  Module aliases bind only to
  imports from ``repro_torch.``: the port's tests import both packages.
* ``capabilities``   — REPRO-B*: Backend subclasses declare the
  ``supports_*`` flag for every gated method they implement, or raise
  ``UnsupportedCapability``.
* ``kernel_shapes``  — REPRO-K*, rewritten for the CUDA launch path: the
  ctypes signatures and call sites against the ``extern "C"`` entry
  points, the operand packers' int32 guard and shapes, the working
  buffers' base, and the dtype codes.

Run ``python -m repro_torch.analysis.lint --baseline
analysis_baseline_torch.json``.
"""
from repro_torch.analysis.findings import Finding

__all__ = ["Finding"]
