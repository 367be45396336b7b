"""Roofline reports: the measured envelope.

The JAX package's `launch/roofline.py` has two modes that share one
report schema (`REPORT_FIELDS` / `report_markdown`): an analytic one over
the LM substrate's dry-run artifacts, and the measured one.  This module
carries the measured mode (``--measured``): the ERT-style empirical
roofline from `core/roofline_empirical.py` — bandwidth tiers per
placement measured through a Sweep, with knees computed against measured
rates instead of the data sheet.  Chip compute peaks resolve through the
`core/hwspec.py` chip registry (``--chip``, default the H100 SXM), never a
hardcoded part.  The analytic mode needs the LM substrate (models,
configs, launch shapes), which this package does not have yet.

The report's `frac_of_nominal` divides by the memory spec's modeled wire
rate (`RooflineEnvelope.fraction_of_nominal`), not by any rate of the
card.  At its defaults ``--measured`` probes the spec's minimum burst
(32 B on HBM), which no CUDA kernel tile matches, so
``--backend cuda`` raises; the card's shapes (4 KiB tiles) go through
`measure_envelope(..., bursts=(4096,), ...)` and the report functions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline \
      --measured --spec hbm --backend sim --chip h100_sxm
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.hwspec import chip_by_name, spec_by_name

DEFAULT_CHIP = "h100_sxm"

# ---------------------------------------------------------------------------
# Shared report schema — the analytic and measured modes render the same
# columns so reports can sit side by side in one document.

REPORT_FIELDS = ("source", "cell", "bw_gbps", "knee_ai", "frac_of_nominal",
                 "bound")


def envelope_report_rows(env: Any) -> List[Dict[str, Any]]:
    """A `RooflineEnvelope` as shared-schema rows: one per placement tier
    (per-engine) plus the aggregate peak."""
    rows = []
    for plc, gbps in env.placement_gbps.items():
        rows.append({
            "source": "measured",
            "cell": f"{env.spec_name}/{plc}/per-engine",
            "bw_gbps": gbps,
            "knee_ai": env.knee_ai(gbps=gbps),
            "frac_of_nominal": env.fraction_of_nominal(gbps),
            "bound": "memory",
        })
    rows.append({
        "source": "measured",
        "cell": f"{env.spec_name}/peak/aggregate",
        "bw_gbps": env.peak_gbps,
        "knee_ai": env.knee_ai(),
        "frac_of_nominal": None,
        "bound": "memory",
    })
    return rows


def report_markdown(rows: List[Dict[str, Any]]) -> str:
    out = ["| source | cell | bw GB/s | knee AI | frac of nominal | bound |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        frac = ("-" if r["frac_of_nominal"] is None
                else f"{r['frac_of_nominal']:.3f}")
        out.append(f"| {r['source']} | {r['cell']} | {r['bw_gbps']:.2f} "
                   f"| {r['knee_ai']:.1f} | {frac} | {r['bound']} |")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--out", default=None)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--chip", default=DEFAULT_CHIP,
                    help="chip registry name for compute peaks")
    ap.add_argument("--measured", action="store_true",
                    help="measure the empirical envelope (the only mode "
                         "of this package)")
    ap.add_argument("--spec", default="hbm",
                    help="memory spec for --measured")
    ap.add_argument("--backend", default="sim",
                    help="measurement backend for --measured")
    ap.add_argument("--quick", action="store_true",
                    help="quick sweep overlay for --measured")
    args = ap.parse_args(argv)
    if not args.measured:
        ap.error("the analytic report needs the LM substrate (models, "
                 "configs, launch shapes), which repro_torch does not have "
                 "yet; pass --measured")
    chip = chip_by_name(args.chip)

    from repro_torch.core.roofline_empirical import measure_envelope
    env = measure_envelope(spec_by_name(args.spec), args.backend,
                           quick=args.quick, chip=chip.name)
    report = envelope_report_rows(env)
    md = report_markdown(report)
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
