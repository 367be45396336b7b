"""The paper-native end-to-end driver, on the port: run the FULL Shuhai
benchmarking campaign — every registered experiment (Sec. V and VI), every
requested memory system — against the calibrated simulator (`sim`, the
default) or the CUDA card (`--backend cuda`).

The campaign is declarative: each table/figure is an `Experiment` spec in
`repro_torch.core.experiments`; this driver only iterates the registry, so
a newly registered spec or experiment shows up here with no changes.
`--specs hbm,ddr4,hbm3,ddr3` exercises the paper's generalization claim:
the same campaign on HBM3 and DDR3.  On `cuda` an experiment the card's
kernels cannot run (the paper's 32-byte bursts against the kernels' 4 KiB
tile, or serial latencies) is skipped with the backend's refusal on
stderr; nothing falls back to `sim`.

Run: PYTHONPATH=src python -m repro_torch.examples.shuhai_campaign \
        [--csv out.csv] [--specs hbm,ddr4] \
        [--experiments table5_total_throughput,duplex_rw_sweep] \
        [--backend sim] [--full]
"""
import argparse
import sys

from repro_torch.core import available_specs, spec_by_name
from repro_torch.core.experiments import (experiments_for, get_experiment,
                                          run_experiment)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.shuhai_campaign")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--specs", default="hbm,ddr4",
                    help="comma-separated memory specs "
                         f"(registered: {','.join(available_specs())}); "
                         "'all' runs every registered spec")
    ap.add_argument("--experiments", default=None,
                    help="comma-separated experiment names (default: every "
                         "registered experiment applicable to the spec)")
    ap.add_argument("--backend", default="sim")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale grids (default: quick grids)")
    args = ap.parse_args(argv)

    names = (available_specs() if args.specs == "all"
             else args.specs.split(","))
    # Resolve every requested name up front: an unknown spec or experiment
    # exits with the registered choices, not a traceback mid-campaign.
    try:
        specs = [spec_by_name(n.strip()) for n in names]
        wanted = (None if args.experiments is None else
                  [get_experiment(n.strip())
                   for n in args.experiments.split(",")])
    except ValueError as e:
        raise SystemExit(f"shuhai_campaign: {e}")

    rows = [("system", "experiment", "key", "value")]
    for spec in specs:
        applicable = experiments_for(spec)
        selected = applicable if wanted is None else wanted
        for exp in selected:
            if exp not in applicable:
                # Explicitly requested but not runnable on this spec (e.g.
                # a switch suite on DDR): report it like the backend skips
                # below instead of silently producing no rows.
                print(f"skipping {exp.name} on {spec.name}: needs an "
                      f"inter-channel switch this spec does not have",
                      file=sys.stderr)
                continue
            try:
                res = run_experiment(exp, spec, args.backend,
                                     quick=not args.full)
            except (ValueError, NotImplementedError) as e:
                # e.g. latency experiments on a backend without
                # per-transaction timers — skip, don't abort the campaign.
                print(f"skipping {exp.name} on {spec.name}/{args.backend}: "
                      f"{e}", file=sys.stderr)
                continue
            for key, value in exp.rows(spec, res):
                rows.append((spec.name, exp.name, key, value))

    out = "\n".join(",".join(r) for r in rows)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(out + "\n")
        print(f"wrote {len(rows) - 1} measurements to {args.csv}")
    else:
        print(out)


if __name__ == "__main__":
    main()
