"""Roofline reports: dry-run analytic cells and the measured envelope.

Two modes share one report schema (`REPORT_FIELDS` / `report_markdown`):

**Analytic** (default) — per (arch x shape x mesh) cell, from first
principles over the dry run's records (`launch/dryrun.py`, whose records
have the reference's keys, so either package's records are read):

  compute term    = FLOPs / peak_FLOP/s                (per chip)
  memory term     = HBM bytes / HBM_bw                 (per chip)
  collective term = collective bytes / link_bw         (per chip)

The terms are the reference's formulas (`analytic_terms`), divided by the
peaks of the chip named by ``--chip`` (default the H100 SXM's data
sheet: a model of that part, not a measurement).  MODEL_FLOPS uses the
6·N·D (train) / 2·N·D (inference) convention with N = active
parameters, and the ratio MODEL_FLOPS / (FLOPs x chips) exposes
remat/redundancy waste.

**Measured** (``--measured``) — the ERT-style empirical roofline from
`core/roofline_empirical.py`: bandwidth tiers per placement measured
through a Sweep, with knees computed against measured rates instead of
the data sheet.  Chip compute peaks resolve through the `core/hwspec.py`
chip registry (``--chip``), never a hardcoded part.  The report's
`frac_of_nominal` divides by the memory spec's modeled wire rate
(`RooflineEnvelope.fraction_of_nominal`), not by any rate of the card.
At its defaults ``--measured`` probes the spec's minimum burst (32 B on
HBM), which no CUDA kernel tile matches, so ``--backend cuda`` raises;
the card's shapes (4 KiB tiles) go through
`measure_envelope(..., bursts=(4096,), ...)` and the report functions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline \
      --in-dir build/dryrun --out build/roofline.md
  PYTHONPATH=src python -m repro_torch.launch.roofline \
      --measured --spec hbm --backend sim --chip h100_sxm
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.hwspec import ChipSpec, chip_by_name, spec_by_name
from repro_torch.launch.shapes import SHAPES
from repro_torch.models.common import param_count
from repro_torch.models.registry import build

DEFAULT_CHIP = "h100_sxm"


def active_params(arch: str) -> float:
    """Active (per-token) parameter count: total minus unrouted experts."""
    cfg = get_config(arch)
    model = build(cfg)
    specs = model.param_specs()
    total = param_count(specs)
    if cfg.moe is None:
        return float(total)

    def routed_expert_params(tree) -> int:
        out = 0
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("w_gate", "w_up", "w_down") and hasattr(v, "shape") \
                        and len(v.shape) >= 3:
                    # stacked experts: (L?, E, d, f) — expert dim present
                    out += math.prod(v.shape)
                else:
                    out += routed_expert_params(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                out += routed_expert_params(v)
        return out

    routed = routed_expert_params(specs)
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return float(total - routed + routed * frac)


def tokens_of(shape_name: str) -> int:
    s = SHAPES[shape_name]
    if s.kind == "train" or s.kind == "prefill":
        return s.global_batch * s.seq_len
    return s.global_batch      # one token per sequence


def model_flops(arch: str, shape_name: str) -> float:
    n_active = active_params(arch)
    toks = tokens_of(shape_name)
    mult = 6.0 if SHAPES[shape_name].kind == "train" else 2.0
    return mult * n_active * toks


def _mesh_ways(mesh: str):
    return (512, 32, 16) if mesh == "2x16x16" else (256, 16, 16)


def analytic_terms(arch: str, shape_name: str, mesh: str,
                   n_micro: int) -> Dict[str, float]:
    """Per-device roofline inputs from first principles.

    Why analytic: XLA's HLO cost analysis counts while-loop bodies ONCE, so
    for scanned models (layers x microbatches) the reported FLOPs/bytes are
    up to L x n_micro too small — useless for a roofline.  The compiled
    artifacts (memory_analysis, collective op inventory) are still recorded
    raw in experiments/dryrun/*.json.

    Model (per device, per step):
      flops    = mult * N_active * tokens/chips * remat + attention flops
                 (mult 6 train / 2 inference; remat 4/3 for save_boundaries)
      hbm      = weight streaming (n_micro or 1 passes over the local +
                 gathered shard) + optimizer traffic (train) + KV cache
                 read (decode) + activation traffic
      coll     = FSDP all-gather of weights per microbatch + gradient
                 reduce-scatter/all-gather (train); TP activation
                 all-gather/reduce-scatter per layer (SP); decode: small
                 per-token combines
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips, dp, tp = _mesh_ways(mesh)
    n_act = active_params(arch)
    n_tot = float(param_count(build(cfg).param_specs()))
    toks = tokens_of(shape_name)
    kind = shape.kind

    # ---- compute -----------------------------------------------------
    mult = 6.0 if kind == "train" else 2.0
    remat = (4.0 / 3.0 if (kind == "train" and cfg.remat != "none") else 1.0)
    flops = mult * n_act * toks * remat
    # attention score/value flops: 2 matmuls * 2 (qk + pv) * causal 1/2.
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    if kind == "train":
        s = shape.seq_len
        att = mult * remat * L * H * hd * s * s * shape.global_batch
        if cfg.attn_window:
            att *= min(1.0, 2.0 * cfg.attn_window / s)
        if cfg.mixer == "rwkv6":
            att = 2 * mult * L * (cfg.d_model // cfg.rwkv.head_size) \
                * cfg.rwkv.head_size**2 * toks
    elif kind == "prefill":
        att = 2.0 * L * H * hd * shape.seq_len * shape.seq_len \
            * shape.global_batch
        if cfg.attn_window:
            att *= min(1.0, 2.0 * cfg.attn_window / shape.seq_len)
    else:
        att = 4.0 * L * H * hd * shape.seq_len * shape.global_batch
    flops_dev = (flops + att) / chips

    # ---- HBM bytes -----------------------------------------------------
    weight_passes = n_micro if kind == "train" else 1
    w_bytes = weight_passes * 2.0 * n_tot / tp          # bf16 local stream
    opt_bytes = (16.0 * n_tot / chips) if kind == "train" else 0.0
    act_bytes = (kind != "decode") * 12.0 * toks / dp * cfg.d_model * 2.0 \
        * min(cfg.num_layers, 8)        # live working set per layer window
    cache_bytes = 0.0
    if kind == "decode":
        if cfg.mixer == "mla":
            per_tok = cfg.mla.kv_lora + cfg.mla.qk_rope
        elif cfg.mixer == "rwkv6":
            per_tok = 0.0
        else:
            per_tok = 2.0 * cfg.num_kv_heads * cfg.head_dim
        eff_len = shape.seq_len
        if cfg.attn_window:
            n_global = sum(cfg.layer_is_global(i)
                           for i in range(cfg.num_layers))
            eff_len = (cfg.attn_window * (cfg.num_layers - n_global)
                       + shape.seq_len * n_global) / cfg.num_layers
        cache_bytes = (cfg.num_layers * shape.global_batch * eff_len
                       * per_tok * 2.0) / chips
        if cfg.mixer == "rwkv6":
            r = cfg.rwkv
            cache_bytes = (cfg.num_layers * shape.global_batch
                           * (cfg.d_model // r.head_size) * r.head_size**2
                           * 4.0) / chips
    hbm_dev = w_bytes + opt_bytes + act_bytes + cache_bytes

    # ---- collective bytes ----------------------------------------------
    if kind == "train":
        fsdp_gather = n_micro * 2.0 * 2.0 * n_tot / tp / dp * (dp > 1)
        grad_reduce = 2.0 * 4.0 * n_tot / tp / dp
        sp_traffic = 0.0
        if True:  # SP region gathers: 4 gathers+scatters per layer
            sp_traffic = (n_micro * 8.0 * cfg.num_layers
                          * (toks / n_micro / dp) * cfg.d_model * 2.0)
        coll_dev = fsdp_gather + grad_reduce + sp_traffic
    elif kind == "prefill":
        coll_dev = (2.0 * n_tot / tp / dp * (dp > 1)
                    + 4.0 * cfg.num_layers * (toks / dp) * cfg.d_model * 2.0)
    else:
        # decode: per-token partial-softmax combines + logits gather.
        coll_dev = (cfg.num_layers * shape.global_batch * cfg.d_model * 2.0
                    * 4.0) / chips + 2.0 * n_tot / tp / dp * (dp > 1) * 0.0
    return {"flops_dev": flops_dev, "hbm_dev": hbm_dev, "coll_dev": coll_dev}


def analyze_cell(rec: Dict, chip: Optional[ChipSpec] = None
                 ) -> Optional[Dict]:
    if rec.get("status") != "OK":
        return None
    chips = 512 if rec["mesh"] == "2x16x16" else 256
    if chip is None:
        chip = chip_by_name(DEFAULT_CHIP)
    t = analytic_terms(rec["arch"], rec["shape"], rec["mesh"],
                       rec.get("n_micro", 1))

    compute_s = t["flops_dev"] / chip.peak_bf16_flops
    memory_s = t["hbm_dev"] / chip.hbm_bandwidth
    collective_s = t["coll_dev"] / chip.ici_link_bandwidth
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=lambda k: terms[k])
    bound_s = max(terms.values())

    mf = model_flops(rec["arch"], rec["shape"])
    useful = mf / (t["flops_dev"] * chips) if t["flops_dev"] else 0.0
    # Roofline fraction: ideal time (model flops at fleet peak) over the
    # dominant-term time — what fraction of an ideal machine this step
    # achieves if perfectly overlapped everywhere else.
    ideal_s = mf / (chips * chip.peak_bf16_flops)
    frac = ideal_s / bound_s if bound_s > 0 else 0.0

    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "kind")},
        "chip": chip.name,
        "chips": chips,
        "flops_per_dev": t["flops_dev"],
        "hbm_bytes_per_dev": t["hbm_dev"],
        "coll_bytes_per_dev": t["coll_dev"],
        "hlo_raw_flops": rec["cost"]["flops"],
        "hlo_raw_coll_bytes": rec["collectives"].get("total", 0.0),
        "compute_ms": compute_s * 1e3,
        "memory_ms": memory_s * 1e3,
        "collective_ms": collective_s * 1e3,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "useful_flops_frac": min(useful, 1.0),
        "roofline_frac": frac,
        "peak_gib": rec.get("memory", {}).get("peak_per_device_gib"),
    }


def load_records(in_dir: str) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(in_dir, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def advise(row: Dict) -> str:
    """One sentence: what would move the dominant term down."""
    d = row["dominant"]
    if d == "compute":
        if row["useful_flops_frac"] < 0.5:
            return ("compute-bound with low useful-FLOP fraction: reduce "
                    "remat recompute (save attention outputs) or drop "
                    "capacity-factor padding")
        return ("compute-bound near useful peak: only larger per-chip batch "
                "or quantized matmuls move it")
    if d == "memory":
        return ("HBM-bound: raise arithmetic intensity — larger microbatch, "
                "fuse norms/rope into matmuls, keep weights resident "
                "(already FSDP-gathered per layer)")
    return ("collective-bound: overlap all-gather/reduce-scatter with "
            "compute (async collectives), shrink gradient wire bytes "
            "(int8 compression on the pod axis), or re-balance the mesh "
            "toward fewer model-parallel ways")


def to_markdown(rows: List[Dict], skips: List[Dict]) -> str:
    out = ["| arch | shape | mesh | compute ms | memory ms | collective ms |"
           " dominant | useful FLOP frac | roofline frac | peak GiB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_ms']:.2f} | {r['memory_ms']:.2f} "
            f"| {r['collective_ms']:.2f} | **{r['dominant']}** "
            f"| {r['useful_flops_frac']:.2f} | {r['roofline_frac']:.3f} "
            f"| {r['peak_gib']} |")
    if skips:
        out.append("")
        out.append("Skipped cells (noted in DESIGN.md §5):")
        for s in skips:
            out.append(f"* {s['arch']} x {s['shape']} x {s['mesh']} — "
                       f"{s.get('reason', '')}")
    return "\n".join(out)


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


def analytic_report_rows(rows: List[Dict], chip: ChipSpec
                         ) -> List[Dict[str, Any]]:
    """Analytic cells as shared-schema rows (datasheet bandwidth)."""
    return [{
        "source": "analytic",
        "cell": f"{r['arch']}/{r['shape']}/{r['mesh']}",
        "bw_gbps": chip.hbm_bandwidth / 1e9,
        "knee_ai": chip.ridge_intensity,
        "frac_of_nominal": r["roofline_frac"],
        "bound": r["dominant"],
    } for r in rows]


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
    ap.add_argument("--in-dir", default="experiments/dryrun")
    ap.add_argument("--out", default=None)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--chip", default=DEFAULT_CHIP,
                    help="chip registry name for compute peaks")
    ap.add_argument("--measured", action="store_true",
                    help="measure the empirical envelope instead of "
                         "analyzing dry-run artifacts")
    ap.add_argument("--spec", default="hbm",
                    help="memory spec for --measured")
    ap.add_argument("--backend", default="sim",
                    help="measurement backend for --measured")
    ap.add_argument("--quick", action="store_true",
                    help="quick sweep overlay for --measured")
    args = ap.parse_args(argv)
    chip = chip_by_name(args.chip)

    if args.measured:
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
        return

    recs = load_records(args.in_dir)
    rows = [a for a in (analyze_cell(r, chip) for r in recs) if a]
    skips = [r for r in recs if r.get("status") == "SKIP"]
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    md = to_markdown(rows, skips)
    print(md)
    if rows:
        print()
        print(report_markdown(analytic_report_rows(rows, chip)))
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    # Advice lines for the three hillclimb candidates.
    ok_rows = [r for r in rows if r["mesh"] == "16x16"]
    if ok_rows:
        worst = min(ok_rows, key=lambda r: r["roofline_frac"])
        coll = max(ok_rows, key=lambda r: r["collective_ms"])
        print("\nWorst roofline fraction:",
              worst["arch"], worst["shape"], "->", advise(worst))
        print("Most collective-bound:",
              coll["arch"], coll["shape"], "->", advise(coll))


if __name__ == "__main__":
    main()
