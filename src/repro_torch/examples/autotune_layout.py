"""Address-mapping-style layout tuning for accelerator arrays — the
paper's §V-C workflow ("choose the right mapping policy") applied to a KV
cache, a gradient-checkpoint buffer and MoE expert weights, scored by the
Shuhai-calibrated model (`MemoryOracle`, modeled: no device runs).

Run: PYTHONPATH=src python -m repro_torch.examples.autotune_layout
"""
from repro_torch.core import MemoryOracle, score_layouts


def show(title, scored, top=4):
    print(f"\n{title}")
    for bw, cand in scored[:top]:
        print(f"  {bw / 1e9:8.1f} GB/s   {' x '.join(cand.dims)}")
    best, worst = scored[0][0], scored[-1][0]
    print(f"  -> best/worst ratio: {best / max(worst, 1):.1f}x "
          f"(paper Fig. 6 shows ~10x between mapping policies)")


def main():
    oracle = MemoryOracle()

    # 1. Decode-time KV cache: iterate seq, fetch (kv_heads, head_dim).
    show("KV cache (decode sweeps seq):",
         score_layouts(oracle, {"seq": 32768, "kv_heads": 8, "head_dim": 128},
                       itemsize=2, iterate_dim="seq",
                       fetch_dims=("kv_heads", "head_dim")))

    # 2. Remat-saved activations: backward iterates layers, fetches
    #    (batch, seq, embed) per step.
    show("Saved activations (backward sweeps layers):",
         score_layouts(oracle, {"layers": 88, "batch": 1, "seq": 256,
                                "embed": 12288},
                       itemsize=2, iterate_dim="layers",
                       fetch_dims=("batch", "seq", "embed")))

    # 3. MoE expert weights: iterate experts, fetch (d_model, d_ff) matrices.
    show("Expert weights (dispatch sweeps experts):",
         score_layouts(oracle, {"experts": 64, "d_model": 2048, "d_ff": 1408},
                       itemsize=2, iterate_dim="experts",
                       fetch_dims=("d_model", "d_ff")))


if __name__ == "__main__":
    main()
