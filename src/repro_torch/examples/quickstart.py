"""Quickstart: the paper's tool + the framework around it, in 60 seconds.

1. Benchmark the (simulated) U280 HBM with Shuhai — reproduces Table IV/V.
2. Run the RST read engine: the hand-written CUDA kernel on the card, its
   plain PyTorch version on the CPU.
3. Let the memory oracle pick a KV-cache layout (the technique acting as a
   framework feature).
4. Forward of an assigned architecture (smoke size) on the device.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(without --device it runs on the CUDA card and fails where there is none).
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import (HBM, AccessPattern, MemoryOracle, RSTParams,
                              ShuhaiCampaign, choose_layout)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import init_params
from repro_torch.models.registry import build


def main(argv=None):
    """Runs the four sections; returns step 2's `BandwidthSample`."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("=== 1. Shuhai on the simulated U280 ===")
    camp = ShuhaiCampaign(HBM)
    lat = camp.suite_idle_latency()
    print(f"HBM idle latency: hit={lat['page_hit']['ns']:.1f}ns "
          f"closed={lat['page_closed']['ns']:.1f}ns "
          f"miss={lat['page_miss']['ns']:.1f}ns   (paper: 106.7/122.2/137.8)")
    tot = camp.suite_total_throughput()
    print(f"Aggregate HBM throughput: {tot['total_gbps']:.0f} GB/s over "
          f"{tot['num_channels']} channels   (paper: 425 GB/s)")

    engine = "CUDA kernel" if device.type == "cuda" else "plain PyTorch"
    print(f"\n=== 2. RST read engine ({engine} on {device.type}) ===")
    tile = ops.tile_bytes(torch.float32)
    p = RSTParams(n=64, b=tile, s=tile, w=64 * tile)
    sample = ops.measure_read_bandwidth(p, device=device)
    print(f"sequential traversal: {sample.bytes_moved} bytes read, "
          f"checksum[0,0]={float(sample.checksum[0, 0]):.3f}")

    print("\n=== 3. Memory-oracle-driven layout choice ===")
    oracle = MemoryOracle()
    eff = oracle.efficiency(AccessPattern(4096, 4096, 1 << 28))
    print(f"contiguous-read efficiency on HBM: {eff:.1%} of wire rate")
    layout = choose_layout(oracle,
                           {"seq": 32768, "kv_heads": 8, "head_dim": 128},
                           itemsize=2, iterate_dim="seq",
                           fetch_dims=("kv_heads", "head_dim"))
    print(f"best KV-cache layout for decode: {layout.dims}")

    print("\n=== 4. One assigned architecture, forward + shapes ===")
    cfg = get_config("gemma3-1b", smoke=True)
    model = build(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, model.param_specs(), device=device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                           device=device)
    logits, _ = model.forward(params, {"tokens": tokens})
    print(f"{cfg.name}: logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits).all())} on {device.type}")
    print("\nquickstart OK")
    return sample


if __name__ == "__main__":
    main()
