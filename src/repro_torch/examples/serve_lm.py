"""Serve a small model with batched requests through the continuous-
batching engine (iteration-level batching, fixed shapes, slot reuse).

Run: PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
(without --device it runs on the CUDA card and fails where there is none).
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.common import init_params
from repro_torch.models.registry import build
from repro_torch.serving import ContinuousBatchingEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    model = build(cfg)
    if cfg.is_encdec:
        raise SystemExit("decoder-only archs only in this example")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, model.param_specs(), dtype=torch.float32,
                         device=device)
    eng = ContinuousBatchingEngine(model, params, slots=args.slots,
                                   max_seq=128, eos_id=-1, device=device)
    print(f"engine: {args.slots} slots, kv layout "
          f"{'/'.join(eng.kv_layout.dims)} (oracle-chosen)")

    reqs = []
    for i in range(args.requests):
        prompt = [(7 * i + j) % (cfg.vocab_size - 1) + 1
                  for j in range(3 + i % 5)]
        r = Request(rid=i, prompt=prompt, max_new_tokens=args.max_new)
        reqs.append(r)
        eng.submit(r)

    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    dt = time.perf_counter() - t0
    print(f"completed {stats.completed}/{args.requests} requests in "
          f"{stats.engine_steps} engine steps ({dt:.1f}s)")
    print(f"tokens: prefill={stats.prefill_tokens} "
          f"decode={stats.decode_tokens} "
          f"({stats.decode_tokens / dt:.1f} tok/s on {device.type})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={r.prompt} -> {r.generated}")


if __name__ == "__main__":
    main()
