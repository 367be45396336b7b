"""End-to-end training example: any decoder-only arch, with checkpoints and
the fault-tolerant loop (simulated failures demonstrate checkpoint/restart).

Defaults are CPU-friendly (smoke config, 40 steps).  Example:

  PYTHONPATH=src python -m repro_torch.examples.train_lm --arch gemma3-1b \
      --steps 60 --with-failure --device cpu

(without --device it runs on the CUDA card and fails where there is none).
"""
import argparse
import tempfile

import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataLoader
from repro_torch.device import resolve_device
from repro_torch.launch.train import init_state, make_train_step
from repro_torch.models.common import tree_map
from repro_torch.models.registry import build
from repro_torch.runtime import FaultTolerantLoop, SimulatedHealth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--with-failure", action="store_true",
                    help="inject a failure mid-run to exercise restart")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    model = build(cfg)
    if cfg.is_encdec:
        raise SystemExit("pick a decoder-only arch for this example")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    ck = Checkpointer(ckpt_dir, keep=2)

    state = init_state(model, cfg, device=device)
    step_fn = make_train_step(model, cfg, None, optim.AdamWConfig(),
                              lr_schedule=lambda s: 1.0)
    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq_len,
                                 global_batch=args.global_batch))
    health = SimulatedHealth(num_nodes=128)
    box = {"state": state, "resume": 0}
    fail_at = {args.steps // 2} if args.with_failure else set()

    def run_step(step):
        if step in fail_at:
            fail_at.discard(step)
            health.kill(7)
            raise RuntimeError("injected node failure")
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        box["state"], metrics = step_fn(box["state"], batch)
        loss = float(metrics["loss"])
        if step % 10 == 0:
            print(f"step {step:4d} loss {loss:.4f}")
        return {"loss": loss}

    def save(step):
        ck.save(step, box["state"])
        box["resume"] = step + 1

    def restore():
        ck.wait()
        latest = ck.latest_step()
        if latest is not None:
            tmpl = tree_map(lambda x: torch.empty_like(x, device="meta"),
                            box["state"])
            box["state"] = ck.restore(tmpl, device=device)
            print(f"restored checkpoint @ step {latest}")
            return latest + 1
        return 0

    loop = FaultTolerantLoop(step_fn=run_step, save_fn=save,
                             restore_fn=restore, health=health,
                             checkpoint_every=10)
    out = loop.run(0, args.steps)
    ck.wait()
    losses = [h["loss"] for h in out["history"]]
    print(f"\ndone: {out['steps']} steps, {out['failures']} failures, "
          f"remesh={out['remesh_events']} on {device.type}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if losses[-1] < losses[0] else 'check config'})")
    print(f"checkpoints in {ckpt_dir}: steps {ck.all_steps()}")


if __name__ == "__main__":
    main()
