"""The port's partitioned dry run against the reference's compiled
production cells.

The reference's dry run compiles gemma3-1b decode_32k and prefill_32k
and mistral-large-123b decode_32k on the 16 x 16 mesh (`repro.launch.
dryrun.lower_cell`, 512 placeholder CPU devices, in a subprocess); the
port traces the same cells as rank 0 of that mesh (`repro_torch.launch.
dryrun.lower_cell`).  Held:

* argument bytes: XLA's are the port's + 4 B, and so are its aliased
  (donated) bytes: the reference's cache carries an int32 `index`
  cursor, which the port's keeps as a Python int (`launch/serve.py`
  `cache_shardings`); the prefill's, less the cache it overwrites
  without reading, which jit drops;
* the port's traced all-gather bytes (`collectives_traced`) and its
  analytic ones (`collectives`, from the placements) within
  GATHER_BAND of XLA's (`hlo_analysis.collective_bytes` over the
  compiled HLO) for the decode cells, the prefill's traced all-gather
  at most GATHER_BAND's upper end (it moves about half of XLA's: the
  row-parallel outputs are all-reduced once before the sandwich norm,
  where XLA all-reduces them too, and XLA gathers more weights), its
  all-reduce printed beside XLA's.  gemma3's layers are unscanned and
  its steps have no loop, so its HLO holds every layer: compared whole.
  mistral's 88 layers are one `while` body in the HLO, held once: the
  port's figure is divided by its 88 layers;
* the per-device peaks, printed beside each other and held in the bands
  PEAK_BAND measured here (XLA's mistral peak holds float32 copies of
  the whole stacked bf16 cache, which the port writes in place).

gemma3-1b train_4k takes about two minutes to compile, too long for this
tier; the loss and training collectives are held on the mini cells
(tests/test_torch_dryrun.py).

The families whose partitioned trace once failed (whisper's 1500 frames,
rwkv6's views of a split d_model, the MoE dispatch's split groups) are
held at one production cell each (REPAIRED, each compiles in seconds):
argument and aliased bytes exactly as the two programs hold them (XLA's
+ 4 B of `index`, less what the step never reads, which jit drops), and
the peak in REPAIRED_PEAK_BAND measured here.  Their traced all-gathers
are printed beside XLA's, and held at most GATHER_BAND's upper end (the
limit chip_smoke.py's phase 11e holds on the card) where the batched
products keep batch and heads split: whisper's and qwen2-moe's, and
rwkv6-7b long_500k's, whose one-token step keeps its FSDP weights split
(`models.common.project`, `take_rows`); the mini cells hold what the
families move at mini size.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES
from test_torch_dryrun import unread_bytes

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
CELLS = (("gemma3-1b", "decode_32k"), ("mistral-large-123b", "decode_32k"),
         ("gemma3-1b", "prefill_32k"))
INDEX_BYTES = 4
# Port over XLA, measured first (PERF.md §6; jax 0.9.0, torch
# 2.13 on the CPU): traced all-gather 0.957 gemma3, 0.906 mistral per
# layer; analytic 0.963 and 0.915.  Before the split cache was gathered
# once a layer they were 14.1 and 13.3 (traced).  Since the one-token
# step's embedding keeps its split columns (`take_rows`), gemma3's
# traced 0.933.  gemma3's prefill, traced 0.566 (was 7.81, when the
# sandwich norm's partial sum was reduced twice and gathered).
GATHER_BAND = (0.8, 1.25)
# Peak over XLA's, measured first: gemma3 decode 0.886, mistral 0.405,
# gemma3 prefill 0.675.
PEAK_BAND = {("gemma3-1b", "decode_32k"): (0.8, 1.0),
             ("mistral-large-123b", "decode_32k"): (0.36, 0.45),
             ("gemma3-1b", "prefill_32k"): (0.6, 0.75)}

REPAIRED = (("whisper-small", "decode_32k"), ("rwkv6-7b", "long_500k"),
            ("qwen2-moe-a2.7b", "train_4k"))
# Peak over XLA's, measured first (torch 2.13 on the CPU): whisper 0.319
# (XLA keeps float32 copies of the cross-attention cache), rwkv6 0.503,
# qwen2-moe 0.684.  Before the batched products kept batch and heads
# split (`models.common.contract`), rwkv6's was 2.755 (its WKV products
# gathered the heads) and qwen2-moe's 1.911, in bands (2.4, 3.1) and
# (1.7, 2.15); rwkv6's then 0.899 in (0.8, 1.0), until its one-token
# step kept its FSDP weights split (`models.common.project`; XLA's peak
# holds temporaries the port's does not make).
REPAIRED_PEAK_BAND = {"whisper-small": (0.28, 0.36),
                      "rwkv6-7b": (0.45, 0.56),
                      "qwen2-moe-a2.7b": (0.6, 0.78)}
# The cells whose traced all-gather is held at most GATHER_BAND[1] x
# XLA's, measured first: whisper 0.106 a layer, qwen2-moe 0.334 a layer
# of a microbatch, rwkv6 0.141 a layer (were 0.142, 0.337 and 10.83:
# rwkv6's batch of one gathered each layer's FSDP weights, its embedding
# and unembedding).
GATHER_HELD = ("whisper-small", "qwen2-moe-a2.7b", "rwkv6-7b")

REF = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch.dryrun import lower_cell
    print(json.dumps({{f"{{a}}|{{s}}": lower_cell(a, s, False)
                      for a, s in {cells!r}}}))
""")


def _both(cells):
    """The reference's records of `cells` (compiled in a child with 512
    placeholder devices) and the port's, keyed "arch|shape"."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REF.format(cells=cells)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    port = {f"{a}|{s}": dryrun.lower_cell(a, s, False) for a, s in cells}
    return port, ref


@pytest.fixture(scope="module")
def records():
    return _both(CELLS)


@pytest.fixture(scope="module")
def repaired_records():
    return _both(REPAIRED)


def _peak(mem):
    return (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_production_cell_against_xla(arch, shape, records):
    port, ref = records
    rec, xla = port[f"{arch}|{shape}"], ref[f"{arch}|{shape}"]
    assert rec["status"] == xla["status"] == "OK" and rec["partitioned"]
    mem, x = rec["memory"], xla["memory"]
    cfg, spec = get_config(arch), SHAPES[shape]
    args_unread, alias_unread = unread_bytes(
        cfg, spec, make_production_mesh(multi_pod=False))
    assert x["argument_bytes"] - mem["argument_bytes"] + args_unread == \
        INDEX_BYTES
    assert x["alias_bytes"] - mem["alias_bytes"] + alias_unread == \
        INDEX_BYTES
    layers = cfg.num_layers if cfg.scan_layers else 1
    want = xla["collectives"]["all-gather"]
    traced = rec["collectives_traced"]["all-gather"] / layers
    analytic = rec["collectives"]["all-gather"] / layers
    reduced = rec["collectives_traced"].get("all-reduce", 0.0) / layers
    ref_reduced = xla["collectives"].get("all-reduce", 0.0)
    peak, ref_peak = _peak(mem), _peak(x)
    print(f"{arch} {shape} ({rec['trace_mode']} trace): all-gather per "
          f"{'layer' if layers > 1 else 'step'} traced {traced:.0f} B, "
          f"analytic {analytic:.0f} B, XLA's {want:.0f} B (ratios "
          f"{traced / want:.3f}, {analytic / want:.3f}); all-reduce traced "
          f"{reduced:.0f} B, XLA's {ref_reduced:.0f} B; peak "
          f"{peak / 2**30:.3f} GiB, XLA's {ref_peak / 2**30:.3f} GiB "
          f"(ratio {peak / ref_peak:.3f}); argument bytes "
          f"{mem['argument_bytes']}, XLA's {x['argument_bytes']}")
    if spec.kind == "decode":
        assert GATHER_BAND[0] <= traced / want <= GATHER_BAND[1]
        assert GATHER_BAND[0] <= analytic / want <= GATHER_BAND[1]
    else:
        assert traced / want <= GATHER_BAND[1]
    lo, hi = PEAK_BAND[arch, shape]
    assert lo <= peak / ref_peak <= hi


@pytest.mark.parametrize("arch,shape", REPAIRED)
def test_repaired_cell_against_xla(arch, shape, repaired_records):
    port, ref = repaired_records
    rec, xla = port[f"{arch}|{shape}"], ref[f"{arch}|{shape}"]
    assert rec["status"] == xla["status"] == "OK" and rec["partitioned"]
    assert rec["trace_scope"] == "device"
    mem, x = rec["memory"], xla["memory"]
    cfg, spec = get_config(arch), SHAPES[shape]
    if spec.kind == "train":
        assert (x["argument_bytes"], x["alias_bytes"]) == \
            (mem["argument_bytes"], mem["alias_bytes"])
    else:
        args_unread, alias_unread = unread_bytes(
            cfg, spec, make_production_mesh(multi_pod=False))
        assert (x["argument_bytes"], x["alias_bytes"]) == (
            mem["argument_bytes"] - args_unread + INDEX_BYTES,
            mem["alias_bytes"] - alias_unread + INDEX_BYTES)
    peak, ref_peak = _peak(mem), _peak(x)
    scanned = cfg.scan_layers and not cfg.moe_dense_layers
    per = (rec.get("n_micro", 1) if spec.kind == "train" else 1) * \
        (cfg.num_layers if scanned else 1)
    traced = rec["collectives_traced"].get("all-gather", 0.0) / per
    want = xla["collectives"]["all-gather"]
    unit = "layer of a microbatch" if spec.kind == "train" else "layer"
    print(f"{arch} {shape}: peak {peak / 2**30:.3f} GiB, XLA's "
          f"{ref_peak / 2**30:.3f} GiB (ratio {peak / ref_peak:.3f}); "
          f"traced all-gather {traced:.0f} B a {unit}, XLA's {want:.0f} B "
          f"(ratio {traced / want:.3f}); argument bytes "
          f"{mem['argument_bytes']}, XLA's {x['argument_bytes']}")
    lo, hi = REPAIRED_PEAK_BAND[arch]
    assert lo <= peak / ref_peak <= hi
    if arch in GATHER_HELD:
        assert traced / want <= GATHER_BAND[1]


def main(argv=None):
    """`python tests/test_torch_dryrun_ref.py ARCH SHAPE [N] [PATTERN]`:
    the reference's compiled cell on 16x16 (`lower_cell`'s program):
    its memory, its N largest collectives grouped by kind, result shape
    and op name, and how many HLO instructions have a result matching
    the regex PATTERN (e.g. 'f32\\[88,'), by opcode."""
    import argparse
    import collections
    import re

    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("n", nargs="?", type=int, default=12)
    ap.add_argument("pattern", nargs="?")
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch import dryrun as ref_dryrun
    from repro.launch.hlo_analysis import _OP_RE, _shape_bytes

    compiled = []
    real = ref_dryrun.collective_bytes

    def keep(hlo):
        compiled.append(hlo)
        return real(hlo)

    ref_dryrun.collective_bytes = keep
    rec = ref_dryrun.lower_cell(args.arch, args.shape, False)
    print(json.dumps({k: rec[k] for k in ("memory", "collectives")}))
    groups = collections.Counter()
    sizes = {}
    for line in compiled[0].splitlines():
        m = None if "-done(" in line else _OP_RE.search(line)
        if m:
            name = re.search(r'op_name="([^"]*)"', line)
            key = (m.group("op"), re.sub(r"\{[^}]*\}", "", m.group("shapes")),
                   name.group(1) if name else "")
            groups[key] += 1
            sizes[key] = _shape_bytes(m.group("shapes"))
    for key, n in sorted(groups.items(),
                         key=lambda kv: -kv[1] * sizes[kv[0]])[:args.n]:
        print(f"{n * sizes[key]:>16,d} B  {n:4d} x {key[0]} {key[1][:60]}"
              f"  {key[2][-60:]}")
    if args.pattern:
        found = collections.Counter(
            m.group(1) for m in re.finditer(
                r"= (?:" + args.pattern + r")[^ ]* ([a-z-]+)\(",
                compiled[0]))
        print(f"results matching {args.pattern!r}: {dict(found)}")


if __name__ == "__main__":
    main()
