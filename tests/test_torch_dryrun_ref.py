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
held at one production cell each, and deepseek-v2-lite's prefill and
decode, whose latent cache is split on slots (REPAIRED, each compiles in
seconds):
argument and aliased bytes exactly as the two programs hold them (XLA's
+ 4 B of `index`, less what the step never reads, which jit drops), and
the peak in REPAIRED_PEAK_BAND measured here.  Their traced all-gathers
are printed beside XLA's, and held at most GATHER_BAND's upper end (the
limit chip_smoke.py's phase 11e holds on the card) where the batched
products keep batch and heads split: whisper's and qwen2-moe's, and
rwkv6-7b long_500k's, whose one-token step keeps its FSDP weights split
(`models.common.project`, `take_rows`), and deepseek's prefill, whose
mask each rank makes for its rows.  deepseek's and rwkv6-7b
long_500k's are held on whole steps against XLA's collectives as its
step runs them (STEP_HELD, `executed_collectives`: deepseek's HLO holds
an unscanned layer beside the scanned body, and loops inside a layer;
rwkv6's gathers its layers' shift states outside its loop).  deepseek's decode gathers its
latent cache where XLA moves float32 keys and values by all-to-all: its
all-gather alone is held in a band measured here, and with its
all-to-all at most GATHER_BAND's upper end (GATHER_ALONE_BAND).  The
GQA cells whose heads the model axis cut across KV groups or left whole
on every rank (mistral-large-123b's and nemotron-4-15b's prefill and
train steps, starcoder2-7b's and qwen2-vl-7b's train steps), and
hymba-1.5b's decode, whose FSDP weights the one-token step gathered
where XLA moves their split to the model axis, are REPAIRED cells too:
their peaks in bands measured here, their all-gathers at most
GATHER_BAND's upper end (the prefills on whole steps, STEP_HELD).
hymba-1.5b's prefill and train steps are held at 4 layers (HYMBA), in
a fixture and a reference child of their own, on whole steps, their
scans counted by trip count with no collective in a trip; the train
step's embedding gradient is reduce-scattered as a partial sum, no
gradient row gathered (`dryrun.sites()`).  The mini cells hold what the
families move at mini size.

`python tests/test_torch_dryrun_ref.py --all` compares every runnable
16x16 cell (ALL_LEFT_OUT is empty) outside this tier (`compare_all`);
`--port-only` traces the port alone, with no jax (`trace_port`), and
`--diff` sets two such traces (two torches') side by side.
"""
import collections
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from repro.launch.hlo_analysis import _OP_RE, _shape_bytes
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
CELLS = (("gemma3-1b", "decode_32k"), ("mistral-large-123b", "decode_32k"),
         ("gemma3-1b", "prefill_32k"))
INDEX_BYTES = 4
# `--port-only --diff`: two traces of a cell agree where each figure is
# within this share of the other's (chip_smoke.py's HOST_AGREE).
HOST_AGREE = 0.01


def unread_bytes(cfg, shape, mesh):
    """`test_torch_dryrun.unread_bytes`, imported at the first call:
    that module imports the reference's jax modules, which `main
    --port-only` runs without."""
    from test_torch_dryrun import unread_bytes as unread
    return unread(cfg, shape, mesh)
# Port over XLA, measured first (PERF.md §6; jax 0.9.0, torch
# 2.13 on the CPU): traced all-gather 0.957 gemma3, 0.906 mistral per
# layer; analytic 0.963 and 0.915.  Before the split cache was gathered
# once a layer they were 14.1 and 13.3 (traced).  Since the one-token
# step's embedding keeps its split columns (`take_rows`), gemma3's
# traced 0.933.  gemma3's prefill, traced 0.566 (was 7.81, when the
# sandwich norm's partial sum was reduced twice and gathered).
GATHER_BAND = (0.8, 1.25)
# Peak over XLA's, measured first: gemma3 decode 0.886, mistral 0.405,
# gemma3 prefill 0.675 (band (0.6, 0.75)); since a prefill with sharding
# rules unembeds only its last position (`TransformerLM.prefill`),
# gemma3's prefill 0.481.
PEAK_BAND = {("gemma3-1b", "decode_32k"): (0.8, 1.0),
             ("mistral-large-123b", "decode_32k"): (0.36, 0.45),
             ("gemma3-1b", "prefill_32k"): (0.43, 0.53)}

REPAIRED = (("whisper-small", "decode_32k"), ("rwkv6-7b", "long_500k"),
            ("qwen2-moe-a2.7b", "train_4k"),
            ("deepseek-v2-lite-16b", "prefill_32k"),
            ("deepseek-v2-lite-16b", "decode_32k"),
            ("mistral-large-123b", "prefill_32k"),
            ("nemotron-4-15b", "prefill_32k"), ("hymba-1.5b", "decode_32k"),
            ("starcoder2-7b", "train_4k"), ("qwen2-vl-7b", "train_4k"),
            ("mistral-large-123b", "train_4k"),
            ("nemotron-4-15b", "train_4k"))
# Peak over XLA's, measured first (torch 2.13 on the CPU): whisper 0.319
# (XLA keeps float32 copies of the cross-attention cache), rwkv6 0.503,
# qwen2-moe 0.684 (0.641 since the routing's dispatch and combine are
# made in bf16, each where it is used).  deepseek-v2-lite's prefill
# 0.770, its decode 0.391: the prefill was 1.552 while the routing held
# its float32 dispatch and combine beside their bf16 copies, and the
# dispatch, the experts' input and the combine all at once (now made in
# bf16 from their factors, `models.moe.route_factors`, and freed in
# turn); its decode, 0.391 before too.  Before the batched products kept batch and heads
# split (`models.common.contract`), rwkv6's was 2.755 (its WKV products
# gathered the heads) and qwen2-moe's 1.911, in bands (2.4, 3.1) and
# (1.7, 2.15); rwkv6's then 0.899 in (0.8, 1.0), until its one-token
# step kept its FSDP weights split (`models.common.project`; XLA's peak
# holds temporaries the port's does not make); still 0.503 once its
# products' partial sums were all-reduced at once.
# GQA attention whose heads the model axis cut across KV groups, or left
# whole on every rank, scored every head on every rank: peaks of 1.15-3.41
# x XLA's (mistral-large-123b prefill 1.406, train 2.498; nemotron-4-15b
# prefill 1.154, train 1.386; starcoder2-7b train 3.410; qwen2-vl-7b
# train 3.333).  Each rank now attends its rows of queries over every
# head (`models.attention._attention_split_rows`) and each layer's weight
# gradients take their weights' split as they are made
# (`models.common.placed_grads`), measured first: 0.641, 0.843; 0.826,
# 0.231; 0.606; 0.612; hymba-1.5b's decode 0.271 (0.360 before its
# products with weights larger than them moved the weights' split to the
# model axis, `models.common.project`).
REPAIRED_PEAK_BAND = {"whisper-small": (0.28, 0.36),
                      "rwkv6-7b": (0.45, 0.56),
                      "qwen2-moe-a2.7b": (0.6, 0.78),
                      ("deepseek-v2-lite-16b", "prefill_32k"): (0.7, 0.85),
                      ("deepseek-v2-lite-16b", "decode_32k"): (0.35, 0.45),
                      ("mistral-large-123b", "prefill_32k"): (0.58, 0.71),
                      ("mistral-large-123b", "train_4k"): (0.76, 0.93),
                      ("nemotron-4-15b", "prefill_32k"): (0.74, 0.91),
                      ("nemotron-4-15b", "train_4k"): (0.21, 0.26),
                      "hymba-1.5b": (0.24, 0.30),
                      ("hymba-1.5b", "prefill_32k"): (0.65, 0.80),
                      ("hymba-1.5b", "train_4k"): (0.77, 0.94),
                      "starcoder2-7b": (0.55, 0.67),
                      "qwen2-vl-7b": (0.55, 0.68)}
# The cells whose traced all-gather is held at most GATHER_BAND[1] x
# XLA's, measured first: whisper 0.106 a layer, qwen2-moe 0.334 a layer
# of a microbatch, rwkv6 0.141 a layer (were 0.142, 0.337 and 10.83:
# rwkv6's batch of one gathered each layer's FSDP weights, its embedding
# and unembedding; its 0.141 a layer against XLA's HLO counted once was
# 2.371 x XLA's step as it runs, 3,768,320 B, its products' partial sums
# scattered on the batch of one by the next elementwise op and gathered
# back; all-reduced at once since, `models.common.project`: 0.335 a
# step, 532,480 B), deepseek-v2-lite's prefill 0.158 a step (was 2.414:
# each layer gathered its boolean (B, S, Skv) mask over the cache's
# slots, which each rank now makes from the positions).
# The GQA cells above were 0.30-0.69 x XLA's (their train steps a
# step), nemotron-4-15b's prefill 1.84 (its queries' heads gathered for
# each query chunk, its attention's output reduced, then gathered on
# d_model) and hymba-1.5b's decode 1.50 (q, k, v and the unembedding
# gathered over the data axis where XLA permutes them onto the model
# axis), measured first now: mistral's prefill 0.447 a step, nemotron's
# 0.088, hymba's decode 0.340.
GATHER_HELD = ("whisper-small", "qwen2-moe-a2.7b", "rwkv6-7b",
               "deepseek-v2-lite-16b", "mistral-large-123b",
               "nemotron-4-15b", "hymba-1.5b", "starcoder2-7b",
               "qwen2-vl-7b")
# The archs held on whole steps, against XLA's collectives as its step
# runs them (`executed_collectives`): deepseek-v2-lite's HLO holds its
# unscanned dense layer 0 beside the scanned body of its 26 MoE layers,
# and its attention's loop over 8 key chunks, which all-to-alls each
# chunk, so no count of layers divides its figure; the GQA prefills'
# loop over 8 query chunks inside the scanned layer likewise; and
# rwkv6-7b's one-token step, whose HLO gathers the 32 layers' shift
# states outside its loop (1 MB of XLA's 1,589,248 B a step).
STEP_HELD = ("deepseek-v2-lite-16b", ("mistral-large-123b", "prefill_32k"),
             ("nemotron-4-15b", "prefill_32k"), ("rwkv6-7b", "long_500k"),
             ("hymba-1.5b", "prefill_32k"), ("hymba-1.5b", "train_4k"))
# The cells whose all-gather alone is held in a band measured here, and
# their all-gather and all-to-all together at most GATHER_BAND[1] x
# XLA's: deepseek-v2-lite's decode gathers its bf16 latent cache over
# the slots (`models.attention._latent_attention_split`), 302 MB a
# layer, where XLA expands each device's slots and moves the float32
# keys and values to the heads by all-to-all, 336 MB a layer, beside
# 18.6 MB of all-gather.  Measured: all-gather 16.62 x XLA's, the two
# together 0.871 x.
GATHER_ALONE_BAND = {("deepseek-v2-lite-16b", "decode_32k"): (16.0, 17.3)}

_HEAD = re.compile(r"^(?:ENTRY )?%(?P<name>[\w.\-]+) .*\{$")
_CALLS = re.compile(r"(?:body|condition|to_apply|calls)=%(?P<one>[\w.\-]+)"
                    r"|(?:branch|called)_computations=\{(?P<many>[^}]*)\}")
_TRIPS = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')


def executed_collectives(hlo):
    """Each collective kind's result bytes as XLA's step runs them: each
    instruction's bytes (as `hlo_analysis.collective_bytes` counts them
    once) times the runs of its computation, a `while` body running
    its loop's `known_trip_count` times for each run of its caller."""
    comps, entry, lines = {}, None, None
    for line in hlo.splitlines():
        head = _HEAD.match(line)
        if head:
            lines = comps.setdefault(head.group("name"), [])
            entry = head.group("name") if line.startswith("ENTRY") else entry
        elif lines is not None:
            lines.append(line)
    runs = collections.Counter()

    def run(name, n):
        runs[name] += n
        for line in comps[name]:
            trips = _TRIPS.search(line) if " while(" in line else None
            for m in _CALLS.finditer(line):
                for callee in re.findall(r"[\w.\-]+",
                                         m.group("one") or m.group("many")):
                    if callee in comps:
                        loop = trips and m.group(0).startswith("body=")
                        run(callee, n * (int(trips.group(1)) if loop else 1))

    run(entry, 1)
    moved = collections.Counter()
    for name, n in runs.items():
        for line in comps[name]:
            op = None if "-done(" in line else _OP_RE.search(line)
            if op:
                moved[op.group("op")] += n * _shape_bytes(op.group("shapes"))
    return dict(moved)


REF = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch import dryrun
    hlo, count = [], dryrun.collective_bytes
    dryrun.collective_bytes = lambda text: hlo.append(text) or count(text)
    print(json.dumps({{f"{{a}}|{{s}}": dict(
        dryrun.lower_cell(a, s, {multi_pod}), hlo=hlo.pop())
        for a, s in {cells!r}}}))
""")


def _child_json(code, timeout):
    """The last line a child running `code` prints, as JSON, or what
    stopped it: "timeout after N s", or the tail of its output."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    try:
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"timeout after {timeout} s"
    if proc.returncode:
        return proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _both(cells, multi_pod=False):
    """The reference's records of `cells` on the 16x16 mesh, or with
    `multi_pod` the 2x16x16 one (compiled in a child with 512
    placeholder devices, started first, each with its compiled HLO
    under "hlo") and the port's, traced meanwhile; keyed "arch|shape"."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        child = pool.submit(_child_json, REF.format(
            cells=cells, multi_pod=multi_pod), 600)
        port = {f"{a}|{s}": dryrun.lower_cell(a, s, multi_pod)
                for a, s in cells}
        ref = child.result()
    assert isinstance(ref, dict), ref
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
    _held_against_xla(arch, shape, port[f"{arch}|{shape}"],
                      ref[f"{arch}|{shape}"], get_config(arch))


def _held_against_xla(arch, shape, rec, xla, cfg, *,
                      peak_bands=REPAIRED_PEAK_BAND,
                      alone_bands=GATHER_ALONE_BAND, step_held=STEP_HELD,
                      gather_held=GATHER_HELD):
    """`rec`, the port's record of `cfg` at `shape`, against XLA's
    `xla`: argument and alias bytes as the two programs hold them, the
    peak in its band of `peak_bands` (keyed by cell or arch), the
    all-gather as `gather_held`, `step_held` and `alone_bands` hold it
    (by default the 16x16 cells' REPAIRED_PEAK_BAND, GATHER_HELD,
    STEP_HELD and GATHER_ALONE_BAND), and on a cell held a step the
    reductions (all-reduce and reduce-scatter) at most GATHER_BAND[1] x
    XLA's as its step runs them."""
    assert rec["status"] == xla["status"] == "OK" and rec["partitioned"]
    assert rec["trace_scope"] == "device"
    mem, x = rec["memory"], xla["memory"]
    spec = SHAPES[shape]
    if spec.kind == "train":
        assert (x["argument_bytes"], x["alias_bytes"]) == \
            (mem["argument_bytes"], mem["alias_bytes"])
    else:
        args_unread, alias_unread = unread_bytes(
            cfg, spec,
            make_production_mesh(multi_pod=rec["mesh"] == "2x16x16"))
        assert (x["argument_bytes"], x["alias_bytes"]) == (
            mem["argument_bytes"] - args_unread + INDEX_BYTES,
            mem["alias_bytes"] - alias_unread + INDEX_BYTES)
    peak, ref_peak = _peak(mem), _peak(x)
    by_step = arch in step_held or (arch, shape) in step_held
    if by_step:
        per, unit, moved = 1, "step", executed_collectives(xla["hlo"])
    else:
        per = (rec.get("n_micro", 1) if spec.kind == "train" else 1) * \
            (cfg.num_layers if cfg.scan_layers else 1)
        unit = ("layer of a microbatch" if spec.kind == "train" else
                "layer" if cfg.scan_layers else "step")
        moved = xla["collectives"]
    traced = {k: v / per for k, v in rec["collectives_traced"].items()}
    gather, want = traced.get("all-gather", 0.0), moved["all-gather"]
    print(f"{arch} {shape}: peak {peak / 2**30:.3f} GiB, XLA's "
          f"{ref_peak / 2**30:.3f} GiB (ratio {peak / ref_peak:.3f}); "
          f"traced a {unit} (XLA's): all-gather {gather:.0f} B "
          f"({want:.0f} B, ratio {gather / want:.3f}), all-to-all "
          f"{traced.get('all-to-all', 0.0):.0f} B "
          f"({moved.get('all-to-all', 0.0):.0f} B), all-reduce "
          f"{traced.get('all-reduce', 0.0):.0f} B "
          f"({moved.get('all-reduce', 0.0):.0f} B), reduce-scatter "
          f"{traced.get('reduce-scatter', 0.0):.0f} B "
          f"({moved.get('reduce-scatter', 0.0):.0f} B); argument bytes "
          f"{mem['argument_bytes']}, XLA's {x['argument_bytes']}")
    lo, hi = peak_bands.get((arch, shape)) or peak_bands[arch]
    assert lo <= peak / ref_peak <= hi
    if by_step:
        assert sum(traced.get(k, 0.0) for k in REDUCTIONS) <= \
            GATHER_BAND[1] * sum(moved.get(k, 0.0) for k in REDUCTIONS)
    if (arch, shape) in alone_bands:
        lo, hi = alone_bands[arch, shape]
        assert lo <= gather / want <= hi
        kinds = ("all-gather", "all-to-all")
        assert sum(traced.get(k, 0.0) for k in kinds) <= GATHER_BAND[1] * \
            sum(moved.get(k, 0.0) for k in kinds)
    elif arch in gather_held or (arch, shape) in gather_held:
        assert gather / want <= GATHER_BAND[1]


def test_executed_collectives_counts_loop_trips():
    """A collective in a `while` body counts its loop's trips, one in a
    body nested in another their product, and one outside once; the
    `-done` half of an async pair is not counted."""
    hlo = textwrap.dedent("""\
        %inner (p: f32[4]) -> f32[4] {
          %ag.2 = f32[8]{0} all-gather(%p), dimensions={0}
        }
        %outer (p: f32[4]) -> f32[4] {
          %ar.1 = f32[4]{0} all-reduce(%p), to_apply=%add
          %w.1 = f32[4]{0} while(%p), condition=%c, body=%inner, backend_config={"known_trip_count":{"n":"8"}}
        }
        ENTRY %main (p: f32[4]) -> f32[4] {
          %ag.1 = f32[16]{0} all-gather-start(%p), dimensions={0}
          %ag.d = f32[16]{0} all-gather-done(%ag.1)
          %w.0 = f32[4]{0} while(%p), condition=%c, body=%outer, backend_config={"known_trip_count":{"n":"3"}}
        }
        """)
    assert executed_collectives(hlo) == {"all-gather": 64 + 3 * 8 * 32,
                                         "all-reduce": 3 * 16}

# hymba-1.5b's train_4k and prefill_32k, held at a cut depth: 4 layers,
# global 0 and 2 (hymba's widths, both of its layer kinds; the 4-layer
# model has a period, so the port traces it by the shortcut).  At full
# depth the reference compiles them in 660 s and 37 s on an 8-core
# host (jax 0.9.0), and the port traces them in minutes; at this depth
# 32 s and 6 s.  Both sides read `get_config` patched to the cut
# (`_at_depth`), in a child of their own (the reference's) with
# HYMBA_TIMEOUT seconds, so a slow compile fails only these cells.
# Before their Mamba scans' products kept batch and channels split
# (`models.common.contract`) and their prefill unembedded only the last
# position (`TransformerLM.prefill`), they read (port / XLA): prefill
# peak 1.447, all-gather 2.965 a step (32,810 gathers, about four in
# every chunk of every layer); train peak 0.850, all-gather 6.305,
# all-to-all 9.213.  Measured first now: prefill peak 0.721, all-gather
# 0.015; train peak 0.851, all-gather 0.880.
HYMBA = (("hymba-1.5b", "prefill_32k"), ("hymba-1.5b", "train_4k"))
HYMBA_DEPTH = {"num_layers": 4, "global_layers": (0, 2)}
HYMBA_TIMEOUT = 300
AT_DEPTH = textwrap.dedent("""
    import dataclasses
    from repro.launch import dryrun as _cut
    _config = _cut.get_config
    _cut.get_config = lambda arch: dataclasses.replace(
        _config(arch), **{changes!r})
""")


def _at_depth(arch):
    return dataclasses.replace(get_config(arch), **HYMBA_DEPTH)


@pytest.fixture(scope="module")
def hymba_records():
    """The reference's records of HYMBA at HYMBA_DEPTH, compiled in a
    child started first, and the port's, traced meanwhile under
    `dryrun.sites()`, whose entries (one a trace) come third."""
    from concurrent.futures import ThreadPoolExecutor

    code = AT_DEPTH.format(changes=HYMBA_DEPTH) + REF.format(cells=HYMBA, multi_pod=False)
    with ThreadPoolExecutor(1) as pool:
        child = pool.submit(_child_json, code, HYMBA_TIMEOUT)
        with pytest.MonkeyPatch.context() as patch, dryrun.sites() as kept:
            patch.setattr(dryrun, "get_config", _at_depth)
            port = {f"{a}|{s}": dryrun.lower_cell(a, s, False)
                    for a, s in HYMBA}
        ref = child.result()
    assert isinstance(ref, dict), ref
    return port, ref, kept


@pytest.mark.parametrize("arch,shape", HYMBA)
def test_hymba_cell_against_xla(arch, shape, hymba_records):
    """hymba-1.5b at HYMBA_DEPTH: argument and alias bytes, the peak in
    its REPAIRED_PEAK_BAND, the all-gather a step (STEP_HELD) at most
    GATHER_BAND[1] x XLA's as its step runs them; its scans count their
    trips, and no counted trip issues a collective."""
    port, ref, _ = hymba_records
    rec = port[f"{arch}|{shape}"]
    _held_against_xla(arch, shape, rec, ref[f"{arch}|{shape}"],
                      _at_depth(arch))
    assert rec["scan_trips_counted"] > 0
    assert not rec["scan_collectives"]


def test_hymba_embedding_gradient_is_not_gathered(hymba_records):
    """hymba's train step at HYMBA_DEPTH: its embedding table (32001
    rows, which 16 does not divide) is gathered whole, and no all-gather
    comes from the lookup's backward (`IndexBackward0`, DTensor's
    `index_put`, gathered the gradient rows over the data axis: 419,430,400
    B a microbatch): each rank's gradient is a partial sum,
    reduce-scattered onto the table's columns (`models.common.take_rows`)."""
    _, _, kept = hymba_records
    train = [t for t in kept if t["kind"] == "train"]
    assert train
    for t in train:
        gathers = [where for (kind, _, _, where) in t["collectives"]
                   if kind == "all-gather"]
        assert gathers
        assert not [w for w in gathers
                    if "IndexBackward" in w or "index_put" in w.lower()]
        table = [n for (kind, _, shape, where), n in t["collectives"].items()
                 if kind == "reduce-scatter" and shape == (32001, 100)
                 and "Backward" in where]
        assert sum(table) == 1      # once a microbatch, as it was gathered


PORT_ONLY = textwrap.dedent("""
    import runpy, sys
    sys.argv = ["test_torch_dryrun_ref.py", *{argv!r}]
    sys.path.insert(0, {tests!r})
    runpy.run_path({script!r}, run_name="__main__")
    print("jax imported:", any(m.split(".")[0] in ("jax", "jaxlib")
                               for m in sys.modules))
""")


def test_port_only_traces_without_jax(tmp_path):
    """`main --port-only` on one small cell, in a child as the card's
    host runs it: no jax imported, and the JSON holds the torch, the mesh
    and the cell's argument, alias and peak bytes and its collectives a
    step, equal to `lower_cell`'s."""
    path = tmp_path / "port.json"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", PORT_ONLY.format(
            argv=["gemma3-1b", "decode_32k", "--port-only", "--json",
                  str(path)], tests=tests,
            script=os.path.join(tests, "test_torch_dryrun_ref.py"))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "jax imported: False"
    with open(path) as f:
        got = json.load(f)
    assert set(got) == {"torch", "mesh", "cells"}
    assert got["mesh"] == "16x16" and set(got["cells"]) == \
        {"gemma3-1b|decode_32k"}
    cell = got["cells"]["gemma3-1b|decode_32k"]
    assert set(cell) == {"status", "argument_bytes", "alias_bytes", "peak",
                         "collectives", "trace_s"}
    rec = dryrun.lower_cell("gemma3-1b", "decode_32k", False)
    mem = rec["memory"]
    assert (cell["status"], cell["argument_bytes"], cell["alias_bytes"],
            cell["peak"]) == ("OK", mem["argument_bytes"],
                              mem["alias_bytes"], _peak(mem))
    assert cell["collectives"] == {
        k: v for k, v in rec["collectives_traced"].items() if k != "total"}
    assert cell["collectives"]["all-gather"] > 0
    assert not diff_traces(got, got)


# `main --all`: the cells left out, with the reason (none).
ALL_LEFT_OUT = {}
# The collectives that reduce a partial sum (a train step's gradients).
REDUCTIONS = ("all-reduce", "reduce-scatter")
PORT = textwrap.dedent("""
    import json
    from repro_torch.launch import dryrun
    print(json.dumps(dryrun.lower_cell({arch!r}, {shape!r}, {multi_pod})))
""")


def runnable_cells():
    """Every runnable (arch, shape) of the production meshes but
    ALL_LEFT_OUT, in the registry's order."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.shapes import cell_is_runnable

    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if cell_is_runnable(get_config(a), SHAPES[s])[0]
            and (a, s) not in ALL_LEFT_OUT]


def compare_all(jobs, timeout, multi_pod=False):
    """Every runnable cell of the 16x16 mesh, or with `multi_pod` the
    2x16x16 one, but ALL_LEFT_OUT: the reference's `lower_cell` in a
    child with `timeout` seconds, then the port's in another, `jobs`
    cells at a time; prints each cell's peak, and its all-gather,
    all-reduce and reduce-scatter a step (XLA's as its step runs them,
    `executed_collectives`), port / XLA, with the ratio of the two
    reductions' sum ("reductions": DTensor may reduce-scatter and gather
    where XLA all-reduces), a cell above GATHER_BAND[1] on peak,
    all-gather or reductions marked, then one JSON line a cell with the
    bytes (its all-to-all too, and its argument bytes as the port holds
    them less `unread_bytes` beside XLA's), and returns the rows."""
    from concurrent.futures import ThreadPoolExecutor

    mesh = make_production_mesh(multi_pod=multi_pod)
    name = "2x16x16" if multi_pod else "16x16"
    cells = runnable_cells()

    def one(cell):
        ref = _child_json(REF.format(cells=[cell], multi_pod=multi_pod),
                          timeout)
        port = _child_json(PORT.format(arch=cell[0], shape=cell[1],
                                       multi_pod=multi_pod), timeout)
        if isinstance(ref, str) or isinstance(port, str):
            return cell, "; ".join(
                f"{who}: {got.strip().splitlines()[-1]}" for who, got in
                (("reference", ref), ("port", port)) if isinstance(got, str))
        xla = ref[f"{cell[0]}|{cell[1]}"]
        moved = executed_collectives(xla["hlo"])
        traced = port["collectives_traced"]
        spec = SHAPES[cell[1]]
        unread = 0 if spec.kind == "train" else unread_bytes(
            get_config(cell[0]), spec, mesh)[0]
        got = {"peak": _peak(port["memory"]),
               "ref_peak": _peak(xla["memory"])}
        for kind in (*REDUCTIONS, "all-gather", "all-to-all"):
            got[kind] = traced.get(kind, 0.0)
            got[f"ref_{kind}"] = moved.get(kind, 0)
        got["reductions"] = sum(got[k] for k in REDUCTIONS)
        got["ref_reductions"] = sum(got[f"ref_{k}"] for k in REDUCTIONS)
        return cell, {
            **got, "argument_bytes": port["memory"]["argument_bytes"]
            - unread, "ref_argument_bytes": xla["memory"]["argument_bytes"]}

    def ratio(got, kind):
        mine, want = got[kind], got[f"ref_{kind}"]
        return mine / want if want else 1.0 if not mine else float("inf")

    kinds = ("all-gather", *REDUCTIONS)
    print(f"| cell ({name}) | peak GiB, port / XLA (x) | "
          + " | ".join(f"{k} GB a step, port / XLA (x)" for k in kinds)
          + " | reductions (x) |\n|---|---|---|---|---|---|")
    rows = []
    with ThreadPoolExecutor(jobs) as pool:
        for (arch, shape), got in pool.map(one, cells):
            rows.append((arch, shape, got))
            if isinstance(got, str):
                print(f"| {arch} {shape} | {got} | | | | |", flush=True)
                continue
            peak, ref_peak = got["peak"], got["ref_peak"]
            above = max(peak / ref_peak, ratio(got, "all-gather"),
                        ratio(got, "reductions")) > GATHER_BAND[1]
            print(f"| {arch} {shape}{' (above)' if above else ''} | "
                  f"{peak / 2**30:.3f} / {ref_peak / 2**30:.3f} "
                  f"({peak / ref_peak:.3f}) | "
                  + " | ".join(f"{got[k] / 1e9:.4g} / "
                               f"{got[f'ref_{k}'] / 1e9:.4g} "
                               f"({ratio(got, k):.3f})" for k in kinds)
                  + f" | {ratio(got, 'reductions'):.3f} |", flush=True)
    for cell, why in ALL_LEFT_OUT.items():
        print(f"| {' '.join(cell)} | left out: {why} | | | | |")
    for arch, shape, got in rows:
        if not isinstance(got, str):
            print(json.dumps({"cell": f"{arch}|{shape}|{name}", **got}))
    return rows


def trace_port(cells, jobs, timeout, multi_pod=False):
    """`cells` traced by the port alone on the 16x16 mesh, or with
    `multi_pod` the 2x16x16 one: its `lower_cell` in a child with
    `timeout` seconds, `jobs` cells at a time, with no reference and no
    jax (the card's host has none).  Returns {"torch", "mesh", "cells"}:
    for each cell, keyed "arch|shape", its status and, where it is OK,
    its argument, alias and peak bytes, each collective kind's bytes and
    count a step (`collectives_traced`) and its trace seconds; a cell
    whose child failed holds the failure's last line."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    def one(cell):
        rec = _child_json(PORT.format(arch=cell[0], shape=cell[1],
                                      multi_pod=multi_pod), timeout)
        if isinstance(rec, str):
            return cell, {"status": "FAIL",
                          "error": rec.strip().splitlines()[-1]}
        if rec["status"] != "OK":
            return cell, {"status": rec["status"]}
        mem = rec["memory"]
        return cell, {
            "status": "OK", "argument_bytes": mem["argument_bytes"],
            "alias_bytes": mem["alias_bytes"], "peak": _peak(mem),
            "collectives": {k: v for k, v in
                            rec["collectives_traced"].items()
                            if k != "total"},
            "trace_s": rec["lower_s"] + rec["compile_s"]}

    out = {}
    with ThreadPoolExecutor(jobs) as pool:
        for (arch, shape), got in pool.map(one, cells):
            out[f"{arch}|{shape}"] = got
            gather = got.get("collectives", {}).get("all-gather", 0.0)
            print(f"{arch} {shape}: {got['status']}"
                  + (f", peak {got['peak']} B, all-gather {gather:.0f} B a "
                     f"step, {got['trace_s']:.1f} s" if "peak" in got
                     else f" {got.get('error', '')}"), flush=True)
    return {"torch": torch.__version__,
            "mesh": "2x16x16" if multi_pod else "16x16", "cells": out}


def diff_traces(one, other):
    """The cells of two `trace_port` records of one mesh (two torches'),
    side by side: for each cell the argument, alias and peak bytes and
    each collective kind's bytes a step, `other`'s over `one`'s, a
    figure whose two differ by more than HOST_AGREE marked.  Prints a
    markdown table and returns {cell: [what differs]}."""
    print(f"| cell ({one['mesh']}) | peak B, torch {one['torch']} | "
          f"torch {other['torch']} over it: peak, all-gather, all-reduce, "
          f"reduce-scatter, all-to-all | differs by more than "
          f"{HOST_AGREE:.0%} |\n|---|---|---|---|")
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
    found = {}
    for cell in sorted(set(one["cells"]) | set(other["cells"])):
        a, b = one["cells"].get(cell), other["cells"].get(cell)
        if not (a and b and a["status"] == b["status"] == "OK"):
            found[cell] = [f"status {a and a['status']} / "
                           f"{b and b['status']}"]
            print(f"| {cell} | {found[cell][0]} | | |")
            continue
        pairs = {k: (a[k], b[k]) for k in ("argument_bytes", "alias_bytes",
                                           "peak")}
        pairs.update({k: (a["collectives"].get(k, 0.0),
                          b["collectives"].get(k, 0.0)) for k in kinds})
        ratios = {k: (y / x if x else (1.0 if not y else float("inf")))
                  for k, (x, y) in pairs.items()}
        off = [f"{k} {pairs[k][0]:.0f} / {pairs[k][1]:.0f}"
               for k, r in ratios.items() if abs(r - 1) > HOST_AGREE]
        if off:
            found[cell] = off
        print(f"| {cell} | {a['peak']} | "
              + ", ".join(f"{ratios[k]:.4f}" for k in ("peak", *kinds))
              + f" | {'; '.join(off)} |")
    return found


def main(argv=None):
    """`python tests/test_torch_dryrun_ref.py ARCH SHAPE [N] [PATTERN]`:
    the reference's compiled cell on 16x16, or with `--mesh multi`
    2x16x16 (`lower_cell`'s program):
    its memory, its N largest collectives grouped by kind, result shape
    and op name, and how many HLO instructions have a result matching
    the regex PATTERN (e.g. 'f32\\[88,').
    `python tests/test_torch_dryrun_ref.py --all [--mesh single|multi]
    [--jobs J] [--timeout S]`: `compare_all`, the port against the
    reference on every runnable cell of the 16x16 mesh (`single`, the
    default) or the 2x16x16 one (`multi`).
    `python tests/test_torch_dryrun_ref.py --all [--mesh single|multi]
    --port-only --json PATH` (or ARCH SHAPE for one cell): `trace_port`,
    the port alone, no jax imported, its records written to PATH.
    `python tests/test_torch_dryrun_ref.py --diff A.json B.json`:
    `diff_traces` of two such records (two torches' traces)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?")
    ap.add_argument("shape", nargs="?")
    ap.add_argument("n", nargs="?", type=int, default=12)
    ap.add_argument("pattern", nargs="?")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.diff:
        records = []
        for path in args.diff:
            with open(path) as f:
                records.append(json.load(f))
        diff_traces(*records)
        return
    if args.port_only:
        if not args.json or not (args.all or args.shape):
            ap.error("--port-only needs --json PATH and --all or ARCH SHAPE")
        cells = (runnable_cells() if args.all
                 else [(args.arch, args.shape)])
        got = trace_port(cells, args.jobs, args.timeout,
                         args.mesh == "multi")
        with open(args.json, "w") as f:
            json.dump(got, f, indent=1)
        return
    if args.all:
        compare_all(args.jobs, args.timeout, args.mesh == "multi")
        return
    if args.shape is None:
        ap.error("ARCH and SHAPE, or --all")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch import dryrun as ref_dryrun

    compiled = []
    real = ref_dryrun.collective_bytes

    def keep(hlo):
        compiled.append(hlo)
        return real(hlo)

    ref_dryrun.collective_bytes = keep
    rec = ref_dryrun.lower_cell(args.arch, args.shape, args.mesh == "multi")
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
