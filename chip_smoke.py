"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name, count, and nvidia-smi's name and power
     limit; exits non-zero without a CUDA card;
  2. build: compiles every src/repro_torch/kernels/csrc/*.cu for sm_90a
     and, at the same time, a copy under build/ of baseline/ (the
     previous design of the kernels, kept as a yardstick), one nvcc per
     source, and prints what ptxas reports for each kernel (registers,
     shared memory);
  3. kernels against their plain PyTorch versions on the card: the cases
     of the reference's kernel tests and the edge cases of the kernels'
     schedules (counts off the loops' unroll, revisits, strides that are
     0 or a multiple of the window, wider tiles) at small size in every
     dtype, the grid clamp, the same schedules through the library's
     entry points at CTA counts the wrappers never choose (one CTA, more
     CTAs than steps), and the main paths' full-size traversals (f32,
     4 KiB tiles, 65536 transactions per engine), which must agree
     exactly; then the working buffer made on the card against the one
     made on the host, just above 2**24 elements;
  4. main path: read, write and duplex points through
     Sweep(HBM, backend="cuda") -> Engine -> CudaBackend -> kernels, with
     the launch counters set to 0 just before and read just after (the
     single-tile hammer traversal runs from L2, and is labelled so); then
     the bench CLI on the headline sim experiments and the device rung;
  4c. contention path: N in {1, 2, 4} engines under round robin, 16-beat
     burst and exclusive grants, three heterogeneous readers under the
     same grants, and one cross-switch placement (capped by the modeled
     fabric, not a card number), through Sweep.add_contention -> Engine
     -> CudaBackend -> the contention kernels, with their launch counters
     set to 0 just before and read just after; write contention and a mix
     with a writer must be refused before any launch;
  5. report: kernel, baseline, plain and library times beside the bound,
     the kernel and baseline timed in turns; the baseline read's two
     passes alone and torch.profiler's device time per kernel;
  5c. the same for the contention kernels, with N = 1, 2, 4 round robin
     fitted to an intercept and a slope per engine;
  6. grid tier and measured roofline on the card: the bench's
     10,368-point HBM grid through the batched timing model (torchgrid)
     on the card, held against the same grid on the CPU and against the
     per-point timing model on an evenly spaced sample (rel 1e-9), with
     lanes per route, cold and warm wall time split into host prep,
     device and result mapping, and peak device memory; then
     roofline_empirical on `cuda` at the card's shapes (4 KiB tiles,
     256 MiB windows), whose rst_contend_read launches are counted with
     the counter set to 0 just before and read just after (and added to
     the kernel's launches in the kernels line), and the quick envelope
     on torchgrid against sim;
  7. service, tuner and roofline report through cuda, at phase 6's
     shapes: a CampaignService with a cuda primary and sim fallback
     serves layout_autotune and roofline_empirical twice each (cuda,
     undegraded, the duplicates coalesced), a latency request (degraded
     to sim with its reason) and a paper-burst request (a clean failure),
     with rst_contend_read's launches counted against the probes the
     plans make; tune_layout on cuda directly, held to its replay from
     the scores it measured, with the probes above their modeled
     ceilings counted; the same tune as a uniform read mix on the warm
     sweep; a mix with a writer refused; a transient fault injected over
     cuda, whose retry resumes; the measured report of the card's
     envelope; and `python -m repro_torch.launch.roofline --measured
     --backend cuda`, which must fail with the burst text;
  8. static analysis, lint report and examples, on the card's host: the
     port's repro-lint against analysis_baseline_torch.json (exit 0, no
     finding), `python -m repro_torch.bench --lint-report` (lint_total
     clean, each family's time), K001's parse of the extern "C" entry
     points against the library phase 2 built (each one exported, each
     exported *_launch entry typed in _SIGNATURES), and the two examples
     that need no LM: autotune_layout (its three tables) and
     shuhai_campaign on cuda (each experiment gives rows or is refused
     with the burst or capability text);
  9. the LM serving path on the card, float32 with TF32 off, random
     weights from a seeded generator: (a) gemma3-1b at full width and
     depth, forward over 2 x 600 tokens and 600 decode steps through a
     2048-slot cache (the 22 local layers' 512-slot rings wrap, the 4
     global layers' decode takes the online softmax), each step's logits
     against the forward's; (b) its first 6 layers at full width on the
     card against the card's host CPU; (c) the continuous-batching
     engine over the full model, 4 slots and 8 requests (prompts of 3 to
     700 tokens), two of them against an offline greedy decode; (d) all
     ten archs at smoke() size, decode against forward, and
     `python -m repro_torch.examples.serve_lm` on the card.  Printed
     beside the card's name and power limit: parameters and bytes,
     prefill and decode_step times, tokens/s, the card's busy share of a
     step (torch.profiler), the step's bytes over time against the data
     sheet's and phase 6's measured HBM rate, the engine's wall time and
     counts, and peak memory.  None of the four RST kernels runs here;
 10. the LM training path on the card, bf16 compute from float32 master
     weights, random weights from a seeded generator: (a) gemma3-1b at
     full width and depth (remat save_boundaries, its config's), 20 steps
     of make_train_step on 4 x 1024 tokens from the data pipeline with
     warmup_cosine: every loss and grad norm finite, the last loss below
     the first; the first step's gradients of its first 6 layers on the
     card against the card's host CPU (float32 with TF32 off, and bf16);
     peak memory of a step with each remat setting, "none" above
     "save_boundaries"; (b) a restart (starcoder2 smoke: 6 steps against
     3, an async save, a restore and 3 more) equal to rtol 1e-5 / atol
     1e-6; (c) every arch at smoke() size: a make_train_step of each
     decoder and the float32 loss, gradient and SGD step of all ten;
     (d) `python -m repro_torch.examples.train_lm --with-failure` on the
     card.  Printed beside the card's name and power limit: the step's
     median time and tokens/s, forward+backward and optim.apply apart,
     kernels per step and the busy share (torch.profiler), model FLOPs
     (6 N T) against the bf16 peak and the float32 attention FLOPs apart,
     optim.apply's bytes against the data sheet's and phase 6's HBM rate,
     and peak memory.  None of the four RST kernels runs here either;
 11. the launch layer, the dry run and the quickstart: (a) gemma3-1b at
     full width (float32, TF32 off) through launch/serve.py's
     make_prefill_step (2 x 600 tokens into a 2048-slot cache) and 64
     make_decode_step steps, each step's logits against the forward's,
     abstract_cache's leaves against the real cache's, and whisper's
     encoder-decoder prefill branch at smoke() size; (b) the dry run's
     accounting on a 1 x 1 mesh (the trace is then the device's own
     step) against the card: the train step at phase 10's 4 x 1024 tokens and the decode
     step at batch 4 with a 2048-slot cache, the predicted argument bytes
     equal to the bytes of the tensors the card holds, the predicted peak
     beside torch.cuda.max_memory_allocated(), and the traced FLOPs
     against 6 N T; (c) on the host's CPU while (a), (b) and (e) run:
     `python -m repro_torch.launch.dryrun --arch gemma3-1b --mesh both`
     (8 cells OK), `--all --mesh both --no-compile` (66 lowered, 14
     skipped), the nine 16x16 cells whose partitioned trace once failed
     (REPAIRED_CELLS: the MoE, rwkv6 and whisper cells; a child
     started before phase 9, so its host time overlaps phases 9-11; 9
     OK), a traced cell's process leaving CUDA uninitialised, and
     `python -m repro_torch.launch.roofline --in-dir build/dryrun` (8
     rows); (d) the quickstart's entry point on the card, rst_read's
     launches counted (added to its entry in the kernels line) and its
     whole checksum against the plain version's on the host (phase 3's
     f32 tolerance);
     (e) rank 0 of the production 16 x 16 mesh on the card: for
     gemma3-1b train_4k (one microbatch of 2 x 4096 from the rank's 16
     sequences, its backward and the update), gemma3-1b decode_32k,
     mistral-large-123b decode_32k, whisper-small decode_32k (its 1500
     encoder frames), qwen2-moe-a2.7b train_4k (its routing groups
     split over the data axis), gemma3-1b long_500k (traced by the
     shortcut over its local and global layers, run whole on the
     card), deepseek-v2-lite-16b prefill_32k (the first prefill and
     the first MLA cell: its latent cache split on slots, each rank
     making its rows' mask from the positions; traced by the shortcut,
     run whole on the card), starcoder2-7b train_4k and
     nemotron-4-15b prefill_32k (GQA attention whose heads the model
     axis leaves whole or cuts across KV groups: each rank attends its
     rows of queries over every head), rwkv6-7b long_500k (a
     one-token step: its products' partial sums all-reduced at once,
     no activation gathered around a projection), hymba-1.5b
     prefill_32k (32 layers, each a Mamba scan of 2048 chunks whose
     products keep batch and channels split, counted by its trip
     count on the host and on the card) and rwkv6-7b train_4k (its
     WKV chunk scans counted), and rank 0 of the multi-pod 2 x 16 x 16
     mesh for starcoder2-7b and qwen2-moe-a2.7b train_4k
     (RANK0_MULTI_CELLS: the batch, the gradients' reduction and the
     routing groups split over pod x data); each cell's host trace made
     in a child started before phase 9 (RANK0_TRACED; the cells (c)'s
     child traces take its records) but gemma3-1b long_500k's, the dry
     run's
     partitioned trace on the host (meta tensors) against the same
     partitioned step run for
     real on the card as rank 0 of a one-rank fake process group
     (`dryrun.run_on_rank`: the collectives return allocated, unfilled
     buffers; values are not checked, memory is): the predicted
     argument bytes equal to the bytes of the local tensors the card
     holds, and the predicted peak over torch.cuda.max_memory_allocated()
     inside PEAK_BAND, the traced all-gather bytes a microbatch (train),
     a layer (scanned layers; a layer of a microbatch in a scanned train
     step) or a step (STEP_CELLS, and the 2x16x16 cells) at most
     GATHER_OVER_REF times the reference's XLA program's
     (REF_ALL_GATHER, REF_ALL_GATHER_MULTI), qwen2-moe's and hymba's
     whole step's and the 2x16x16 cells' within HOST_AGREE of the
     figure traced on another torch (HOST_ALL_GATHER,
     HOST_ALL_GATHER_MULTI), the traced all-to-all beside it, with
     collectives_traced beside collectives and the host seconds, run
     after (b) while (c) goes on;
then one JSON line of kernels, the nvidia-smi line, and the final JSON
line.

It imports torch and the port (repro_torch) only.
"""
from __future__ import annotations

import atexit
import ctypes
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet: 3.35 TB/s device memory, 67 TFLOP/s float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Cycles of the sleep kernel that holds the stream while the host queues
# the timed calls (about 6 ms at the H100's 1.98 GHz boost clock).
HOLD_CYCLES = 12_000_000

TILE_ROWS = 8                    # burst_rows: 8 x 128 float32 = 4 KiB
FULL_N = 65536                   # transactions of a full-size point
# Traversals of the main path: (stride, window) in 4 KiB tiles.  seq and
# strided4 sweep a 256 MiB window, five times the card's 50 MB L2.
# hammer (S = W) revisits one tile, which stays in L2; its window is 64
# tiles because the operand's int32 guard, kept from the reference,
# refuses (n - 1) * S/B > 2**31 - 1, and one tile is all it touches.
PATTERNS = {"seq": (1, 65536), "strided4": (4, 65536), "hammer": (64, 64)}

# Cases of tests/kernels/test_rst_kernels.py (burst_rows, stride, wset, n)
# and (burst_rows, stride, wset, n, base).
READ_CASES = [(8, 1, 8, 8), (8, 1, 8, 20), (8, 2, 16, 16), (8, 4, 8, 9),
              (16, 1, 4, 7), (8, 8, 8, 5)]
WRITE_CASES = [(8, 1, 8, 8, 0), (8, 3, 8, 12, 0), (8, 2, 8, 3, 2),
               (16, 1, 6, 4, 1)]

# Edge cases of the write's and the reads' schedules, emulated on the host
# by tests/test_torch_kernels.py and tests/test_torch_contend.py: counts
# that are not a multiple of a loop's unroll, revisits (n > W/S), a stride
# that is 0 or a multiple of wset, a stride past the window, wider tiles.
READ_EDGE_CASES = [(8, 8, 8, 13), (8, 1, 512, 4000), (64, 3, 8, 100),
                   (16, 5, 64, 700), (8, 0, 4, 9)]
WRITE_EDGE_CASES = [(8, 1, 64, 1001, 0), (8, 3, 64, 1000, 0),
                    (8, 8, 8, 13, 0), (16, 0, 4, 9, 3), (64, 13, 8, 40, 0),
                    (8, 1, 4096, 4096, 0)]
# The same through the library's entry points, the reads at CTA counts
# the wrappers never choose: one CTA (many index batches), more CTAs than
# steps (CTAs that stream nothing but still store a partial row), and
# row counts off the cross-CTA sum's 128 row slices.  (stride, wset,
# base, n, engines, grant beats, grid); the read and the write take the
# first engine's window.
CTA_COUNTS = (1, 3, 40, 528, 1000)
RAW_CASES = [(1, 8, 0, 5, 1, 1, 8), (3, 8, 0, 40, 2, 1, 40),
             (8, 8, 1, 13, 3, 16, 16), (1, 512, 0, 701, 2, 1, 701),
             (1, 64, 0, 50, 3, 16, 64), (2, 64, 2, 60, 4, 60, 60)]
# (dtype name, burst_rows) of the raw launches: one slice of 256 threads,
# four slices (bf16, 64 rows), one slice of 128 threads (int8, 16 rows).
RAW_TILES = [("float32", 8), ("bfloat16", 64), ("int8", 16)]

# Cases of tests/kernels/test_rst_kernels.py::TestContendedKernel as
# kernel operands, with a nonzero base, a burst_rows-16 tile and a grid
# clamp added: (burst_rows, stride, wset, base, n, engines, grant beats,
# grid).
CONTEND_CASES = (
    [(8, 2, 8, 0, 12, e, 1, 16) for e in (1, 2, 3, 4)]
    + [(8, 2, 16, 0, 9, 1, 1, 16)]
    + [(8, 2, 8, 0, 11, e, bb, 16) for e in (2, 3) for bb in (2, 4, 8)]
    + [(8, 2, 8, 0, 9, 2, 16, 16), (8, 2, 8, 0, 11, 2, 16, 16),
       (8, 1, 16, 0, 8, 2, 1, 16), (8, 1, 16, 0, 8, 2, 4, 16),
       (8, 2, 8, 3, 11, 3, 4, 16), (16, 1, 4, 1, 7, 2, 2, 8),
       (8, 1, 8, 0, 99, 2, 3, 16)])
# Cases of TestMixKernel as tables: (engine rows, grant beats, grid).
MIX_ROWS = [[2, 8, 0, 12], [1, 4, 8, 9], [8, 16, 12, 16]]
MIX_CASES = (
    [(MIX_ROWS, bb, 16) for bb in (1, 4, 16)]
    + [([[2, 8, 0, 8], [1, 4, 8, 6]], 4, 16),
       ([[1, 4, 0, 8], [2, 8, 4, 8]], 1, 16),
       ([[3, 8, 2, 11], [1, 4, 10, 5], [2, 6, 14, 13]], 3, 13),
       ([[1, 8, 0, 20], [2, 8, 8, 5]], 4, 8)])

# The contention path's grants: (arbitration, burst_beats).
GRANTS = [("round_robin", 1), ("burst", 16), ("exclusive", 1)]
ENGINES = (1, 2, 4)
# The heterogeneous readers: (stride, window, n) in 4 KiB tiles.
MIX_READERS = [(1, 65536, FULL_N), (4, 65536, FULL_N), (1, 16384, 16384)]

HEADLINES = ["tREFI_est_ns=3900", "tREFI_est_ns=7800",
             "page_hit=106.7ns;page_closed=122.2ns;page_miss=137.8ns",
             "default_seq_gbps=6.64", "default_seq_gbps=18.06",
             "w8k_s4k_gbps=6.64;w256m_s4k_gbps=2.51",
             "total_gbps=424.9", "total_gbps=36.1", "spread=22cyc",
             "min_gbps=13.28"]
HEADLINE_EXPERIMENTS = ("fig4_refresh,table4_idle_latency,"
                        "fig6_address_mapping,fig7_locality,"
                        "table5_total_throughput,table6_switch_latency,"
                        "fig8_switch_throughput")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    phase("1. environment")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {name}; count: {count}; nvidia-smi: {smi}", flush=True)
    return name, count, smi


# The previous design of the kernels, kept verbatim in baseline/ as the
# yardstick phases 5 and 5c time the package's kernels against, and its
# C interface (every argument typed, or ctypes cuts pointers to 32 bits).
BASELINE = os.path.join(ROOT, "baseline")
BASELINE_BUILD = os.path.join(ROOT, "build", "baseline")
_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
BASELINE_SIGNATURES = {
    "rst_read_launch": (_I, _P, _I, _L, _L, _L, _L, _L, _I, _I, _P, _P, _P),
    "rst_write_launch": (_I, _P, _I, _L, _L, _L, _L, _L, _I, _I, _P),
    "rst_contend_read_launch": (_I, _P, _I, _L, _L, _L, _L, _L, _L, _L, _L,
                                _I, _I, _P, _P, _P),
    "rst_contend_mix_read_launch": (_I, _P, _I, _L, _P, _L, _L, _I, _I, _P,
                                    _P, _P),
    "baseline_read_partial": (_P, _L, _L, _L, _L, _L, _I, _I, _P, _P),
    "baseline_contend_partial": (_P, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I,
                                 _P, _P),
    "baseline_reduce": (_P, _L, _I, _P, _P),
}


def build():
    """Compiles the package's kernels and, at the same time, a copy of
    baseline/ under build/; returns the baseline's library."""
    from repro_torch.kernels import _build

    phase("2. build")
    shutil.rmtree(BASELINE_BUILD, ignore_errors=True)
    shutil.copytree(BASELINE, BASELINE_BUILD)
    obj = os.path.join(BASELINE_BUILD, "split.o")
    baseline = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-c", "-o", obj,
         os.path.join(BASELINE_BUILD, "split.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        path, log = _build.build()
    finally:
        base_log, _ = baseline.communicate()
    print(f"built {os.path.relpath(path, ROOT)} with {_build.nvcc()}")
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    _build.library()
    if baseline.returncode != 0:
        fail(f"nvcc failed on the baseline kernels:\n{base_log}")
    lib_path = os.path.join(BASELINE_BUILD, "libbaseline.so")
    subprocess.run([_build.nvcc(), "-shared", "-o", lib_path, obj],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in BASELINE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    print(f"built the baseline kernels {os.path.relpath(lib_path, ROOT)}")
    return lib


def numpy_buffer(rows: int, dtype, seed: int):
    """tests/kernels/test_rst_kernels.py::_mk, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-4, 5, size=(rows, 128),
                                          dtype=np.int8))
    else:
        x = torch.from_numpy(
            rng.standard_normal((rows, 128)).astype(np.float32)).to(dtype)
    return x.cuda()


def full_params(pattern: str):
    from repro_torch.core import RSTParams

    tile = TILE_ROWS * 128 * 4
    stride, window = PATTERNS[pattern]
    return RSTParams(n=FULL_N, b=tile, s=tile * stride, w=tile * window)


def compare_kernels(errors):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_read import rst_read, rst_read_plain
    from repro_torch.kernels.rst_write import rst_write, rst_write_plain

    phase("3. kernels against their plain versions, on the card")
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        rtol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        for burst_rows, stride, wset, n in READ_CASES + READ_EDGE_CASES:
            buf = numpy_buffer(wset * burst_rows, dtype, seed=0)
            params = torch.tensor([stride, wset, 0, n], dtype=torch.int32)
            kw = dict(grid_txns=max(n, 4), burst_rows=burst_rows)
            got = rst_read(params, buf, **kw)
            want = rst_read_plain(params, buf, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)
            errors["rst_read"] = max(errors["rst_read"],
                                     (got - want).abs().max().item())
        print(f"rst_read {dtype}: {len(READ_CASES + READ_EDGE_CASES)} "
              f"cases agree "
              f"(rtol {rtol}, atol 1e-4)")
    buf = numpy_buffer(64, torch.float32, seed=0)
    params = torch.tensor([1, 8, 0, 99], dtype=torch.int32)
    got = rst_read(params, buf, grid_txns=16)
    torch.testing.assert_close(got, rst_read_plain(params, buf, grid_txns=16),
                               rtol=1e-5, atol=1e-4)
    print("rst_read: n beyond the grid is clamped to the grid")
    for dtype in (torch.float32, torch.bfloat16):
        for burst_rows, stride, wset, n, base in (WRITE_CASES +
                                                  WRITE_EDGE_CASES):
            src = numpy_buffer((base + wset) * burst_rows, dtype, seed=1)
            params = torch.tensor([stride, wset, base, n], dtype=torch.int32)
            kw = dict(grid_txns=max(n, 4), burst_rows=burst_rows)
            got = rst_write(params, src.clone(), **kw)
            want = rst_write_plain(params, src.clone(), **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"rst_write {dtype} case {(burst_rows, stride, wset, n, base)}"
                     f" differs from its plain version")
        print(f"rst_write {dtype}: {len(WRITE_CASES + WRITE_EDGE_CASES)} "
              f"cases equal exactly")

    for pattern in PATTERNS:
        p = full_params(pattern)
        operand = ops.params_operand(p, torch.float32, TILE_ROWS)
        buf = ops.make_working_buffer(p, torch.float32)
        got = rst_read(operand, buf, grid_txns=p.n)
        want = rst_read_plain(operand, buf, grid_txns=p.n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"full-size rst_read {pattern}: max abs err "
                 f"{(got - want).abs().max().item()} (must be exact)")
        got_w = rst_write(operand, buf.clone(), grid_txns=p.n)
        want_w = rst_write_plain(operand, buf.clone(), grid_txns=p.n)
        torch.cuda.synchronize()
        if not torch.equal(got_w, want_w):
            fail(f"full-size rst_write {pattern} differs from plain")
        print(f"full size {pattern} (n={p.n}, W={p.w >> 10} KiB, "
              f"B={p.b}): read checksum sum {got.sum().item():.0f} and "
              f"written buffer equal their plain versions exactly")
        del buf, got_w, want_w


def compare_cta_counts(errors):
    """RAW_CASES through the library's entry points, the reads at every
    CTA count of CTA_COUNTS (the write takes one CTA a transaction),
    against the plain versions: the write exactly, the sums exactly on a
    buffer of small integers and to rtol 1e-5 on normal floats (bf16:
    2e-2)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rst_contend import rst_contend_read_plain
    from repro_torch.kernels.rst_read import (DTYPE_CODES, rst_read_plain,
                                              sum_scratch)
    from repro_torch.kernels.rst_write import rst_write_plain

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    count = 0
    for dtype_name, burst_rows in RAW_TILES:
        dtype = getattr(torch, dtype_name)
        code = DTYPE_CODES[dtype]
        tile_bytes = burst_rows * 128 * dtype.itemsize
        threads = min(256, tile_bytes // 16)
        rtol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        for stride, wset, base, n, engines, bb, grid in RAW_CASES:
            rows = (base + engines * wset) * burst_rows
            for values, buf in (("integers", small_int_buffer(rows, 7)),
                                ("normal", numpy_buffer(rows, torch.float32,
                                                        seed=7))):
                buf = buf.to(dtype)
                kw = dict(grid_txns=grid, num_engines=engines,
                          burst_beats=bb, burst_rows=burst_rows)
                operand = torch.tensor([stride, wset, base, n, engines, bb],
                                       dtype=torch.int32)
                want = rst_contend_read_plain(operand, buf, **kw)
                single = torch.tensor([stride, wset, base, min(n, grid)],
                                      dtype=torch.int32)
                want_read = rst_read_plain(single, buf, grid_txns=grid,
                                           burst_rows=burst_rows)
                steps = -(-grid // bb) * bb * engines
                for ctas in CTA_COUNTS:
                    partial, out = sum_scratch(buf, ctas, burst_rows)
                    _build.check(lib.rst_contend_read_launch(
                        0, buf.data_ptr(), code, tile_bytes, stride, wset,
                        base, n, engines, bb, steps, ctas, threads,
                        partial.data_ptr(), out.data_ptr(), stream),
                        "rst_contend_read")
                    got = out.clone()
                    _build.check(lib.rst_read_launch(
                        0, buf.data_ptr(), code, tile_bytes, stride, wset,
                        base, min(n, grid), ctas, threads,
                        partial.data_ptr(), out.data_ptr(), stream),
                        "rst_read")
                    torch.cuda.synchronize()
                    case = (stride, wset, base, n, engines, bb, grid)
                    for name, g, w in (("rst_contend_read", got, want),
                                       ("rst_read", out, want_read)):
                        if values == "integers":
                            if not torch.equal(g, w):
                                fail(f"{name} {dtype_name} {burst_rows} rows "
                                     f"case {case} at {ctas} CTAs differs "
                                     f"from plain (must be exact)")
                        else:
                            torch.testing.assert_close(g, w, rtol=rtol,
                                                       atol=1e-4)
                            errors[name] = max(errors[name],
                                               (g - w).abs().max().item())
                    count += 2
                if dtype == torch.int8 or values == "integers":
                    continue
                single = torch.tensor([stride, wset, base, n],
                                      dtype=torch.int32)
                want_w = rst_write_plain(single, buf.clone(), grid_txns=n,
                                         burst_rows=burst_rows)
                got_w = buf.clone()
                _build.check(lib.rst_write_launch(
                    0, got_w.data_ptr(), code, tile_bytes, stride, wset,
                    base, n, stream), "rst_write")
                torch.cuda.synchronize()
                if not torch.equal(got_w, want_w):
                    fail(f"rst_write {dtype_name} {burst_rows} rows case "
                         f"{(stride, wset, base, n)} differs from plain")
                count += 1
    print(f"{count} launches (reads at CTA counts {CTA_COUNTS}) agree with "
          f"the plain versions (sums of small integers and writes exactly)")


def small_int_buffer(rows: int, seed: int):
    """(rows, 128) float32 of integers 0..3 from a seeded generator, made
    on the card: every checksum element of a full-size run stays below
    2**24, so kernel and plain version must agree exactly."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 4, (rows, 128), generator=gen, device="cuda",
                         dtype=torch.float32)


def mix_readers():
    """The contention path's EngineMix of three heterogeneous readers."""
    from repro_torch.core import EngineMix, RSTParams

    tile = TILE_ROWS * 128 * 4
    return EngineMix.of([(RSTParams(n=n, b=tile, s=tile * s, w=tile * w),
                          "read") for s, w, n in MIX_READERS])


def compare_contend_kernels(errors):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_contend import (rst_contend_mix_read,
                                                 rst_contend_mix_read_plain,
                                                 rst_contend_read,
                                                 rst_contend_read_plain)

    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        rtol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        for case in CONTEND_CASES:
            burst_rows, stride, wset, base, n, engines, bb, grid = case
            buf = numpy_buffer((base + engines * wset) * burst_rows, dtype,
                               seed=3)
            params = torch.tensor([stride, wset, base, n, engines, bb],
                                  dtype=torch.int32)
            kw = dict(grid_txns=grid, num_engines=engines, burst_beats=bb,
                      burst_rows=burst_rows)
            got = rst_contend_read(params, buf, **kw)
            want = rst_contend_read_plain(params, buf, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)
            errors["rst_contend_read"] = max(
                errors["rst_contend_read"], (got - want).abs().max().item())
        for rows, bb, grid in MIX_CASES:
            span = max(base + wset for _, wset, base, _ in rows)
            buf = numpy_buffer(span * 8, dtype, seed=4)
            table = torch.tensor([[len(rows), bb, 0, 0]] + rows,
                                 dtype=torch.int32)
            kw = dict(grid_txns=grid, num_engines=len(rows), burst_beats=bb)
            got = rst_contend_mix_read(table, buf, **kw)
            want = rst_contend_mix_read_plain(table, buf, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)
            errors["rst_contend_mix_read"] = max(
                errors["rst_contend_mix_read"],
                (got - want).abs().max().item())
        print(f"rst_contend_read {dtype}: {len(CONTEND_CASES)} cases, "
              f"rst_contend_mix_read: {len(MIX_CASES)} cases agree "
              f"(rtol {rtol}, atol 1e-4)")

    # Full size, exactly, on small integers: one buffer holds the four
    # engines' windows, and fewer engines read its first windows.  seq
    # is the contention path's shape; strided4 (16384 distinct tiles an
    # engine, each read 4 times) is half of phase 6c's roofline probes.
    buf = small_int_buffer(max(ENGINES) * full_params("seq").w // (128 * 4),
                           seed=5)
    for pattern in ("seq", "strided4"):
        p = full_params(pattern)
        for engines in ENGINES:
            for arbitration, beats in GRANTS:
                bb = ops._resolve_grant_beats(arbitration, beats, p.n)
                operand = ops.contended_params_operand(
                    p, engines, torch.float32, TILE_ROWS, p.n, bb)
                kw = dict(grid_txns=p.n, num_engines=engines,
                          burst_beats=bb)
                got = rst_contend_read(operand, buf, **kw)
                want = rst_contend_read_plain(operand, buf, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"full-size rst_contend_read {pattern} "
                         f"N={engines} {arbitration}: max abs err "
                         f"{(got - want).abs().max().item()} (must be "
                         f"exact)")
        print(f"full size rst_contend_read {pattern} (N in {ENGINES}, "
              f"W=256 MiB per engine, n={p.n}) equals its plain version "
              f"exactly under {[g for g, _ in GRANTS]}")
    del buf
    mix = mix_readers()
    buf = ops.make_mix_working_buffer(mix, torch.float32)
    buf = small_int_buffer(buf.shape[0], seed=6)
    for arbitration, beats in GRANTS:
        bb = ops._resolve_grant_beats(arbitration, beats, FULL_N)
        table = ops.mix_params_operand(mix, torch.float32, TILE_ROWS, FULL_N,
                                       burst_beats=bb)
        kw = dict(grid_txns=FULL_N, num_engines=len(mix), burst_beats=bb)
        got = rst_contend_mix_read(table, buf, **kw)
        want = rst_contend_mix_read_plain(table, buf, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"full-size rst_contend_mix_read {arbitration}: max abs "
                 f"err {(got - want).abs().max().item()} (must be exact)")
    print(f"full size rst_contend_mix_read ({len(mix)} readers, "
          f"{buf.numel() * 4 >> 20} MiB) equals its plain version exactly")
    del buf


def compare_buffers():
    """The default working buffer made on the card against the one made on
    the host, just above 2**24 elements, where a float32 index rounds."""
    import torch

    from repro_torch.core import RSTParams
    from repro_torch.kernels import ops

    for dtype in (torch.float32, torch.bfloat16):
        size = dtype.itemsize
        p = RSTParams(n=8, b=1024 * size, s=1024 * size, w=(1 << 20) * size,
                      a=(1 << 24) * size)
        card = ops.make_working_buffer(p, dtype)
        host = ops.make_working_buffer(p, dtype, device="cpu")
        if not torch.equal(card.cpu(), host):
            fail(f"the {dtype} working buffer made on the card differs from "
                 f"the host's at {host.numel()} elements")
        print(f"working buffer {dtype}: {host.numel()} elements, card and "
              f"host equal")


def expected_checksum(p, op: str) -> float:
    """The checksum the cuda backend reports for (p, op), from the plain
    versions on a fresh working buffer: the read engine's tile sum, or
    the first 8 rows of the buffer after the write."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_read import rst_read_plain
    from repro_torch.kernels.rst_write import rst_write_plain

    operand = ops.params_operand(p, torch.float32, TILE_ROWS)
    buf = ops.make_working_buffer(p, torch.float32)
    if op == "write":
        out = rst_write_plain(operand, buf, grid_txns=p.n)[:8]
    else:
        out = rst_read_plain(operand, buf, grid_txns=p.n)
    return out.to(torch.float64).sum().item()


def main_path():
    import torch

    from repro_torch.core import HBM, Sweep
    from repro_torch.kernels.rst_read import rst_read
    from repro_torch.kernels.rst_write import rst_write

    phase("4. main path: Sweep(HBM, backend='cuda') -> Engine -> CudaBackend")
    sweep = Sweep(HBM, backend="cuda")
    names = {}
    for pattern in PATTERNS:
        names[full_params(pattern)] = pattern
        for op in ("read", "write", "duplex"):
            sweep.add(full_params(pattern), op=op)
    rst_read.launches = 0
    rst_write.launches = 0
    results = sweep.run()
    launches = {"rst_read": rst_read.launches, "rst_write": rst_write.launches}
    torch.cuda.synchronize()
    print(f"launches during the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path launched {name} no time")
    for r in results:
        p, op = r.point.params, r.point.op
        pattern = names[p]
        want = (2 if op == "duplex" else 1) * p.n * p.b
        gbps = r.value.gbps
        if r.value.detail["bytes"] != want:
            fail(f"{pattern} {op}: moved {r.value.detail['bytes']} bytes, "
                 f"want {want}")
        if not (math.isfinite(gbps) and gbps > 0):
            fail(f"{pattern} {op}: gbps {gbps} is not a positive number")
        if r.value.detail["checksum"] != expected_checksum(p, op):
            fail(f"{pattern} {op}: checksum {r.value.detail['checksum']} "
                 f"!= {expected_checksum(p, op)} from the plain versions")
        # A stream of distinct tiles far larger than L2 comes from device
        # memory and cannot beat its data-sheet rate.  strided4 reads its
        # 64 MiB of tiles four times, partly from L2, and hammer one tile.
        if pattern == "seq" and gbps > 1.1 * PEAK_BYTES_PER_S / 1e9:
            fail(f"{pattern} {op}: {gbps:.1f} GB/s exceeds the card's "
                 f"{PEAK_BYTES_PER_S / 1e9:.0f} GB/s: work was skipped")
        label = {"hammer": "hammer (one tile, L2-resident)",
                 "strided4": "strided4 (revisits partly from L2)"}.get(
                     pattern, pattern)
        print(f"main path {label} {op}: {gbps:.1f} GB/s, checksum sum "
              f"{r.value.detail['checksum']:.0f}, "
              f"{r.value.detail['seconds'] * 1e3:.4f} ms, "
              f"{r.value.detail['bytes']:.0f} bytes")
    return launches


def contention_checksum(p, engines: int, bb: int, mix=None) -> float:
    """The checksum the cuda backend reports for a contention point, from
    the plain version on a fresh working buffer."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_contend import (rst_contend_mix_read_plain,
                                                 rst_contend_read_plain)

    if mix is not None:
        table = ops.mix_params_operand(mix, torch.float32, TILE_ROWS, FULL_N,
                                       burst_beats=bb)
        buf = ops.make_mix_working_buffer(mix, torch.float32)
        out = rst_contend_mix_read_plain(table, buf, grid_txns=FULL_N,
                                         num_engines=len(mix), burst_beats=bb)
    else:
        operand = ops.contended_params_operand(p, engines, torch.float32,
                                               TILE_ROWS, p.n, bb)
        buf = ops.make_working_buffer(p, torch.float32, num_engines=engines)
        out = rst_contend_read_plain(operand, buf, grid_txns=p.n,
                                     num_engines=engines, burst_beats=bb)
    return out.to(torch.float64).sum().item()


def check_checksum(label: str, got: float, expected: float,
                   txns: int) -> None:
    """Fails unless a backend's checksum equals the plain version's:
    exactly while a checksum element, the sum of one element of at most
    250 from each of `txns` transactions, stays under 2**24; within rtol
    1e-5 beyond."""
    if txns * 250 < 2 ** 24:
        if got != expected:
            fail(f"{label}: checksum {got} != {expected} from the plain "
                 f"version (must be exact)")
    elif not math.isclose(got, expected, rel_tol=1e-5):
        fail(f"{label}: checksum {got} differs from the plain version's "
             f"{expected} beyond rtol 1e-5")


def contention_path():
    import torch

    from repro_torch.core import EngineMix, HBM, Sweep
    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_contend import (rst_contend_mix_read,
                                                 rst_contend_read)
    from repro_torch.kernels.rst_read import rst_read

    phase("4c. contention path: Sweep(HBM, backend='cuda').add_contention "
          "-> Engine -> CudaBackend")
    p = full_params("seq")
    mix = mix_readers()
    sweep = Sweep(HBM, backend="cuda")
    for engines in ENGINES:
        for arbitration, beats in GRANTS:
            sweep.add_contention(p, num_engines=engines,
                                 arbitration=arbitration, burst_beats=beats)
    for arbitration, beats in GRANTS:
        sweep.add_contention(p, mix=mix, arbitration=arbitration,
                             burst_beats=beats)
    sweep.add_contention(p, num_engines=4, placement="cross_switch")
    rst_contend_read.launches = 0
    rst_contend_mix_read.launches = 0
    results = sweep.run()
    launches = {"rst_contend_read": rst_contend_read.launches,
                "rst_contend_mix_read": rst_contend_mix_read.launches}
    torch.cuda.synchronize()
    print(f"launches during the contention path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the contention path launched {name} no time")

    peak_gbps = PEAK_BYTES_PER_S / 1e9
    for r in results:
        pt, res = r.point, r.value
        bb = ops._resolve_grant_beats(pt.arbitration, pt.burst_beats,
                                      FULL_N)
        if pt.placement != "same_channel":
            print(f"placement {pt.placement} N={pt.num_engines}: "
                  f"{res.aggregate_gbps:.1f} GB/s capped by the modeled "
                  f"fabric (uncapped sum of ports "
                  f"{res.detail['uncapped_aggregate_gbps']:.1f} GB/s, cap "
                  f"{res.detail['capacity_cap_gbps']:.1f} GB/s, bound "
                  f"{res.bound}); not a card number")
            continue
        label = (f"mix of {len(pt.mix)} readers"
                 if pt.mix is not None else f"N={pt.num_engines}")
        want = (sum(q.n * q.b for q in pt.mix.params) if pt.mix is not None
                else pt.num_engines * p.n * p.b)
        if res.detail["bytes"] != want:
            fail(f"{label} {pt.arbitration}: moved {res.detail['bytes']} "
                 f"bytes, want {want}")
        gbps = res.aggregate_gbps
        if not (math.isfinite(gbps) and 0 < gbps <= 1.1 * peak_gbps):
            fail(f"{label} {pt.arbitration}: {gbps} GB/s is not in "
                 f"(0, {1.1 * peak_gbps:.0f}]")
        got = res.detail["checksum"]
        check_checksum(f"{label} {pt.arbitration}", got,
                       contention_checksum(p, pt.num_engines, bb, pt.mix),
                       sum(q.n for q in pt.mix.params)
                       if pt.mix is not None else pt.num_engines * p.n)
        if pt.mix is None and pt.num_engines == 1:
            operand = ops.params_operand(p, torch.float32, TILE_ROWS)
            buf = ops.make_working_buffer(p, torch.float32)
            read = rst_read(operand, buf, grid_txns=p.n).to(
                torch.float64).sum().item()
            if got != read:
                fail(f"N=1 {pt.arbitration}: checksum {got} != rst_read's "
                     f"{read} on the same buffer")
        print(f"contention {label} {pt.arbitration}"
              f"{f' {pt.burst_beats}' if pt.arbitration == 'burst' else ''}"
              f": {gbps:.1f} GB/s, {res.detail['seconds'] * 1e3:.4f} ms, "
              f"{res.detail['bytes']:.0f} bytes, checksum sum {got:.0f}")

    before = dict(launches)
    refusals = [dict(params=p, num_engines=2, op="write"),
                dict(params=p, mix=EngineMix.of([(p, "read"),
                                                 (p, "write")]))]
    for kwargs in refusals:
        sweep = Sweep(HBM, backend="cuda").add_contention(**kwargs)
        try:
            sweep.run()
        except ValueError as e:
            if "read traffic only" not in str(e):
                fail(f"contention {kwargs} raised another error: {e}")
            print(f"refused before any launch: {e}")
        else:
            fail(f"contention {kwargs} was not refused")
    after = {"rst_contend_read": rst_contend_read.launches,
             "rst_contend_mix_read": rst_contend_mix_read.launches}
    if after != before:
        fail("a refused contention point launched a kernel")
    return launches


def bench_cli():
    phase("4b. bench CLI: python -m repro_torch.bench --quick")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "--quick",
         "--experiments", HEADLINE_EXPERIMENTS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        check=False)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        fail(f"repro_torch.bench exited {proc.returncode}")
    for text in HEADLINES:
        if text not in proc.stdout:
            fail(f"bench output lacks the headline {text!r}")
    print("bench headlines match the paper's numbers")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` back-to-back calls, CUDA
    events, after one warm-up call.  A sleep kernel holds the stream
    while the host queues the calls, so the time is the card's alone and
    not the host's latency in queueing the first one."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call of `fn` spent queueing it (the card
    runs behind; synchronised after the last call, outside the time)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def in_turns(fns, rounds: int = 4, iters: int = 20):
    """{name: ms} for each function of `fns`, timed in turns: `rounds`
    rounds of cuda_ms(fn, iters), every other round in reverse order, and
    the mean of the middle two rounds."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_ms(fns[name], iters))
    mid = rounds // 2
    return {name: sum(sorted(t)[mid - 1:mid + 1]) / 2
            for name, t in times.items()}


def kernel_split(fn, calls: int = 10):
    """{kernel name: device ms per call} of the kernels `fn` launches, from
    torch.profiler's key_averages(); empty if it reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        device_us = getattr(evt, "device_time_total", 0) or 0
        name = re.search(r"(\w+)(?:<[^(]*>)?\(", evt.key)
        if device_us > 0 and name and "kernel" in name.group(1):
            split[name.group(1)] = device_us / calls / 1e3
    return split


def fit_engines(ms):
    """(intercept µs, slope ms per engine) of a least-squares line through
    {N: ms} over the engine counts."""
    xs = list(ms)
    mx = sum(xs) / len(xs)
    my = sum(ms.values()) / len(xs)
    slope = (sum((x - mx) * (ms[x] - my) for x in xs)
             / sum((x - mx) ** 2 for x in xs))
    return (my - slope * mx) * 1e3, slope


def baseline_scratch(n_ctas: int, tile_elems: int):
    import torch

    return (torch.empty((n_ctas, tile_elems), dtype=torch.float32,
                        device="cuda"),
            torch.empty(tile_elems, dtype=torch.float32, device="cuda"))


def measure(launches, errors, smi, baseline):
    """kernel, plain and library times of rst_read and rst_write at the
    main path's shapes, in turns with the baseline kernels; the baseline
    read split into its two passes; returns their rows of the kernels
    line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_read import (launch_shape, rst_read,
                                              rst_read_plain, tile_indices)
    from repro_torch.kernels.rst_write import rst_write, rst_write_plain

    phase("5. report: times at the main path's shapes (f32, B = 4 KiB, "
          "n = 65536), in turns with the baseline kernels (baseline/)")
    print(f"card: {smi}")
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for pattern in PATTERNS:
        p = full_params(pattern)
        operand = ops.params_operand(p, torch.float32, TILE_ROWS)
        stride, wset, base, n = operand.tolist()
        buf = ops.make_working_buffer(p, torch.float32)
        view = buf.view(-1, TILE_ROWS * 128)
        idx = tile_indices(stride, wset, base, n, buf.device)
        unique = torch.unique(idx).numel()
        tile = p.b
        # Least bytes: each input tile read once and the checksum tile
        # written once (read); each touched tile written once (write).
        read_bytes = unique * tile + tile
        write_bytes = unique * tile
        # One float32 add per element read; a store is no operation.
        read_ops_ms = n * tile / 4 / PEAK_F32_FLOP_PER_S * 1e3
        read_bytes_ms = read_bytes / PEAK_BYTES_PER_S * 1e3
        write_bound = write_bytes / PEAK_BYTES_PER_S * 1e3
        lo, hi = int(idx.min()), int(idx.max()) + 1
        window = view[lo:hi] if hi - lo == unique else view[idx.unique()]
        fill = window.clone() if hi - lo != unique else window
        kw = dict(grid_txns=n)
        n_ctas, threads = launch_shape(buf, n, tile // 16)
        partial, out = baseline_scratch(n_ctas, tile // 4)
        args = (0, buf.data_ptr(), 0, tile, stride, wset, base, n, n_ctas,
                threads)
        read_t = in_turns({
            "ms": lambda: rst_read(operand, buf, **kw),
            "baseline_ms": lambda: baseline.rst_read_launch(
                *args, partial.data_ptr(), out.data_ptr(), stream),
            "library_ms": lambda: window.sum(0, dtype=torch.float32)})
        read = dict(read_t,
                    plain_ms=cuda_ms(lambda: rst_read_plain(operand, buf,
                                                            **kw), 3),
                    bound_ms=max(read_bytes_ms, read_ops_ms),
                    bound_by=("bytes" if read_bytes_ms >= read_ops_ms
                              else "operations"))
        write_t = in_turns({
            "ms": lambda: rst_write(operand, buf, **kw),
            "baseline_ms": lambda: baseline.rst_write_launch(*args, stream),
            "library_ms": lambda: fill.fill_(1.0)})
        write = dict(write_t,
                     plain_ms=cuda_ms(lambda: rst_write_plain(operand, buf,
                                                              **kw), 3),
                     bound_ms=write_bound, bound_by="bytes")
        for kernel, t in (("rst_read", read), ("rst_write", write)):
            label = f"{pattern}_l2" if pattern == "hammer" else pattern
            gbps = n * tile / (t["ms"] * 1e-3) / 1e9
            print(f"{kernel} {label}: kernel_ms={t['ms']:.5f} "
                  f"baseline_ms={t['baseline_ms']:.5f} "
                  f"plain_ms={t['plain_ms']:.5f} "
                  f"library_ms={t['library_ms']:.5f} "
                  f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
                  f"pct_of_bound={t['bound_ms'] / t['ms'] * 100:.1f} "
                  f"gbps={gbps:.1f} launches={launches[kernel]} card={smi}")
            rows[(kernel, pattern)] = t
        if pattern == "seq":
            passes = in_turns({
                "first_pass_ms": lambda: baseline.baseline_read_partial(
                    buf.data_ptr(), tile, stride, wset, base, n, n_ctas,
                    threads, partial.data_ptr(), stream),
                "second_pass_ms": lambda: baseline.baseline_reduce(
                    partial.data_ptr(), tile // 4, n_ctas, out.data_ptr(),
                    stream)})
            ours = kernel_split(lambda: rst_read(operand, buf, **kw))
            theirs = kernel_split(lambda: baseline.rst_read_launch(
                *args, partial.data_ptr(), out.data_ptr(), stream))
            print(f"rst_read seq split: baseline passes alone "
                  f"{format_ms(passes)}; profiler device ms per call: "
                  f"kernel {format_ms(ours)}, baseline {format_ms(theirs)} "
                  f"card={smi}")
            print(f"host us per call, queueing only: rst_read "
                  f"{host_us(lambda: rst_read(operand, buf, **kw)):.1f}, "
                  f"rst_write "
                  f"{host_us(lambda: rst_write(operand, buf, **kw)):.1f}")
        del buf, window, fill
    kernels = []
    for kernel, replaces in (("rst_read", "src/repro/kernels/rst_read.py:61"),
                             ("rst_write",
                              "src/repro/kernels/rst_write.py:45")):
        t = rows[(kernel, "seq")]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rst.cu",
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": errors[kernel], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return kernels


def format_ms(times) -> str:
    return " ".join(f"{name}={ms:.5f}" for name, ms in times.items())


def measure_contention(launches, errors, smi, baseline):
    """kernel, plain and library times of the contention kernels at the
    contention path's shapes, in turns with the baseline kernels; the
    N = 1, 2, 4 fit and the baseline's passes; returns their rows of the
    kernels line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_contend import (
        contend_tile_indices, mix_tile_indices, rst_contend_mix_read,
        rst_contend_mix_read_plain, rst_contend_read, rst_contend_read_plain,
        total_steps)
    from repro_torch.kernels.rst_read import launch_shape

    phase("5c. report: contention kernels (f32, B = 4 KiB, W = 256 MiB and "
          "n = 65536 per engine), in turns with the baseline kernels")
    stream = torch.cuda.current_stream().cuda_stream
    p = full_params("seq")
    tile = p.b
    buf = ops.make_working_buffer(p, torch.float32, num_engines=4)
    tiles = buf.shape[0] // TILE_ROWS

    def contend_fns(engines, bb):
        operand = ops.contended_params_operand(p, engines, torch.float32,
                                               TILE_ROWS, p.n, bb)
        stride, wset, base, n = operand.tolist()[:4]
        steps = total_steps(p.n, engines, bb)
        n_ctas, threads = launch_shape(buf, steps, tile // 16)
        partial, out = baseline_scratch(n_ctas, tile // 4)
        kw = dict(grid_txns=p.n, num_engines=engines, burst_beats=bb)
        head = (buf.data_ptr(), tile, stride, wset, base, n, engines, bb,
                steps, n_ctas, threads)
        return operand, kw, {
            "ms": lambda: rst_contend_read(operand, buf, **kw),
            "baseline_ms": lambda: baseline.rst_contend_read_launch(
                0, buf.data_ptr(), 0, *head[1:], partial.data_ptr(),
                out.data_ptr(), stream),
            "baseline_first_pass_ms": lambda: (
                baseline.baseline_contend_partial(*head, partial.data_ptr(),
                                                  stream)),
            "baseline_second_pass_ms": lambda: baseline.baseline_reduce(
                partial.data_ptr(), tile // 4, n_ctas, out.data_ptr(),
                stream)}

    by_engines = {}
    for engines in ENGINES:
        _, _, fns = contend_fns(engines, 1)
        by_engines[engines] = in_turns(fns)
        print(f"rst_contend_read N={engines} round_robin: "
              f"{format_ms(by_engines[engines])} card={smi}")
    for name in ("ms", "baseline_ms", "baseline_first_pass_ms"):
        icpt, slope = fit_engines({e: t[name] for e, t in
                                   by_engines.items()})
        print(f"fit over N={ENGINES} of {name}: intercept {icpt:.2f} us, "
              f"slope {slope:.5f} ms per 256 MiB engine "
              f"({tile * p.n / (slope * 1e-3) / 1e9:.1f} GB/s)")
    _, _, fns = contend_fns(4, 1)
    print(f"rst_contend_read N=4 round_robin split, profiler device ms per "
          f"call: kernel {format_ms(kernel_split(fns['ms']))}, baseline "
          f"{format_ms(kernel_split(fns['baseline_ms']))}; host us per "
          f"call, queueing only: {host_us(fns['ms']):.1f} card={smi}")

    mix = mix_readers()
    mix_buf = ops.make_mix_working_buffer(mix, torch.float32)
    cases = []
    for arbitration in ("round_robin", "exclusive"):
        bb = ops._resolve_grant_beats(arbitration, 1, p.n)
        operand, kw, fns = contend_fns(4, bb)
        idx = contend_tile_indices(operand, tiles, device=buf.device, **kw)
        cases.append(("rst_contend_read", f"N=4 {arbitration}", buf, idx,
                      {k: fns[k] for k in ("ms", "baseline_ms")},
                      lambda o=operand, kw=kw: rst_contend_read_plain(
                          o, buf, **kw)))
    bb = ops._resolve_grant_beats("round_robin", 1, FULL_N)
    table = ops.mix_params_operand(mix, torch.float32, TILE_ROWS, FULL_N,
                                   burst_beats=bb)
    kw = dict(grid_txns=FULL_N, num_engines=len(mix), burst_beats=bb)
    idx = mix_tile_indices(table, mix_buf.shape[0] // TILE_ROWS,
                           device=mix_buf.device, **kw)
    steps = total_steps(FULL_N, len(mix), bb)
    n_ctas, threads = launch_shape(mix_buf, steps, tile // 16)
    partial, out = baseline_scratch(n_ctas, tile // 4)
    dev_table = torch.as_tensor(table, dtype=torch.int32).cuda()
    cases.append(("rst_contend_mix_read",
                  f"mix of {len(mix)} readers round_robin", mix_buf, idx,
                  {"ms": lambda: rst_contend_mix_read(table, mix_buf, **kw),
                   "baseline_ms": lambda: baseline.rst_contend_mix_read_launch(
                       0, mix_buf.data_ptr(), 0, tile, dev_table.data_ptr(),
                       len(mix), steps, n_ctas, threads, partial.data_ptr(),
                       out.data_ptr(), stream)},
                  lambda: rst_contend_mix_read_plain(table, mix_buf, **kw)))

    rows = {}
    for kernel, label, window_buf, idx, fns, plain in cases:
        moved = idx.numel() * tile
        # Least bytes: each distinct tile read once and the checksum tile
        # written once; one float32 add per element read.
        least = torch.unique(idx).numel() * tile + tile
        bytes_ms = least / PEAK_BYTES_PER_S * 1e3
        ops_ms = idx.numel() * tile / 4 / PEAK_F32_FLOP_PER_S * 1e3
        window = window_buf.view(-1, TILE_ROWS * 128)
        fns = dict(fns, library_ms=lambda w=window: w.sum(
            0, dtype=torch.float32))
        t = dict(in_turns(fns), plain_ms=cuda_ms(plain, 3),
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        gbps = moved / (t["ms"] * 1e-3) / 1e9
        print(f"{kernel} {label}: kernel_ms={t['ms']:.5f} "
              f"baseline_ms={t['baseline_ms']:.5f} "
              f"plain_ms={t['plain_ms']:.5f} "
              f"library_ms={t['library_ms']:.5f} "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
              f"pct_of_bound={t['bound_ms'] / t['ms'] * 100:.1f} "
              f"gbps={gbps:.1f} launches={launches[kernel]} card={smi}")
        rows.setdefault(kernel, t)
    del cases, buf, mix_buf, window
    return [{
        "name": kernel, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rst_contend.cu",
        "replaces": replaces, "launches": launches[kernel],
        "max_abs_err": errors[kernel], "ms": rows[kernel]["ms"],
        "plain_ms": rows[kernel]["plain_ms"],
        "bound_ms": rows[kernel]["bound_ms"],
        "bound_by": rows[kernel]["bound_by"],
        "library_ms": rows[kernel]["library_ms"]}
        for kernel, replaces in (
            ("rst_contend_read", "src/repro/kernels/rst_contend.py:215"),
            ("rst_contend_mix_read", "src/repro/kernels/rst_contend.py:146"))]


# Phase 6: the card's shapes for the measured roofline on `cuda` (every
# probe a contention kernel at B = its 4 KiB tile over 256 MiB windows),
# and the H100 SXM data sheet's ridge, 989.4 TFLOP/s over 3.35 TB/s.
ROOFLINE_CARD = dict(chip="h100_sxm", bursts=(4096,),
                     strides=(4096, 4 * 4096), engines=(1, 4), n=FULL_N,
                     w=256 << 20)
RIDGE_AI = 989.4e12 / PEAK_BYTES_PER_S
GRID_REL = 1e-9


def _tied(res, rel=GRID_REL) -> bool:
    """A model bound within `rel` of another: either name is right."""
    if res.bound not in ("bus/ccd", "bank", "faw"):
        return False
    vals = sorted(res.detail[b] for b in ("bus/ccd", "bank", "faw"))
    return vals[-1] - vals[-2] <= rel * abs(vals[-1])


def _close(a: float, b: float, rel: float = GRID_REL,
           abs_tol: float = 0.0) -> bool:
    return math.isclose(a, b, rel_tol=rel, abs_tol=abs_tol)


def check_grid(label, gbps, bound, queueing, want):
    """Fails unless the arrays equal the wanted per-point results at rel
    1e-9, with bound names equal wherever the wanted result is not a
    tie; returns the number of ties whose names differ."""
    ties = 0
    for i, res in enumerate(want):
        if not _close(gbps[i], res.aggregate_gbps):
            fail(f"{label}: point {i} gbps {gbps[i]!r} != "
                 f"{res.aggregate_gbps!r} beyond rel {GRID_REL}")
        if not _close(queueing[i], res.queueing_delay_cycles, abs_tol=1e-9):
            fail(f"{label}: point {i} queueing {queueing[i]!r} != "
                 f"{res.queueing_delay_cycles!r}")
        if bound[i] != res.bound:
            if not _tied(res):
                fail(f"{label}: point {i} bound {bound[i]} != "
                     f"{res.bound} away from a tie")
            ties += 1
    return ties


def grid_split_line(res) -> str:
    sp = res.split
    return (f"wall {res.elapsed_seconds * 1e3:.3f} ms = host prep "
            f"{sp.prep_s * 1e3:.3f} ms + device {sp.device_s * 1e3:.3f} ms "
            f"(copies in, evaluation, copies out, ending in a synchronize)"
            f" + host lanes {sp.host_lanes_s * 1e3:.3f} ms + result "
            f"mapping {sp.map_s * 1e3:.3f} ms; "
            f"{res.points_per_second:.0f} pts/s")


def profiled(fn, calls):
    """(kernels, device ms, {name: (launches, device us)}) of `calls`
    calls of `fn` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, device_us, by_name = 0, 0.0, {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            kernels += 1
            device_us += ev.device_time
            n, us = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (n + 1, us + ev.device_time)
    return kernels, device_us / 1e3, by_name


def profile_grid(fn):
    """Device kernels and their device time in one call, from
    torch.profiler; None where the profiler reads no device time."""
    kernels, device_ms, _ = profiled(fn, 1)
    return (kernels, device_ms) if kernels else None


def probe_shapes(points, switch):
    """Measurements on `cuda` by kernel shape (stride, engines per port,
    arbitration, grant beats) of (stride, placement, engines, arbitration,
    grant beats) points: one a point on same_channel, one a distinct
    per-port engine count on the other placements (the placement fold
    measures each count once)."""
    import collections

    from repro_torch.core.engine import placement_port_counts

    shapes = collections.Counter()
    for stride, placement, engines, arbitration, beats in points:
        counts = ([engines] if placement == "same_channel"
                  else placement_port_counts(switch, placement, engines)[1])
        for count in set(counts):
            shapes[(stride, count, arbitration, beats)] += 1
    return shapes


def roofline_shapes(env, launches: int, switch):
    """Splits the roofline's launches of rst_contend_read by kernel
    shape, (stride, engines per port): N on same_channel, and on the
    other tiers each distinct per-port count, evaluated once a probe.
    For each shape: one probe run again through Sweep on `cuda`, its
    checksum held against the plain version's and its launches counted;
    the time of a launch from the median of the roofline's own
    same_channel repeats of the shape; the bound from the distinct tiles
    the shape reads.  Fails unless the shapes' launches add up to
    `launches`.  Returns each shape's (time, bound) in ms."""
    import collections
    import statistics

    import torch

    from repro_torch.core import HBM, RSTParams, Sweep
    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_contend import rst_contend_read

    shapes = collections.Counter()
    for (stride, engines, _, _), probes in probe_shapes(
            [(pt.stride, pt.placement, pt.num_engines, "round_robin", 1)
             for pt in env.points], switch).items():
        shapes[(stride, engines)] += probes
    tile = TILE_ROWS * 128 * 4
    n, w = ROOFLINE_CARD["n"], ROOFLINE_CARD["w"]
    total, gap, prices = 0, 0.0, {}
    for (stride, engines), probes in sorted(shapes.items()):
        p = RSTParams(n=n, b=tile, s=stride, w=w)
        label = f"S={stride // tile} tiles N={engines}"
        rst_contend_read.launches = 0
        (r,) = Sweep(HBM, backend="cuda").add_contention(
            p, num_engines=engines).run()
        torch.cuda.synchronize()
        per_probe = rst_contend_read.launches
        bb = ops._resolve_grant_beats("round_robin", 1, n)
        check_checksum(f"roofline shape {label}", r.value.detail["checksum"],
                       contention_checksum(p, engines, bb), engines * n)
        repeats = [q.gbps for q in env.points
                   if (q.placement, q.num_engines, q.stride)
                   == ("same_channel", engines, stride)]
        ms = engines * n * tile / statistics.median(repeats) / 1e6
        windows = w // tile
        distinct = engines * min(n, windows // math.gcd(stride // tile,
                                                        windows))
        bound_ms = distinct * tile / PEAK_BYTES_PER_S * 1e3
        prices[(stride, engines)] = (ms, bound_ms)
        count = probes * per_probe
        total += count
        gap += count * (ms - bound_ms)
        print(f"roofline shape {label}: {probes} probes x {per_probe} "
              f"launches = {count}; {ms:.5f} ms a launch (from the median "
              f"of {len(repeats)} same_channel repeats, "
              f"{statistics.median(repeats):.3f} GB/s), bound "
              f"{bound_ms:.5f} ms ({distinct} distinct 4 KiB tiles read "
              f"once), launches x (time - bound) = "
              f"{count * (ms - bound_ms):.3f} ms; checksum of a re-run "
              f"equals the plain version's")
    if total != launches:
        fail(f"the roofline's launches by shape add up to {total}, not "
             f"the {launches} counted")
    print(f"roofline launches of rst_contend_read, each priced at its own "
          f"shape: {total} launches, {gap:.3f} ms above their bounds")
    return prices


def grid_tier(smi):
    """Phase 6: the 10,368-point grid through `torchgrid` on the card,
    held against the CPU and the per-point model; its timing split; the
    measured roofline on `cuda` at the card's shapes; the quick envelope
    on `torchgrid` against `sim`.  Returns the roofline's launches of
    rst_contend_read, each kernel shape's (time, bound) in ms and the
    measured peak in GB/s."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch import bench
    from repro_torch.core import HBM, Sweep
    from repro_torch.core import roofline_empirical as rf
    from repro_torch.core import timing_torch
    from repro_torch.core.switch import PLACEMENTS, SwitchModel
    from repro_torch.core.channels import topology_for
    from repro_torch.kernels.rst_contend import rst_contend_read

    phase("6. grid tier and measured roofline on the card")
    print(f"card: {smi}")
    axes = bench.grid_axes()

    # (a) the grid on the card against the grid on the CPU and against
    # the per-point model.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    cold = timing_torch.evaluate_grid(HBM, axes)
    warm_runs = [timing_torch.evaluate_grid(HBM, axes) for _ in range(5)]
    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    warm = sorted(warm_runs, key=lambda r: r.elapsed_seconds)[2]
    host = timing_torch.evaluate_grid(HBM, axes, device="cpu")
    routes = {r: cold.split.routes.get(r, 0)
              for r in timing_torch._ROUTES}
    print(f"grid: {cold.size} points over {sum(routes.values())} lanes; "
          f"lanes per route {routes} (numpy and mixnumpy lanes run on "
          f"the host)")
    ties = check_grid("grid on the card vs on the CPU", cold.gbps,
                      cold.bound, cold.queueing_delay_cycles, host.results())
    for run in warm_runs:
        if not (np.array_equal(run.gbps, cold.gbps)
                and np.array_equal(run.bound, cold.bound)):
            fail("a warm grid call differs from the cold one")
    idx, sample = bench.grid_sample(axes)
    sweep = Sweep(HBM, backend="sim")
    for pt in sample:
        sweep.add_point(pt)
    t0 = time.perf_counter()
    per_point = [r.value for r in sweep.run()]
    numpy_s = time.perf_counter() - t0
    ties += check_grid("grid on the card vs timing_model per point",
                       cold.gbps[idx], cold.bound[idx],
                       cold.queueing_delay_cycles[idx], per_point)
    print(f"grid on the card == grid on the CPU ({cold.size} points) and "
          f"== timing_model per point ({len(sample)} evenly spaced "
          f"points) at rel {GRID_REL}; bound names differ at {ties} "
          f"tie(s)")
    # Every lane of the grid is periodic; the full-expansion and mixed
    # evaluators are held on the bench's mixed requests and on the same
    # tuples cut to short, non-periodic streams (no exclusive grants).
    reqs = bench.grid_mix_requests(axes)
    for p in axes.params[:6]:
        short = dataclasses.replace(p, n=300)
        for op in ("read", "write", "duplex"):
            for n_eng, bb in ((1, 1), (3, 4), (4, 2)):
                reqs.append(("cont", short, "RBC", op, n_eng,
                             "round_robin" if bb == 1 else "burst", bb,
                             "same_channel"))
    lanes = timing_torch.GridSplit()
    on_card = timing_torch.evaluate_points(HBM, reqs, split=lanes)
    on_host = timing_torch.evaluate_points(HBM, reqs, device="cpu")
    ties = check_grid("full and mixed lanes on the card vs on the CPU",
                      [r.aggregate_gbps for r in on_card],
                      [r.bound for r in on_card],
                      [r.queueing_delay_cycles for r in on_card], on_host)
    print(f"{len(reqs)} requests on the full and mixed evaluators (lanes "
          f"per route {lanes.routes}) on the card == on the CPU at rel "
          f"{GRID_REL}; bound names differ at {ties} tie(s)")

    # (b) where the time goes.
    print(f"grid cold: {grid_split_line(cold)}")
    warm_pps = [r.points_per_second for r in warm_runs]
    print(f"grid warm (median of 5, pts/s "
          f"{' '.join(f'{v:.0f}' for v in warm_pps)}): "
          f"{grid_split_line(warm)}")
    prof = profile_grid(lambda: timing_torch.evaluate_grid(HBM, axes))
    if prof is None:
        print("grid warm kernels: not measured (the profiler read no "
              "device time)")
    else:
        print(f"grid warm kernels: {prof[0]} device kernels and copies, "
              f"{prof[1]:.3f} ms of device time (torch.profiler); device "
              f"busy {prof[1] / (warm.elapsed_seconds * 1e3) * 100:.2f} % "
              f"of the median warm wall, idle the rest")
    print(f"grid peak device memory: {peak_mem} bytes "
          f"({peak_mem / 2**20:.1f} MiB, torch.cuda.max_memory_allocated)")
    print(f"grid on the host CPU, for reference (not a card number): "
          f"{grid_split_line(host)}")
    print(f"timing_model per point (host CPU yardstick): {len(sample)} "
          f"points in {numpy_s * 1e3:.3f} ms, "
          f"{len(sample) / numpy_s:.1f} pts/s; the card's warm grid is "
          f"{statistics.median(warm_pps) / (len(sample) / numpy_s):.0f}x")
    for name, us, derived in bench.bench_grid(quick=True):
        print(f"bench --grid --quick: {name},{us:.0f},{derived}")

    # (c) the measured roofline on `cuda` at the card's shapes.
    rst_contend_read.launches = 0
    t0 = time.perf_counter()
    env = rf.measure_envelope(HBM, "cuda", **ROOFLINE_CARD)
    torch.cuda.synchronize()
    roof_s = time.perf_counter() - t0
    launches = rst_contend_read.launches
    print(f"roofline_empirical on cuda ({ROOFLINE_CARD}): "
          f"{len(env.points)} probes in {roof_s:.3f} s, rst_contend_read "
          f"launched {launches} times")
    if launches <= 0:
        fail("the roofline on cuda launched rst_contend_read no time")
    peak = PEAK_BYTES_PER_S / 1e9
    top = max(env.points, key=lambda q: q.gbps)
    repeats = [q.gbps for q in env.points
               if (q.placement, q.num_engines, q.stride)
               == (top.placement, top.num_engines, top.stride)]
    print(f"roofline peak_gbps={env.peak_gbps:.3f} against the data "
          f"sheet's {peak:.0f} GB/s ({env.peak_gbps / peak * 100:.1f} %); "
          f"knee_ai={env.knee_ai():.3f} FLOP/B against the data sheet's "
          f"ridge {RIDGE_AI:.3f} FLOP/B; card={smi}")
    print(f"roofline peak_gbps is the largest of {len(repeats)} repeats "
          f"of the {top.placement} N={top.num_engines} "
          f"S={top.stride // 4096} tiles probe (one per address policy, "
          f"which the card ignores): median "
          f"{statistics.median(repeats):.3f} GB/s, range "
          f"{min(repeats):.3f}-{max(repeats):.3f}")
    if not (math.isfinite(env.peak_gbps)
            and 0 < env.peak_gbps <= 1.1 * peak):
        fail(f"roofline peak {env.peak_gbps} GB/s is not in "
             f"(0, {1.1 * peak:.0f}]: work was skipped")
    switch = SwitchModel(topology_for(HBM))
    for plc in PLACEMENTS:
        cap = switch.capacity_cap_gbps(plc)
        agg = env.placement_aggregate_gbps[plc]
        if plc == "same_channel":
            label = "a card number"
        elif cap is not None and agg >= cap * (1 - 1e-12):
            label = (f"capped by the modeled U280 fabric ({cap:.1f} GB/s),"
                     f" not a card number")
        else:
            label = ("a sum of per-port card samples taken one port at a "
                     "time, not a concurrent card number")
        print(f"roofline tier {plc}: per_engine_gbps="
              f"{env.placement_gbps[plc]:.3f} aggregate_gbps={agg:.3f} "
              f"({label})")
    print("roofline per-policy entries (the card ignores the address "
          "policy: each is a repeat of one mapping, measured again): "
          + " ".join(f"{pol}={g:.3f}"
                     for pol, g in sorted(env.policy_gbps.items())))
    prices = roofline_shapes(env, launches, switch)

    # (d) the quick envelope on `torchgrid` (the card) equals `sim`'s.
    grid_env = rf.measure_envelope(HBM, "torchgrid", quick=True)
    sim_env = rf.measure_envelope(HBM, "sim", quick=True)
    pairs = [("peak_gbps", grid_env.peak_gbps, sim_env.peak_gbps)]
    for field in ("placement_gbps", "placement_aggregate_gbps",
                  "policy_gbps"):
        a, b = getattr(grid_env, field), getattr(sim_env, field)
        if set(a) != set(b):
            fail(f"envelope {field} keys differ: {sorted(a)} {sorted(b)}")
        pairs += [(f"{field}[{k}]", a[k], b[k]) for k in b]
    if len(grid_env.points) != len(sim_env.points):
        fail("the torchgrid and sim envelopes have different probes")
    pairs += [(f"points[{i}]", a.gbps, b.gbps)
              for i, (a, b) in enumerate(zip(grid_env.points,
                                             sim_env.points))]
    for name, a, b in pairs:
        if not _close(a, b):
            fail(f"envelope {name}: torchgrid {a!r} != sim {b!r}")
    print(f"quick envelope on torchgrid (card) == on sim at rel "
          f"{GRID_REL}: peak_gbps={grid_env.peak_gbps:.3f} "
          f"knee_ai={grid_env.knee_ai():.3f} points={len(grid_env.points)}")
    return launches, prices, env.peak_gbps


# Phase 7: the campaign service, the layout tuner and the roofline report
# through `cuda`, at the card's shapes of phase 6 (f32, B = 4 KiB tiles,
# n = 65536 and W = 256 MiB per engine, N in {1, 4}).  The tuner's knobs:
# every address policy (the card ignores it), round robin, 16-beat burst
# and exclusive grants, the three placements.
CAMPAIGN_TUNE = dict(b=4096, s=4096, w=256 << 20, n=FULL_N)
TUNE_KNOBS = dict(arbitrations=("round_robin", "burst", "exclusive"),
                  burst_beats=(16,))
LATENCY_GAP = ("needs serial-latency measurements, which backend 'cuda' "
               "does not provide")
BURST_TEXT = "burst B=32 does not match tile bytes 4096"
READ_ONLY_TEXT = "the concurrent-access cuda kernel measures read traffic only"


def planned_probes(request, switch):
    """The measurements a request's plan makes on `cuda`, by shape."""
    from repro_torch.core import HBM
    from repro_torch.core.experiments import plan_experiment

    planned, _ = plan_experiment(request.experiment, HBM,
                                 quick=request.quick,
                                 **dict(request.overrides))
    return probe_shapes([(pt.params.s, pt.placement, pt.num_engines,
                          pt.arbitration, pt.burst_beats)
                         for _, pt in planned], switch)


def config_probes(configs, stride, switch):
    """The measurements the tuner's configs make on `cuda`, by shape."""
    from repro_torch.core.autotune import _mix_engines

    return probe_shapes([(stride, cfg.placement, _mix_engines(cfg.engines),
                          cfg.arbitration, cfg.burst_beats)
                         for cfg in configs], switch)


def price_launches(by_shape, prices) -> None:
    """Prints the phase's launches by (stride, engines) shape, each priced
    at phase 6c's time and bound of that shape."""
    tile = TILE_ROWS * 128 * 4
    gap = 0.0
    for (stride, engines), count in sorted(by_shape.items()):
        ms, bound_ms = prices[(stride, engines)]
        gap += count * (ms - bound_ms)
        print(f"phase 7 shape S={stride // tile} tiles N={engines}: {count} "
              f"launches x ({ms:.5f} - {bound_ms:.5f}) ms = "
              f"{count * (ms - bound_ms):.3f} ms above the bound (phase "
              f"6c's time and bound of the shape)")
    print(f"phase 7 launches of rst_contend_read, each priced at its own "
          f"shape: {sum(by_shape.values())} launches, {gap:.3f} ms above "
          f"their bounds")


def check_shapes(shapes) -> None:
    """Runs each kernel shape once more through Sweep on `cuda` and holds
    its checksum against the plain version's (launches not counted)."""
    import torch

    from repro_torch.core import HBM, RSTParams, Sweep
    from repro_torch.kernels import ops

    tile = TILE_ROWS * 128 * 4
    n, w = CAMPAIGN_TUNE["n"], CAMPAIGN_TUNE["w"]
    for stride, engines, arbitration, beats in sorted(shapes):
        p = RSTParams(n=n, b=tile, s=stride, w=w)
        (r,) = Sweep(HBM, backend="cuda").add_contention(
            p, num_engines=engines, arbitration=arbitration,
            burst_beats=beats).run()
        torch.cuda.synchronize()
        bb = ops._resolve_grant_beats(arbitration, beats, n)
        check_checksum(f"campaign shape S={stride // tile} tiles "
                       f"N={engines} {arbitration} {beats}",
                       r.value.detail["checksum"],
                       contention_checksum(p, engines, bb), engines * n)
    print(f"{len(shapes)} kernel shapes of the phase run again through "
          f"Sweep on cuda: each checksum equals the plain version's")


def report_tune(label, rep, spec, configs, switch) -> int:
    """Prints a tuner report, holds it to its replay from the scores it
    measured, and returns how many measured probes exceeded their
    config's modeled ceiling."""
    from repro_torch.core import autotune as tune
    from repro_torch.core.roofline_empirical import config_ceiling_gbps

    table = {c: g for r in rep.trajectory for c, g in zip(r.configs, r.gbps)}
    ceilings = {c: config_ceiling_gbps(spec, c.placement,
                                       tune._mix_engines(c.engines))
                for c in configs}
    ordered = tune._ordered_bracket(spec, configs, seed=0, budget=None)
    rounds, measured, winner, best = tune._replay_search(
        ordered, ceilings, lambda batch: [table[c] for c in batch], eta=2)
    if (rounds, winner, best) != (rep.trajectory, rep.winner,
                                  rep.winner_gbps):
        fail(f"{label}: the report differs from its replay from the scores "
             f"it measured")
    if len(measured) != rep.evaluations or best != max(table.values()):
        fail(f"{label}: the winner is not the argmax of the scores measured")
    over = sum(g > ceilings[c] for c, g in table.items())
    print(f"{label}: {rep.evaluations}/{rep.candidates} evaluations, winner "
          f"{rep.winner.describe()} {rep.winner_gbps:.3f} GB/s on the card; "
          f"trajectory " + "; ".join(
              f"rung {r.rung}: {len(r.configs)} measured, best "
              f"{r.best_gbps:.3f}, {r.pruned} pruned"
              for r in rep.trajectory))
    print(f"{label}: equals its replay from its own scores, winner = their "
          f"argmax; {over} of {len(table)} measured probes exceed their "
          f"config's modeled U280 ceiling (config_ceiling_gbps)"
          f"{', a bound the pruning trusts' if over else ''}; "
          f"nominal_fraction {rep.nominal_fraction:.3f} divides by the "
          f"modeled U280 wire rate ({spec.peak_channel_gbps} GB/s an "
          f"engine), not a rate of the card")
    return over


def campaign_path(smi, prices):
    """Phase 7: the service, the tuner and the roofline report through
    `cuda` (the card), its launches priced at `prices` (phase 6c's time
    and bound of each kernel shape).  Returns the rst_contend_read
    launches of the phase's requests and tunes."""
    import collections

    import torch

    from repro_torch.core import (HBM, H100_SXM, AccessPattern,
                                  MemoryOracle, RSTParams, Sweep,
                                  get_experiment, tune_layout)
    from repro_torch.core import autotune as tune
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.channels import topology_for
    from repro_torch.core.switch import PLACEMENTS, SwitchModel
    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_contend import (rst_contend_mix_read,
                                                 rst_contend_read)
    from repro_torch.kernels.rst_read import rst_read
    from repro_torch.kernels.rst_write import rst_write
    from repro_torch.launch import roofline as report
    from repro_torch.service import (CampaignService, ExperimentRequest,
                                     Fault, FaultScript,
                                     register_fault_injected)

    phase("7. service, tuner and roofline report through cuda")
    print(f"card: {smi}")

    t_phase = time.perf_counter()
    per_probe = 1 + ops.TIMED_RUNS * ops.CALLS_PER_RUN
    switch = SwitchModel(topology_for(HBM))
    counters = (rst_read, rst_write, rst_contend_read, rst_contend_mix_read)
    tuned = ExperimentRequest.make("layout_autotune", "hbm", mixes=(1, 4),
                                   **CAMPAIGN_TUNE, **TUNE_KNOBS)
    roof = ExperimentRequest.make("roofline_empirical", "hbm",
                                  **ROOFLINE_CARD)
    latency = ExperimentRequest.make("table4_idle_latency", "hbm")
    paper = ExperimentRequest.make("fig6_address_mapping", "hbm")
    tuned_shapes = planned_probes(tuned, switch)
    roof_shapes = planned_probes(roof, switch)
    shapes = tuned_shapes + roof_shapes
    want = sum(shapes.values()) * per_probe
    print(f"planned: layout_autotune {sum(tuned_shapes.values())} probes, "
          f"roofline_empirical {sum(roof_shapes.values())} probes, "
          f"{per_probe} rst_contend_read launches a probe: {want} launches")

    # (1) The service: a cuda primary, sim fallback, every response
    # sampled for validation.
    svc = CampaignService("cuda", "sim", validate_fraction=1.0, seed=0)
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    out = svc.submit_all([tuned, tuned, roof, roof, latency, paper])
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    launches = rst_contend_read.launches
    print(f"service: {len(out)} requests in {served_s:.3f} s; "
          f"rst_contend_read launched {launches} times (planned {want}); "
          f"stats {svc.stats}")
    for r in out:
        what = (get_experiment(r.request.experiment).summary(HBM, r.result)
                if r.ok else r.error)
        print(f"  {r.request.experiment}: ok={r.ok} backend={r.backend!r} "
              f"degraded={r.degraded} coalesced={r.coalesced} "
              f"validated={r.validated} reason={r.degraded_reason!r}: "
              f"{what}")
    if launches != want:
        fail(f"the service launched rst_contend_read {launches} times, not "
             f"the {want} its plans make")
    if any(k.launches for k in counters if k is not rst_contend_read):
        fail("the service launched a kernel other than rst_contend_read")
    for r in out[:4]:
        if not (r.ok and r.backend == "cuda" and r.degraded is False):
            fail(f"{r.request.experiment} was not served by cuda undegraded:"
                 f" {r}")
    if [r.coalesced for r in out[:4]] != [False, True, False, True]:
        fail("the duplicate requests were not coalesced")
    if (svc.stats.executed, svc.stats.dropped) != (4, 0):
        fail(f"stats executed={svc.stats.executed} "
             f"dropped={svc.stats.dropped}, want 4 and 0")
    lat, bad = out[4], out[5]
    if not (lat.ok and lat.backend == "sim" and lat.degraded is True
            and LATENCY_GAP in (lat.degraded_reason or "")):
        fail(f"table4_idle_latency did not degrade to sim with its reason: "
             f"{lat}")
    if bad.ok or bad.backend or BURST_TEXT not in (bad.error or ""):
        fail(f"fig6_address_mapping was not a clean failure: {bad}")
    check_shapes(shapes)
    env = out[2].result

    # (2) The tuner, directly, on a coalescing Sweep of its own.
    p = RSTParams(**CAMPAIGN_TUNE)
    knobs = dict(TUNE_KNOBS, placements=PLACEMENTS)
    sweep = Sweep(HBM, "cuda", coalesce=True)
    rst_contend_read.launches = 0
    rep = tune_layout(p, HBM, "cuda", mixes=(1, 4), sweep=sweep, **knobs)
    torch.cuda.synchronize()
    direct = rst_contend_read.launches
    configs = tune._canonical_configs(HBM, policies=None, mixes=(1, 4),
                                      **knobs)
    measured = [c for r in rep.trajectory for c in r.configs]
    direct_shapes = config_probes(measured, p.s, switch)
    want_direct = sum(direct_shapes.values()) * per_probe
    print(f"direct tune_layout on cuda: rst_contend_read launched {direct} "
          f"times ({want_direct} for its {len(measured)} probes)")
    if direct != want_direct:
        fail(f"the direct tune launched {direct} times, not {want_direct}")
    over = report_tune("direct tune", rep, HBM, configs, switch)

    # (3) A uniform read-only mix folds into the homogeneous key: the
    # warm sweep serves every config the first tune measured.
    rst_contend_read.launches = 0
    rep4 = tune_layout(p, HBM, "cuda", mixes=("4r",), sweep=sweep, **knobs)
    torch.cuda.synchronize()
    folded = rst_contend_read.launches
    seen = {(c.policy, c.arbitration, c.burst_beats, c.placement,
             tune._mix_engines(c.engines)) for c in measured}
    new = [c for r in rep4.trajectory for c in r.configs
           if (c.policy, c.arbitration, c.burst_beats, c.placement, 4)
           not in seen]
    folded_shapes = config_probes(new, p.s, switch)
    want_folded = sum(folded_shapes.values()) * per_probe
    print(f"tune with mixes=('4r',) on the warm sweep: "
          f"{rep4.evaluations}/{rep4.candidates} evaluations, "
          f"{len(new)} configs the first tune did not measure, "
          f"rst_contend_read launched {folded} times ({want_folded} for "
          f"those); winner {rep4.winner.describe()} "
          f"{rep4.winner_gbps:.3f} GB/s")
    if folded != want_folded:
        fail(f"the folded tune launched {folded} times, not {want_folded}")
    configs4 = tune._canonical_configs(HBM, policies=None, mixes=("4r",),
                                       **knobs)
    over += report_tune("folded tune", rep4, HBM, configs4, switch)

    # (4) A mix with a writer: refused by the read-only kernels, not
    # degraded.
    rst_contend_read.launches = 0
    mixed = svc.submit(ExperimentRequest.make(
        "layout_autotune", "hbm", mixes=("2r+1w",), **CAMPAIGN_TUNE,
        **TUNE_KNOBS))
    torch.cuda.synchronize()
    refused = rst_contend_read.launches
    print(f"layout_autotune mixes=('2r+1w',): ok={mixed.ok} "
          f"degraded={mixed.degraded} error={mixed.error!r}; "
          f"rst_contend_read launched {refused} times before the refusal "
          f"(the reader ports of the first same_switch probe)")
    if mixed.ok or mixed.degraded or READ_ONLY_TEXT not in (mixed.error
                                                            or ""):
        fail(f"the 2r+1w request was not refused as read-only: {mixed}")

    # (5) A transient fault injected over cuda: the retried Sweep.run()
    # resumes, so no probe is measured twice.
    faulty = register_fault_injected(
        "cuda", name="cuda+faults", override=True,
        script=FaultScript().script(None, None, None, Fault("transient")))
    try:
        fsvc = CampaignService("cuda+faults", "sim", validate_fraction=1.0,
                               seed=0)
        rst_contend_read.launches = 0
        fr = fsvc.submit(roof)
        torch.cuda.synchronize()
        resumed = rst_contend_read.launches
    finally:
        engine_mod._BACKEND_REGISTRY.pop("cuda+faults", None)
    roof_probes = sum(roof_shapes.values())
    print(f"roofline_empirical on cuda+faults: ok={fr.ok} "
          f"backend={fr.backend!r} retries={fr.retries} "
          f"degraded={fr.degraded}; {faulty.calls} backend calls for "
          f"{roof_probes} probes, rst_contend_read launched {resumed} times "
          f"({roof_probes * per_probe} with nothing measured twice)")
    if not (fr.ok and fr.backend == "cuda+faults" and not fr.degraded
            and fr.retries == 1 and faulty.injected["transient"] == 1):
        fail(f"the transient over cuda was not retried to success: {fr}")
    if faulty.calls != roof_probes + 1 or resumed != roof_probes * per_probe:
        fail("the retried run measured a probe again instead of resuming")

    # (6) The measured report of the card's envelope, and the oracle.
    print("roofline report of the card's envelope (frac of nominal "
          "divides by the modeled U280 wire rate, not a rate of the card):")
    print(report.report_markdown(report.envelope_report_rows(env)))
    oracle = MemoryOracle(chip=H100_SXM)
    pattern = AccessPattern(4096, 4096, 256 << 20)
    print(f"MemoryOracle(chip=H100_SXM), modeled (data-sheet peak x the U280"
          f" model's derating, not a measurement): efficiency "
          f"{oracle.efficiency(pattern):.4f}, effective bandwidth "
          f"{oracle.effective_bandwidth(pattern) / 1e9:.1f} GB/s for 4 KiB "
          f"sequential bursts over 256 MiB")
    wall = time.perf_counter() - t_phase
    total = launches + direct + folded + refused + resumed
    # The refused mix measured reader ports of one engine each.
    by_shape = collections.Counter({(p.s, 1): refused})
    for counter in (shapes, direct_shapes, folded_shapes, roof_shapes):
        for (stride, engines, _, _), probes in counter.items():
            by_shape[(stride, engines)] += probes * per_probe
    if sum(by_shape.values()) != total:
        fail(f"phase 7's launches by shape add up to "
             f"{sum(by_shape.values())}, not the {total} counted")
    price_launches(by_shape, prices)
    print(f"phase 7: {wall:.3f} s wall; service sustained_qps "
          f"{svc.stats.sustained_qps:.3f} (host and card, {smi}); "
          f"{over} probes above their modeled ceiling; rst_contend_read "
          f"launched {total} times in the phase ({launches} service, "
          f"{direct} direct tune, {folded} folded tune, {refused} refused "
          f"mix, {resumed} fault-injected)")
    return total


def roofline_cli_refuses():
    """`python -m repro_torch.launch.roofline --measured --backend cuda`
    at its defaults probes 32-byte bursts: it must exit non-zero with the
    burst text, with no fallback."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--measured",
         "--backend", "cuda"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300, check=False)
    if proc.returncode == 0 or BURST_TEXT not in proc.stderr:
        fail(f"the roofline CLI on cuda at its defaults exited "
             f"{proc.returncode} without the burst text:\n{proc.stderr}")
    print(f"python -m repro_torch.launch.roofline --measured --backend cuda"
          f" exited {proc.returncode}: "
          f"{proc.stderr.strip().splitlines()[-1]}")


# Phase 8: the port's static analysis and the examples, each in a
# subprocess as a user runs it.  An experiment the card's kernels cannot
# run is refused for its burst (the paper's 32/64-byte bursts against the
# 4 KiB tile) or for a capability the cuda backend lacks.
BURST_REFUSAL = re.compile(r"burst B=\d+ does not match tile bytes 4096")
CAPABILITY_REFUSALS = ("(supports_latency=False)",
                       "(supports_contention=False)", READ_ONLY_TEXT)
AUTOTUNE_TABLES = ("KV cache (decode sweeps seq):",
                   "Saved activations (backward sweeps layers):",
                   "Expert weights (dispatch sweeps experts):")


def run_module(args, timeout: int = 300):
    """`python -m <args>` from the checkout's root; returns the finished
    process and its wall seconds (interpreter start included)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout,
                          check=False)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"python -m {' '.join(args)} exited {proc.returncode}:\n"
             f"{proc.stdout}{proc.stderr}")
    return proc, wall


def exported_symbols(path: str):
    """Global functions the shared library at `path` exports (nm -D)."""
    try:
        out = subprocess.run(["nm", "-D", "--defined-only", path],
                             capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        fail(f"nm cannot list the exports of {path}: {e}")
    return {parts[2] for parts in map(str.split, out.splitlines())
            if len(parts) == 3 and parts[1] in ("T", "W")}


def static_analysis():
    """Phase 8: the lint, its bench report, K001's parse against the
    built library, and the two examples that need no LM."""
    from pathlib import Path

    from repro_torch.analysis import kernel_shapes
    from repro_torch.analysis.lint import BASELINE
    from repro_torch.core import HBM
    from repro_torch.core.experiments import experiments_for
    from repro_torch.kernels import _build

    phase("8. static analysis, lint report and examples")
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "lint")
    os.makedirs(out_dir, exist_ok=True)

    findings_path = os.path.join(out_dir, "findings.json")
    proc, wall = run_module(["repro_torch.analysis.lint", "--baseline",
                             BASELINE, "--json", findings_path])
    with open(findings_path) as f:
        findings = json.load(f)["findings"]
    if findings:
        fail(f"repro-lint reports {len(findings)} findings:\n{proc.stdout}")
    print(f"python -m repro_torch.analysis.lint: exit 0, 0 findings, "
          f"{wall:.3f} s wall; {proc.stdout.strip().splitlines()[-1]}")

    report_path = os.path.join(out_dir, "BENCH_lint.json")
    _, wall = run_module(["repro_torch.bench", "--lint-report", "--json",
                          report_path])
    with open(report_path) as f:
        rows = {r["name"]: r for r in json.load(f)["rows"]}
    if "clean=True" not in rows.get("lint_total", {}).get("derived", ""):
        fail(f"bench --lint-report is not clean: {rows}")
    for name, row in rows.items():
        print(f"{name}: {row['us_per_call']:.1f} us; {row['derived']}")
    print(f"python -m repro_torch.bench --lint-report: {wall:.3f} s wall")

    parsed = kernel_shapes.extern_c_functions(
        sorted(Path(_build.CSRC).glob("*.cu")))
    lib = _build.library()
    exported = exported_symbols(str(_build.library_path()))
    absent = [f.name for f in parsed
              if f.name not in exported or not hasattr(lib, f.name)]
    if absent:
        fail(f"extern \"C\" functions the lint parsed but the library does "
             f"not export: {absent}")
    entries = sorted(n for n in exported if n.endswith("_launch"))
    untyped = [n for n in entries if n not in _build._SIGNATURES]
    if untyped or not entries:
        fail(f"exported launch entries without a _SIGNATURES row: "
             f"{untyped or 'none exported'}")
    print(f"{len(parsed)} extern \"C\" functions parsed "
          f"({', '.join(f.name for f in parsed)}) are exported by "
          f"{os.path.relpath(_build.library_path(), ROOT)}; its "
          f"{len(entries)} launch entries all have a _SIGNATURES row")

    proc, wall = run_module(["repro_torch.examples.autotune_layout"])
    missing = [t for t in AUTOTUNE_TABLES if t not in proc.stdout]
    if missing:
        fail(f"autotune_layout printed no table {missing}:\n{proc.stdout}")
    print(f"python -m repro_torch.examples.autotune_layout: "
          f"{len(AUTOTUNE_TABLES)} tables, {wall:.3f} s wall")

    proc, wall = run_module(["repro_torch.examples.shuhai_campaign",
                             "--specs", "hbm", "--backend", "cuda"], 600)
    with_rows = {line.split(",")[1] for line in
                 proc.stdout.strip().splitlines()[1:]}
    refusals = {}
    for line in proc.stderr.splitlines():
        match = re.match(r"skipping (\S+) on hbm/cuda: (.*)$", line)
        if match:
            refusals[match.group(1)] = match.group(2)
    counts = {"rows": 0, "burst": 0, "capability": 0}
    for exp in experiments_for(HBM):
        why = refusals.get(exp.name, "")
        if exp.name in with_rows:
            counts["rows"] += 1
        elif BURST_REFUSAL.search(why):
            counts["burst"] += 1
        elif any(text in why for text in CAPABILITY_REFUSALS):
            counts["capability"] += 1
        else:
            fail(f"shuhai_campaign on cuda neither measured nor refused "
                 f"{exp.name} with the burst or capability text: {why!r}")
    print(f"python -m repro_torch.examples.shuhai_campaign --specs hbm "
          f"--backend cuda: {sum(counts.values())} experiments, "
          f"{counts['rows']} with rows, {counts['burst']} refused for the "
          f"burst, {counts['capability']} for a capability; {wall:.3f} s "
          f"wall")
    print(f"phase 8: {time.perf_counter() - t_phase:.3f} s wall")


# ------------------------------------------------------------- phase 9
# The LM serving path on the card: gemma3-1b at full width and depth,
# float32, random weights from a seeded generator on the card.
LM_ARCH = "gemma3-1b"
LM_SEED = 0
LM_TOKENS = 600          # forward tokens per sequence and decode steps:
#                          past the 512-slot ring of the 22 local layers
LM_MAX_SEQ = 2048        # 2048 slots in the 4 global layers, more than
#                          attn_kv_chunk (1024): decode's online softmax
LM_DECODE_TOL = 5e-3     # rtol = atol of tests/models/test_archs_smoke.py
LM_CPU_LAYERS = 6        # full width, 6 layers (layer 5 global)
LM_CPU_TOKENS = 64
LM_CPU_ATOL = 1e-3       # card against the card's host CPU, float32
LM_TIMED_BATCH = 4
LM_TIMED_STEPS = 30
LM_PROFILED_STEPS = 5
ENGINE_SLOTS = 4
ENGINE_PROMPTS = (3, 700, 40, 257, 12, 513, 96, 5)
ENGINE_MAX_NEW = 16
ENGINE_OFFLINE = (0, 5)  # requests held to an offline greedy decode
LM_DEVICE = "cuda"       # phase 9's device ("cpu" only to rehearse it)


def _tf32_off():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")


def _tensor_bytes(tree) -> int:
    import torch

    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _within(got, ref, tol):
    """(max |got - ref|, max of |got - ref| - tol (1 + |ref|)) as 0-d
    tensors on the card: the second is <= 0 iff allclose(rtol=atol=tol)."""
    d = (got - ref).abs()
    return d.max(), (d - tol * (1 + ref.abs())).max()


def lm_decode_against_forward(model, params, tokens, full):
    """Phase 9a's check: one decode step per token through a
    LM_MAX_SEQ cache, each step's logits against the forward's."""
    import torch

    b, s = tokens.shape
    cache = model.init_cache(batch_size=b, max_seq=LM_MAX_SEQ,
                             dtype=torch.float32, device=LM_DEVICE)
    err = torch.zeros((), device=LM_DEVICE)
    worst = torch.full((), -1.0, device=LM_DEVICE)
    for t in range(s):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        e, w = _within(lg, full[:, t], LM_DECODE_TOL)
        err, worst = torch.maximum(err, e), torch.maximum(worst, w)
    torch.cuda.synchronize()
    return cache, err.item(), worst.item()


def lm_offline_greedy(model, params, prompt, n):
    """The reference test's offline decode: one sequence, prompt tokens
    fed one by one, then its own greedy tokens."""
    import torch

    cache = model.init_cache(batch_size=1, max_seq=LM_MAX_SEQ,
                             dtype=torch.float32, device=LM_DEVICE)
    toks, out = list(prompt), []
    for t in range(len(prompt) + n - 1):
        feed = torch.tensor([[toks[t]]], device=LM_DEVICE)
        logits, cache = model.decode_step(params, cache, feed)
        if t >= len(prompt) - 1:
            out.append(int(logits[0].argmax()))
            if len(toks) <= t + 1:
                toks.append(out[-1])
    return out


def lm_smoke_archs():
    """Phase 9d: every arch at smoke() size, decode against forward on
    the card (stacked layers, MLA, MoE, rwkv6, hymba, the enc-dec)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build

    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        if cfg.moe is not None:      # non-binding capacity, as the test
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        model = build(cfg)
        gen = torch.Generator(device=LM_DEVICE).manual_seed(LM_SEED + 2)
        params = init_params(gen, model.param_specs(), torch.float32,
                         device=LM_DEVICE)
        b, s = 2, 8
        tokens = torch.randint(0, cfg.vocab_size, (b, s), device=LM_DEVICE,
                               generator=gen)
        batch = {"tokens": tokens}
        if cfg.is_encdec:
            batch["frames"] = torch.randn(
                b, cfg.enc_dec.enc_seq, cfg.d_model, device=LM_DEVICE,
                generator=gen)
        if cfg.mrope_sections:
            pos = torch.arange(s, device=LM_DEVICE)[None].expand(b, s)
            batch["mrope_positions"] = pos[None].expand(3, b, s)
        full, _ = model.forward(params, batch)
        cache = model.init_cache(batch_size=b, max_seq=s + 4,
                                 dtype=torch.float32, device=LM_DEVICE)
        if cfg.is_encdec:
            cache = model.start_cache(params, batch["frames"], cache)
        err, worst = 0.0, -1.0
        for t in range(s):
            lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
            e, w = _within(lg, full[:, t], LM_DECODE_TOL)
            err, worst = max(err, e.item()), max(worst, w.item())
        layout = ("list" if "list" in cache else "stack" if "stack" in cache
                  else "enc-dec")
        print(f"9d {arch}: decode == forward over {s} steps, max |diff| "
              f"{err:.3e} (rtol=atol={LM_DECODE_TOL}), cache {layout}")
        if not (worst <= 0 and math.isfinite(err)):
            fail(f"{arch} smoke: decode disagrees with forward "
                 f"(max |diff| {err})")


def lm_serving(smi, peak_gbps):
    """Phase 9: the LM serving path on the card (see the module
    docstring); prints its numbers beside the card's name and power
    limit.  Launches none of the four RST kernels."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rst_contend import (rst_contend_mix_read,
                                                 rst_contend_read)
    from repro_torch.kernels.rst_read import rst_read
    from repro_torch.kernels.rst_write import rst_write
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.models.registry import build
    from repro_torch.serving import ContinuousBatchingEngine, Request

    phase("9. LM serving path on the card: gemma3-1b at full width")
    t_phase = time.perf_counter()
    rst = (rst_read, rst_write, rst_contend_read, rst_contend_mix_read)
    rst_before = [k.launches for k in rst]
    print(f"card: {smi}")
    _tf32_off()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()

    # -- 9a: full width and depth, decode against forward
    cfg = get_config(LM_ARCH)
    model = build(cfg)
    gen = torch.Generator(device=LM_DEVICE).manual_seed(LM_SEED)
    params = init_params(gen, model.param_specs(), torch.float32,
                         device=LM_DEVICE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    param_bytes = _tensor_bytes(params)
    print(f"9a {LM_ARCH}: {cfg.num_layers} layers (global "
          f"{[i for i in range(cfg.num_layers) if cfg.layer_is_global(i)]}),"
          f" d_model {cfg.d_model}, vocab {cfg.vocab_size}: {n_params} "
          f"parameters, {param_bytes} bytes in float32; card={smi}")
    tokens = torch.randint(0, cfg.vocab_size, (2, LM_TOKENS),
                           device=LM_DEVICE, generator=gen)
    full, _ = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if full.shape != (2, LM_TOKENS, cfg.vocab_size) or \
            not bool(torch.isfinite(full).all()):
        fail(f"forward logits {tuple(full.shape)} not finite or misshapen")
    cache, err, worst = lm_decode_against_forward(model, params, tokens,
                                                  full)
    first_global = next(i for i in range(cfg.num_layers)
                        if cfg.layer_is_global(i))
    local = cache["list"][0]["mixer"]
    glob = cache["list"][first_global]["mixer"]
    ring = (local["k"].shape[1], int(local["kv_pos"].min()),
            int(local["kv_pos"].max()))
    print(f"9a {LM_TOKENS} decode_steps (batch 2) == forward over "
          f"{LM_TOKENS} tokens: max |diff| {err:.3e} "
          f"(rtol=atol={LM_DECODE_TOL}); local ring {ring[0]} slots holding "
          f"positions {ring[1]}..{ring[2]} (wrapped); global cache "
          f"{glob['k'].shape[1]} slots > attn_kv_chunk {cfg.attn_kv_chunk}"
          f" (online softmax), forward {LM_TOKENS} <= {cfg.attn_kv_chunk} "
          f"(plain)")
    if worst > 0 or not math.isfinite(err):
        fail(f"full-size decode disagrees with forward (max |diff| {err})")
    window = cfg.attn_window
    if ring != (window, LM_TOKENS - window, LM_TOKENS - 1):
        fail(f"the local layers' ring holds {ring}, not the last {window} "
             f"positions")
    del full, cache

    # -- 9b: the same weights' first layers on the card and on its host
    cfg6 = dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS)
    m6 = build(cfg6)
    p6 = {k: v for k, v in params.items() if k != "layer_list"}
    p6["layer_list"] = params["layer_list"][:LM_CPU_LAYERS]
    tok6 = tokens[:1, :LM_CPU_TOKENS]
    card, _ = m6.forward(p6, {"tokens": tok6})
    t0 = time.perf_counter()
    host, _ = m6.forward(tree_map(lambda t: t.cpu(), p6),
                         {"tokens": tok6.cpu()})
    cpu_s = time.perf_counter() - t0
    diff = (card.cpu() - host).abs().max().item()
    print(f"9b {LM_ARCH} at full width, {LM_CPU_LAYERS} layers (layer "
          f"{first_global} global), {LM_CPU_TOKENS} tokens: card against "
          f"the host CPU max |diff| {diff:.3e} (atol {LM_CPU_ATOL}, logits "
          f"max |x| {host.abs().max().item():.3f}); CPU forward "
          f"{cpu_s:.3f} s")
    if not diff <= LM_CPU_ATOL:
        fail(f"card and CPU logits differ by {diff}")
    del card, host, p6

    # -- timings of the main path's pieces (printed, not gated)
    pre_cache = model.init_cache(batch_size=2, max_seq=LM_MAX_SEQ,
                                 dtype=torch.float32, device=LM_DEVICE)
    batch = {"tokens": tokens}
    model.prefill(params, batch, pre_cache)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    model.prefill(params, batch, pre_cache)
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)
    del pre_cache
    cache = model.init_cache(batch_size=LM_TIMED_BATCH, max_seq=LM_MAX_SEQ,
                             dtype=torch.float32, device=LM_DEVICE)
    cache_bytes = _tensor_bytes(cache)
    feed = tokens[:1, :LM_TIMED_BATCH].reshape(LM_TIMED_BATCH, 1)
    for _ in range(5):
        logits, cache = model.decode_step(params, cache, feed)
    step_ms = []
    for _ in range(LM_TIMED_STEPS):
        start.record()
        logits, cache = model.decode_step(params, cache, feed)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    med = statistics.median(step_ms)
    def decode():
        nonlocal logits, cache
        logits, cache = model.decode_step(params, cache, feed)

    kernels, dev_ms, by_name = profiled(decode, LM_PROFILED_STEPS)
    dev_ms /= LM_PROFILED_STEPS
    logit_bytes = logits.numel() * logits.element_size()
    step_bytes = param_bytes + cache_bytes + logit_bytes
    bound_sheet = step_bytes / PEAK_BYTES_PER_S * 1e3
    bound_meas = step_bytes / (peak_gbps * 1e9) * 1e3
    weights_sheet = param_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"9 prefill (2 x {LM_TOKENS} tokens, {LM_MAX_SEQ}-slot cache): "
          f"{prefill_ms:.3f} ms; card={smi}")
    print(f"9 decode_step at batch {LM_TIMED_BATCH} ({LM_MAX_SEQ}-slot "
          f"cache): median {med:.3f} ms of {LM_TIMED_STEPS} CUDA-event-timed "
          f"steps (range {min(step_ms):.3f}-{max(step_ms):.3f}), "
          f"{LM_TIMED_BATCH / med * 1e3:.1f} tokens/s; card={smi}")
    print(f"9 decode_step on the card per step: "
          f"{kernels / LM_PROFILED_STEPS:.0f} kernels, {dev_ms:.3f} ms "
          f"device time (torch.profiler over {LM_PROFILED_STEPS} steps): "
          f"busy {dev_ms / med * 100:.1f} % of the step's {med:.3f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, us) in top:
        print(f"9   {us / 1e3 / LM_PROFILED_STEPS:.3f} ms/step in "
              f"{n // LM_PROFILED_STEPS} launches/step: {name[:90]}")
    print(f"9 decode_step bytes: {param_bytes} weights + {cache_bytes} cache "
          f"+ {logit_bytes} logits = {step_bytes}; least time "
          f"{bound_sheet:.3f} ms at the data sheet's "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s (weights alone "
          f"{weights_sheet:.3f} ms) and {bound_meas:.3f} ms at phase 6's "
          f"measured {peak_gbps:.1f} GB/s: the step takes "
          f"{bound_sheet / med * 100:.1f} % and {bound_meas / med * 100:.1f}"
          f" % of them ({weights_sheet / med * 100:.1f} % of the weights' "
          f"bound); card={smi}")
    del cache, logits

    # -- 9c: the continuous-batching engine over the full model
    rng = torch.Generator().manual_seed(LM_SEED + 1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in ENGINE_PROMPTS]
    eng = ContinuousBatchingEngine(model, params, slots=ENGINE_SLOTS,
                                   max_seq=LM_MAX_SEQ, eos_id=-1,
                                   device=LM_DEVICE)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=ENGINE_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layout = eng.kv_layout
    print(f"9c engine: {ENGINE_SLOTS} slots, {len(reqs)} requests (prompts "
          f"{min(ENGINE_PROMPTS)}-{max(ENGINE_PROMPTS)} tokens, "
          f"max_new_tokens {ENGINE_MAX_NEW}): {wall:.3f} s wall, "
          f"{stats.engine_steps} engine steps "
          f"({wall / stats.engine_steps * 1e3:.3f} ms each), "
          f"prefill_tokens {stats.prefill_tokens}, decode_tokens "
          f"{stats.decode_tokens}, admitted {stats.admitted}, completed "
          f"{stats.completed}; kv_layout {'/'.join(layout.dims)} "
          f"{layout.sizes}; card={smi}")
    if stats.admitted != len(reqs) or stats.completed != len(reqs) or \
            not all(r.done and len(r.generated) == ENGINE_MAX_NEW
                    for r in reqs):
        fail(f"engine left requests unfinished: {stats}")
    for i in ENGINE_OFFLINE:
        want = lm_offline_greedy(model, params, prompts[i], ENGINE_MAX_NEW)
        print(f"9c request {i} ({len(prompts[i])} prompt tokens): engine "
              f"{reqs[i].generated[:6]}... == offline greedy decode: "
              f"{reqs[i].generated == want}")
        if reqs[i].generated != want:
            fail(f"request {i}: engine {reqs[i].generated} != offline "
                 f"{want}")
    del eng, params

    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    print(f"9 peak device memory: {peak_mem} bytes ({peak_mem / 2**30:.2f} "
          f"GiB, torch.cuda.max_memory_allocated)")

    # -- 9d: every arch at smoke size, and the example on the card
    lm_smoke_archs()
    proc, ex_wall = run_module(["repro_torch.examples.serve_lm"])
    if proc.returncode or "completed 10/10" not in proc.stdout or \
            "on cuda" not in proc.stdout:
        fail(f"serve_lm on the card: rc {proc.returncode}\n{proc.stdout}"
             f"\n{proc.stderr}")
    print(f"9d python -m repro_torch.examples.serve_lm (card): "
          f"{proc.stdout.splitlines()[1]} ({ex_wall:.3f} s wall)")
    if [k.launches for k in rst] != rst_before:
        fail("phase 9 launched an RST kernel")
    print(f"phase 9: {time.perf_counter() - t_phase:.3f} s wall")


# ------------------------------------------------------------ phase 10
# The LM training path on the card: gemma3-1b at full width and depth,
# bf16 compute from float32 master weights, random weights from a seeded
# generator on the card.
TRAIN_BATCH = 4
TRAIN_SEQ = 1024         # > the local layers' 512-token window; <=
#                          attn_kv_chunk (1024): attention's plain path
TRAIN_STEPS = 20         # steps of make_train_step (warmup_cosine 2/20)
TRAIN_PROFILED = 2
TRAIN_SPLIT_ITERS = 3    # timed forward+backward and optim.apply calls
TRAIN_CPU_LAYERS = 6     # full width, 6 layers (layer 5 global)
TRAIN_CPU_TOKENS = 1024  # the first row of the first step's batch
TRAIN_CPU_F32_TOL = 1e-4  # relative error norm of each gradient leaf
TRAIN_CPU_BF16_TOL = 5e-2  # relative error norm over all leaves, bf16
RESTART_RTOL, RESTART_ATOL = 1e-5, 1e-6   # tests/test_system.py
PEAK_BF16_FLOPS = 989.4e12   # H100 SXM dense bf16, data sheet
PEAK_F32_FLOPS = 66.9e12     # H100 SXM FP32 (no tensor cores), data sheet
OPT_BYTES_PER_PARAM = 30     # read f32 grad, master, m, v; write master,
#                              m, v (f32) and the bf16 params


def _relnorm(got, ref):
    """Relative error norm of two lists of tensors (float64 sums)."""
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(got, ref))
    den = sum(float((b.double() ** 2).sum()) for b in ref)
    return math.sqrt(num / den) if den else math.sqrt(num)


def _event_ms(fn, iters):
    """Per-call CUDA-event milliseconds of `iters` calls after one
    warm-up call, each timed on its own (host time included)."""
    import torch

    fn()
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


# Kernel families of a train step, by name, first match wins.
KERNEL_FAMILIES = (
    ("float32 GEMM (SIMT: attention, TF32 off)", ("sgemm", "f32f32")),
    ("bf16 GEMM (tensor cores)", ("gemm", "nvjet", "xmma")),
    ("reductions (softmax, logsumexp, norms, sums)",
     ("reduce", "softmax", "Reduce", "norm")),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise", "Functor")),
)


def kernel_families(by_name, steps):
    """ms per step and launches per step of each KERNEL_FAMILIES entry
    (and "other"), largest first."""
    out = {}
    for name, (n, us) in by_name.items():
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(k in name for k in keys)), "other")
        c, t = out.get(fam, (0, 0.0))
        out[fam] = (c + n, t + us)
    return sorted(((f, t / 1e3 / steps, c / steps)
                   for f, (c, t) in out.items()), key=lambda r: -r[1])


def train_card_vs_cpu(model6, master6, batch):
    """Phase 10a's check: the first step's gradients of the first
    TRAIN_CPU_LAYERS layers at full width on the card and on its host
    CPU, float32 (TF32 off) and bf16."""
    import torch

    from repro_torch.launch.train import step_grads
    from repro_torch.models.common import tree_leaves, tree_map

    host_master = tree_map(lambda t: t.cpu(), master6)
    host_batch = {k: v.cpu() for k, v in batch.items()}
    out = {}
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bf16")):
        lc, gc = step_grads(model6, master6, batch, None, dtype=dtype)
        t0 = time.perf_counter()
        lh, gh = step_grads(model6, host_master, host_batch, None,
                            dtype=dtype)
        cpu_s = time.perf_counter() - t0
        gc = [g.cpu() for g in gc]
        per_leaf = [_relnorm([a], [b]) for a, b in zip(gc, gh)]
        out[name] = (float(lc), float(lh), _relnorm(gc, gh), max(per_leaf),
                     cpu_s)
        del gc, gh
    n = len(tree_leaves(master6))
    return out, n


def smoke_train_archs(dev):
    """Phase 10c: every arch at smoke() size on the card: one
    make_train_step (bf16, AdamW) of each decoder arch, and for all ten
    the float32 loss, gradient and SGD step of
    tests/models/test_archs_smoke.py::test_train_step_no_nans."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.common import (init_params, tree_leaves,
                                           tree_unflatten)
    from repro_torch.models.registry import build

    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        model = build(cfg)
        gen = torch.Generator(device=dev).manual_seed(LM_SEED + 3)
        b, s = 2, 32
        tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                               generator=gen)
        batch = {"tokens": tokens}
        if cfg.is_encdec:
            batch["frames"] = torch.randn(b, cfg.enc_dec.enc_seq,
                                          cfg.d_model, device=dev,
                                          generator=gen)
        if cfg.mrope_sections:
            pos = torch.arange(s, device=dev)[None].expand(b, s)
            batch["mrope_positions"] = pos[None].expand(3, b, s)
        labels = torch.roll(tokens, -1, dims=1)
        params = init_params(gen, model.param_specs(), torch.float32,
                             device=dev)

        def loss_fn(p):
            logits, aux = model.forward(p, batch)
            ll = torch.log_softmax(logits, dim=-1)
            return -torch.gather(ll, -1, labels[..., None]).mean() + aux

        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        loss = float(loss.detach())
        gnorm = float(optim.global_norm(list(grads)))
        with torch.no_grad():
            loss2 = float(loss_fn(tree_unflatten(
                params, [p - 0.1 * g for p, g in zip(leaves, grads)])))
        line = (f"10c {arch}: float32 loss {loss:.4f}, grad norm "
                f"{gnorm:.4f}, after an SGD step (0.1) {loss2:.4f}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)
                and gnorm > 0 and loss2 < loss + 0.5):
            fail(f"{arch} smoke: loss {loss}, grad norm {gnorm}, "
                 f"after SGD {loss2}")
        if not cfg.is_encdec:
            state = init_state(model, cfg, generator=gen, device=dev)
            step = make_train_step(model, cfg, None, optim.AdamWConfig())
            state, met = step(state, {"tokens": tokens, "labels": labels,
                                      **{k: v for k, v in batch.items()
                                         if k != "tokens"}})
            tl, tg = float(met["loss"]), float(met["grad_norm"])
            line += f"; make_train_step (bf16) loss {tl:.4f} grad_norm {tg:.4f}"
            if not (math.isfinite(tl) and math.isfinite(tg) and tg > 0
                    and int(state.step) == 1):
                fail(f"{arch} smoke train step: loss {tl}, grad_norm {tg}")
        print(line)


def restart_exactness(dev, directory):
    """Phase 10b: tests/test_system.py's restart on the card (starcoder2
    smoke): 6 steps against 3, an async save, a restore and 3 more."""
    import torch

    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataLoader
    from repro_torch.launch.train import (abstract_state, init_state,
                                          make_train_step)
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build

    cfg = get_config("starcoder2-7b", smoke=True)
    model = build(cfg)
    step_fn = make_train_step(model, cfg, None, optim.AdamWConfig())
    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=2))

    def run(state, lo, hi):
        for s in range(lo, hi):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(s).items()}
            state, _ = step_fn(state, batch)
        return state

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(5)
        return init_state(model, cfg, generator=gen, device=dev)

    ref = run(fresh(), 0, 6)
    ck = Checkpointer(directory)
    mid = run(fresh(), 0, 3)
    ck.save(2, mid)                 # async: the next step updates in place
    mid = run(mid, 3, 4)
    ck.wait()
    resumed = run(ck.restore(abstract_state(model), device=dev), 3, 6)
    worst, diff = -1.0, 0.0
    for a, b in zip(tree_leaves(ref.master), tree_leaves(resumed.master)):
        d = (b - a).abs()
        diff = max(diff, float(d.max()))
        worst = max(worst, float((d - RESTART_ATOL
                                  - RESTART_RTOL * a.abs()).max()))
    print(f"10b starcoder2-7b smoke: 6 steps == 3 + save + restore + 3 on "
          f"the card: master max |diff| {diff:.3e} (rtol {RESTART_RTOL}, "
          f"atol {RESTART_ATOL}); step {int(resumed.step)}; checkpoints "
          f"{ck.all_steps()}")
    if worst > 0 or int(resumed.step) != 6:
        fail(f"restart does not resume exactly (max |diff| {diff})")


def lm_training(smi, peak_gbps):
    """Phase 10: the LM training path on the card (see the module
    docstring); prints its numbers beside the card's name and power
    limit.  Launches none of the four RST kernels."""
    import dataclasses
    import statistics
    import tempfile

    import torch

    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataLoader
    from repro_torch.kernels.rst_contend import (rst_contend_mix_read,
                                                 rst_contend_read)
    from repro_torch.kernels.rst_read import rst_read
    from repro_torch.kernels.rst_write import rst_write
    from repro_torch.launch.train import (init_state, make_train_step,
                                          step_grads)
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.models.registry import build

    phase("10. LM training path on the card: gemma3-1b at full width")
    t_phase = time.perf_counter()
    rst = (rst_read, rst_write, rst_contend_read, rst_contend_mix_read)
    rst_before = [k.launches for k in rst]
    dev = LM_DEVICE
    print(f"card: {smi}")
    _tf32_off()

    # -- 10a: full width and depth, TRAIN_STEPS steps
    cfg = get_config(LM_ARCH)
    model = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 10)
    state = init_state(model, cfg, generator=gen, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(state.master))
    n_leaves = len(tree_leaves(state.master))
    state_bytes = 3 * _tensor_bytes(state.master)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=LM_SEED))

    def batch_at(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(step).items()}

    print(f"10a {LM_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}: {n_params} parameters in {n_leaves} "
          f"leaves; remat {cfg.remat!r}; batch {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens (window {cfg.attn_window}, attn_kv_chunk "
          f"{cfg.attn_kv_chunk}); state {state_bytes} bytes (master, m, v "
          f"in float32); card={smi}")

    # The first step's gradients, card against host CPU (6 layers).
    first = batch_at(0)
    cfg6 = dataclasses.replace(cfg, num_layers=TRAIN_CPU_LAYERS)
    m6 = build(cfg6)
    master6 = {k: v for k, v in state.master.items() if k != "layer_list"}
    master6["layer_list"] = state.master["layer_list"][:TRAIN_CPU_LAYERS]
    b6 = {k: v[:1, :TRAIN_CPU_TOKENS] for k, v in first.items()}
    checks, n6 = train_card_vs_cpu(m6, master6, b6)
    for name, (lc, lh, rel, worst_leaf, cpu_s) in checks.items():
        print(f"10a first step's gradients, {TRAIN_CPU_LAYERS} layers at full "
              f"width, 1 x {TRAIN_CPU_TOKENS} tokens, {name}: card loss "
              f"{lc:.6f} host CPU {lh:.6f}; relative error norm of the "
              f"{n6} gradient leaves {rel:.3e} (worst leaf {worst_leaf:.3e}); "
              f"CPU {cpu_s:.3f} s")
    f32, bf16 = checks["float32"], checks["bf16"]
    if not (f32[3] <= TRAIN_CPU_F32_TOL and abs(f32[0] - f32[1])
            <= 1e-5 * abs(f32[1])):
        fail(f"float32 gradients card vs CPU: worst leaf {f32[3]} > "
             f"{TRAIN_CPU_F32_TOL}")
    if not (bf16[2] <= TRAIN_CPU_BF16_TOL and abs(bf16[0] - bf16[1])
            <= 1e-2 * abs(bf16[1])):
        fail(f"bf16 gradients card vs CPU: {bf16[2]} > {TRAIN_CPU_BF16_TOL}")
    del master6, b6, m6

    # TRAIN_STEPS steps of the full model.
    sched = functools.partial(optim.warmup_cosine, warmup_steps=2,
                              total_steps=TRAIN_STEPS)
    opt_cfg = optim.AdamWConfig()
    step_fn = make_train_step(model, cfg, None, opt_cfg, lr_schedule=sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_ms = [], [], []
    for s in range(TRAIN_STEPS):
        batch = batch_at(s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, met = step_fn(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    peak_train = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[1:])
    print(f"10a {TRAIN_STEPS} steps of make_train_step (warmup_cosine "
          f"2/{TRAIN_STEPS}): loss {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"10a grad_norm {' '.join(f'{x:.4f}' for x in gnorms)}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        fail(f"the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")

    # The split: forward + backward, and optim.apply, each on its own.
    batch = batch_at(TRAIN_STEPS)
    grads = None

    def fwd_bwd():
        nonlocal grads
        grads = step_grads(model, state.master, batch, None)[1]

    fb_ms = _event_ms(fwd_bwd, TRAIN_SPLIT_ITERS)
    gtree = tree_unflatten(state.master, grads)

    def apply():
        nonlocal state
        _, state, _ = optim.apply(gtree, state, opt_cfg, 0.0)

    opt_ms = _event_ms(apply, TRAIN_SPLIT_ITERS)
    opt_kernels, opt_dev, _ = profiled(apply, 1)
    del grads, gtree
    fb, op = statistics.median(fb_ms), statistics.median(opt_ms)

    def one_step():
        nonlocal state
        state, _ = step_fn(state, batch)

    kernels, dev_ms, by_name = profiled(one_step, TRAIN_PROFILED)
    dev_ms /= TRAIN_PROFILED

    flops = 6 * n_params * tokens
    layers = cfg.num_layers
    attn_fwd = 4 * TRAIN_BATCH * cfg.num_heads * TRAIN_SEQ * TRAIN_SEQ * \
        cfg.head_dim * layers
    attn = 3 * attn_fwd          # forward + backward (2x)
    opt_bytes = OPT_BYTES_PER_PARAM * n_params
    opt_sheet = opt_bytes / PEAK_BYTES_PER_S * 1e3
    opt_meas = opt_bytes / (peak_gbps * 1e9) * 1e3
    print(f"10 train step (gemma3-1b, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"remat {cfg.remat}): median {med:.3f} ms of {TRAIN_STEPS - 1} "
          f"CUDA-event-timed steps (range {min(step_ms[1:]):.3f}-"
          f"{max(step_ms[1:]):.3f}; first {step_ms[0]:.3f}), "
          f"{tokens / med * 1e3:.1f} tokens/s; card={smi}")
    print(f"10 split: forward+backward (cast, lm_loss, autograd, float32 "
          f"grads) median {fb:.3f} ms of {TRAIN_SPLIT_ITERS} "
          f"({' '.join(f'{x:.3f}' for x in fb_ms)}), optim.apply median "
          f"{op:.3f} ms ({' '.join(f'{x:.3f}' for x in opt_ms)}); card={smi}")
    print(f"10 train step on the card: {kernels / TRAIN_PROFILED:.0f} "
          f"kernels, {dev_ms:.3f} ms device time (torch.profiler over "
          f"{TRAIN_PROFILED} steps): busy {dev_ms / med * 100:.1f} % of the "
          f"step's {med:.3f} ms")
    print(f"10 optim.apply on the card: {opt_kernels} kernels, "
          f"{opt_dev:.3f} ms device time (torch.profiler, one call): busy "
          f"{opt_dev / op * 100:.1f} % of its {op:.3f} ms")
    for fam, ms, n in kernel_families(by_name, TRAIN_PROFILED):
        print(f"10   {ms:.3f} ms/step ({ms / dev_ms * 100:.1f} % of the "
              f"device time) in {n:.0f} launches/step: {fam}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        print(f"10   {us / 1e3 / TRAIN_PROFILED:.3f} ms/step in "
              f"{n // TRAIN_PROFILED} launches/step: {name[:90]}")
    print(f"10 model FLOPs 6 N T = 6 x {n_params} x {tokens} = {flops:.4e}: "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at the data sheet's "
          f"{PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s bf16 dense; the step reaches "
          f"{flops / (med / 1e3) / 1e12:.2f} TFLOP/s, MFU "
          f"{flops / (med / 1e3) / PEAK_BF16_FLOPS * 100:.2f} %; attention "
          f"(float32, plain path, not in 6 N T) {attn:.4e} FLOP forward + "
          f"backward ({attn / PEAK_F32_FLOPS * 1e3:.3f} ms at "
          f"{PEAK_F32_FLOPS / 1e12:.1f} TFLOP/s FP32); card={smi}")
    print(f"10 optim.apply bytes: {OPT_BYTES_PER_PARAM} B x {n_params} = "
          f"{opt_bytes} (read float32 grad, master, m, v; write master, "
          f"m, v, bf16 params): least time {opt_sheet:.3f} ms at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s and {opt_meas:.3f} ms at "
          f"phase 6's measured {peak_gbps:.1f} GB/s; apply takes {op:.3f} "
          f"ms, {opt_sheet / op * 100:.1f} % and {opt_meas / op * 100:.1f} "
          f"% of them; card={smi}")

    # Peak memory of one step with each remat setting.
    peaks = {}
    for policy in ("none", "save_boundaries", "full", "dots"):
        pm = build(dataclasses.replace(cfg, remat=policy))
        fn = make_train_step(pm, cfg, None, opt_cfg, lr_schedule=sched)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state, met = fn(state, batch)
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated()
        print(f"10 peak device memory of a step, remat {policy!r}: "
              f"{peaks[policy]} bytes ({peaks[policy] / 2**30:.2f} GiB; "
              f"{(peaks[policy] - base) / 2**30:.2f} GiB above the "
              f"{base / 2**30:.2f} GiB held before it); loss "
              f"{float(met['loss']):.4f}; card={smi}")
    print(f"10 peak device memory over the {TRAIN_STEPS} steps: {peak_train} "
          f"bytes ({peak_train / 2**30:.2f} GiB); state {state_bytes} bytes "
          f"+ bf16 params {n_params * 2} + float32 grads {n_params * 4}; "
          f"float32 logits {TRAIN_BATCH * TRAIN_SEQ * cfg.vocab_size * 4}")
    if not peaks["none"] > peaks["save_boundaries"]:
        fail(f"remat 'none' peak {peaks['none']} is not above "
             f"'save_boundaries' {peaks['save_boundaries']}")
    del state

    # -- 10b, 10c, 10d
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        restart_exactness(dev, d)
    smoke_train_archs(dev)
    proc, ex_wall = run_module(["repro_torch.examples.train_lm",
                                "--with-failure"])
    out = proc.stdout
    done = [ln for ln in out.splitlines() if ln.startswith(("done:",
                                                            "loss "))]
    if "1 failures" not in out or "restored checkpoint @" not in out or \
            "(improved)" not in out or "on cuda" not in out:
        fail(f"train_lm on the card: \n{out}\n{proc.stderr}")
    print(f"10d python -m repro_torch.examples.train_lm --with-failure "
          f"(card): {'; '.join(done)} ({ex_wall:.3f} s wall)")
    if [k.launches for k in rst] != rst_before:
        fail("phase 10 launched an RST kernel")
    print(f"phase 10: {time.perf_counter() - t_phase:.3f} s wall")


# Phase 11: the launch layer, the dry run and the quickstart.
SERVE_PREFILL = 600      # 2 x 600 prompt tokens into a 2048-slot cache
SERVE_STEPS = 64         # decode steps after the prefill
SERVE_TOL = 1.5e-5       # rtol = atol: phase 9's decode against forward
CARD_TRAIN = (4, 1024)   # phase 10's batch: (sequences, tokens each)
CARD_DECODE = (4, 2048)  # phase 9's timed batch, a 2048-slot cache
# The band PERF.md §6 predicts for the predicted peak over
# torch.cuda.max_memory_allocated(); 11b prints a ratio outside it so,
# 11e fails on one.  A prefill takes the serving band, a decode step's:
# it holds no gradients or optimizer state, and what the trace cannot
# see is the same, the caching allocator's rounding and the kernels'
# workspaces beside activations of a few GiB.
PEAK_BAND = {"train": (0.9, 1.1), "decode": (0.8, 1.25),
             "prefill": (0.8, 1.25)}
# 11e: cells run as rank 0 of the 16 x 16 mesh on the card: whisper's
# decode holds its 1500 encoder frames (which 16 does not divide),
# qwen2-moe's train step routes its groups split over the data axis, and
# gemma3's long_500k decode is traced by the shortcut over its local and
# global layers (one period of the pattern and two, in the model's
# order) while the card runs all 26 layers.  starcoder2's train step and
# nemotron's prefill hold GQA attention whose heads the model axis leaves
# whole (starcoder2, 36 heads over 4 KV heads, under sequence
# parallelism) or cuts across KV groups (nemotron, 48 over 8, 3 a
# rank): each rank attends its rows of queries over every head
# (`models.attention._attention_split_rows`).  rwkv6's long_500k is a
# one-token step whose products' partial sums are all-reduced at once
# (`models.common.project`), its weights kept split.  hymba's prefill
# runs its 32 layers' Mamba scans of 2048 chunks each, counted on the
# host and on the card alike (`dryrun._Trace.scan`: a few chunks run,
# the others stand in with the tensors a run chunk leaves), each chunk's
# products on the rank's own rows and channels (no collective in a
# chunk), and unembeds only the last position.
RANK0_CELLS = (("gemma3-1b", "train_4k"), ("gemma3-1b", "decode_32k"),
               ("mistral-large-123b", "decode_32k"),
               ("whisper-small", "decode_32k"),
               ("qwen2-moe-a2.7b", "train_4k"),
               ("gemma3-1b", "long_500k"),
               ("deepseek-v2-lite-16b", "prefill_32k"),
               ("starcoder2-7b", "train_4k"),
               ("nemotron-4-15b", "prefill_32k"),
               ("rwkv6-7b", "long_500k"),
               ("hymba-1.5b", "prefill_32k"),
               ("rwkv6-7b", "train_4k"))
# 11e: cells run as rank 0 of the multi-pod 2 x 16 x 16 mesh ("pod",
# "data", "model"), where the batch is split over pod x data: a train
# step whose gradients are reduced over both (starcoder2) and one whose
# MoE routing groups are split over both (qwen2-moe).  Held a step.
RANK0_MULTI_CELLS = (("starcoder2-7b", "train_4k"),
                     ("qwen2-moe-a2.7b", "train_4k"))
# 11e: the cells whose all-gather is held a step against XLA's step as
# it runs (`executed_collectives` in tests/test_torch_dryrun_ref.py),
# though their layers are scanned: for rwkv6's one-token step XLA's HLO
# gathers the 32 layers' shift states outside its loop, which no count
# of layers divides; its train step, whose WKV chunk scans the trace
# counts (`dryrun._Trace.scan`), likewise.
STEP_CELLS = (("rwkv6-7b", "long_500k"), ("rwkv6-7b", "train_4k"))
# 11e: the cells traced by the shortcut whatever their operation count
# (gemma3's long_500k would trace whole: the first shortcut over two
# layer kinds held against the card; deepseek's prefill takes it by its
# count).
SHORTCUT_CELLS = (("gemma3-1b", "long_500k"),)
# 11e: the reference's all-gather bytes for those cells, from XLA's
# compiled HLO (`repro.launch.dryrun.lower_cell` on 16x16, 512 CPU
# placeholder devices, jax 0.9.0; PERF.md §6).  XLA's HLO holds a
# loop's body once: gemma3's train_4k figure is one microbatch (and the
# update), mistral's and whisper's one of their scanned layers (with
# what is outside the loop: whisper's includes its 9.96 MB gather of
# the embedding for the logits); gemma3's decode has no loop.  The
# port's traced all-gather, divided likewise, may exceed it by
# GATHER_OVER_REF at most.  qwen2-moe's figure is one layer of one
# microbatch; its batched products keep batch and heads split
# (`models.common.contract`) and move between split dimensions by
# all-to-all, as XLA's do (before, 7.57 x XLA's).  gemma3's long_500k
# figure is its whole step (no loop; `lower_cell("gemma3-1b",
# "long_500k", False)`, the same jax and devices).  deepseek's prefill
# figure is XLA's step as it runs (`executed_collectives` in
# tests/test_torch_dryrun_ref.py: each all-gather of the HLO times the
# trips of the loops around it: the HLO holds the dense layer 0 beside
# the scanned body of the 26 MoE layers, whose all-gathers run 26 times;
# each counted once, 1,590,329,344): held a step.  starcoder2's
# train_4k figure is one layer of one microbatch (its HLO's scanned
# body, with the update), nemotron's prefill one of its scanned layers,
# rwkv6's long_500k XLA's step as it runs (its 32 layers' shift states,
# 1 MB, gathered outside the loop), hymba's prefill XLA's step as it runs
# (its layers unscanned, each Mamba scan a loop of 2048 trips), rwkv6's
# train_4k XLA's step as it runs (its microbatch and layer loops).
REF_ALL_GATHER = {("gemma3-1b", "train_4k"): 9_137_831_936,
                  ("gemma3-1b", "decode_32k"): 2_508_893_696,
                  ("mistral-large-123b", "decode_32k"): 2_589_298_688,
                  ("whisper-small", "decode_32k"): 11_434_496,
                  ("qwen2-moe-a2.7b", "train_4k"): 1_061_584_896,
                  ("gemma3-1b", "long_500k"): 4_297_188_864,
                  ("deepseek-v2-lite-16b", "prefill_32k"): 25_697_746_944,
                  ("starcoder2-7b", "train_4k"): 3_013_558_272,
                  ("nemotron-4-15b", "prefill_32k"): 642_777_088,
                  ("rwkv6-7b", "long_500k"): 1_589_248,
                  ("hymba-1.5b", "prefill_32k"): 77_880_367_360,
                  ("rwkv6-7b", "train_4k"): 547_692_609_536}
# 11e: the same for RANK0_MULTI_CELLS, XLA's step as it runs on the
# 2x16x16 mesh (`lower_cell(arch, shape, True)`, the same jax and
# devices; `python tests/test_torch_dryrun_ref.py --all --mesh multi`).
REF_ALL_GATHER_MULTI = {("starcoder2-7b", "train_4k"): 343_175_020_544,
                        ("qwen2-moe-a2.7b", "train_4k"): 89_073_942_528}
GATHER_OVER_REF = 1.25
# 11e: traced all-gather bytes a whole step that the card's host must
# reproduce within HOST_AGREE, as this figure was traced on another
# host and torch (`lower_cell(arch, shape, False)`, torch 2.13 on the
# CPU): qwen2-moe's routing's backward scatters its sorted gate values
# split on the routing groups on either torch
# (`dryrun._scatter_strategy`; torch 2.11's own scatter gathered them,
# 85,706,145,792 B); hymba's fused heads' norms cut their input to the
# scale's split on either torch (`models.common.cut_as`; torch 2.11 had
# gathered the scale, and the output of `fuse_out`, 7,374,032,000 B).
HOST_ALL_GATHER = {("qwen2-moe-a2.7b", "train_4k"): 67_586_752_512,
                   ("hymba-1.5b", "prefill_32k"): 498_896_000}
# 11e: the same for RANK0_MULTI_CELLS on 2x16x16 (`lower_cell(arch,
# shape, True)`, torch 2.13 on the CPU): the first 3-axis mesh the
# card's torch traces.
HOST_ALL_GATHER_MULTI = {("starcoder2-7b", "train_4k"): 89_766_494_208,
                         ("qwen2-moe-a2.7b", "train_4k"): 33_944_764_416}
HOST_AGREE = 0.01
# 11c: the 16x16 cells whose partitioned trace once failed (the MoE
# dispatch over split groups, rwkv6's views of split dimensions,
# whisper's 1500 frames), traced in a child on the host's cores from
# phase 9 on; each must read OK.
REPAIRED_CELLS = (("qwen2-moe-a2.7b", "train_4k"),
                  ("qwen2-moe-a2.7b", "prefill_32k"),
                  ("deepseek-v2-lite-16b", "train_4k"),
                  ("deepseek-v2-lite-16b", "prefill_32k"),
                  ("rwkv6-7b", "train_4k"), ("rwkv6-7b", "long_500k"),
                  ("whisper-small", "train_4k"),
                  ("whisper-small", "prefill_32k"),
                  ("whisper-small", "decode_32k"))
REPAIRED_CHILD = (
    "import json\n"
    "from repro_torch.launch import dryrun\n"
    f"cells = {REPAIRED_CELLS!r}\n"
    "rs = [r for a, s in cells\n"
    "      for r in dryrun.run_cells([a], [s], [False], None)]\n"
    "n = [sum(r['status'] == k for r in rs)\n"
    "     for k in ('OK', 'LOWERED', 'SKIP', 'FAIL')]\n"
    "print(f'== dry-run: {n[0]} OK, {n[1]} LOWERED, {n[2]} SKIP, '\n"
    "      f'{n[3]} FAIL of {len(rs)} cells ==')\n"
    "print(json.dumps({f\"{r['arch']}|{r['shape']}|{r['mesh']}\": r\n"
    "                  for r in rs if r['status'] == 'OK'}))\n")
# 11e: the host traces of its cells, made in a child on the host's
# cores from phase 9 on (RANK0_CHILD), beside the card's phases, so
# that 11e runs the cells on the card and holds the child's records:
# every cell but those 11c's child traces (11e takes their records
# from that child) and those 11e traces by the shortcut.  Records are
# keyed "arch|shape|mesh", as 11c's child keys its own.
RANK0_TRACED = (*((a, s, False) for a, s in RANK0_CELLS
                  if (a, s) not in REPAIRED_CELLS + SHORTCUT_CELLS),
                *((a, s, True) for a, s in RANK0_MULTI_CELLS))
RANK0_CHILD = (
    "import json\n"
    "from repro_torch.launch import dryrun\n"
    f"rs = [dryrun.lower_cell(a, s, m) for a, s, m in {RANK0_TRACED!r}]\n"
    "print(json.dumps({f\"{r['arch']}|{r['shape']}|{r['mesh']}\": r\n"
    "                  for r in rs}))\n")
DRYRUN_OUT = os.path.join("build", "dryrun")
DRYRUN_SUMMARY = re.compile(r"== dry-run: (\d+) OK, (\d+) LOWERED, "
                            r"(\d+) SKIP, (\d+) FAIL of (\d+) cells ==")
NO_CARD_CHILD = (
    "import torch\n"
    "from repro_torch.launch import dryrun\n"
    "r = dryrun.run_cells(['gemma3-1b'], ['decode_32k'], [False], None)\n"
    "print(r[0]['status'], torch.cuda.is_initialized())\n")


def _start(args):
    """`python -m <args>` (or `python -c` with args[0] == "-c") started
    from the checkout's root in the background; a thread collects its
    output and the time it ends."""
    import threading

    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable] + (list(args) if args[0] == "-c"
                              else ["-m", *args])
    job = {"t0": time.perf_counter(),
           "proc": subprocess.Popen(cmd, cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)}

    def wait():
        job["out"], job["err"] = job["proc"].communicate()
        job["t1"] = time.perf_counter()

    job["thread"] = threading.Thread(target=wait, daemon=True)
    job["thread"].start()
    # A failing phase exits before the job is waited for: stop it then.
    atexit.register(lambda: job["proc"].poll() is None
                    and job["proc"].kill())
    return job


def _finish(job, what, timeout=600):
    """The output and wall seconds of a process `_start` began; fails
    unless it exits 0 within `timeout` seconds of now."""
    job["thread"].join(timeout)
    if job["thread"].is_alive():
        job["proc"].kill()
        job["thread"].join()
        fail(f"{what} did not finish in time")
    if job["proc"].returncode != 0:
        fail(f"{what} exited {job['proc'].returncode}:\n"
             f"{job['out'][-4000:]}{job['err'][-4000:]}")
    return job["out"], job["t1"] - job["t0"]


def serve_steps(smi):
    """Phase 11a: launch/serve.py's steps at full width on the card."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.registry import build

    dev = LM_DEVICE
    cfg = get_config(LM_ARCH)
    model = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 11)
    params = init_params(gen, model.param_specs(), torch.float32, device=dev)
    n = SERVE_PREFILL + SERVE_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (2, n), device=dev,
                           generator=gen)
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(batch_size=2, max_seq=LM_MAX_SEQ,
                             dtype=torch.float32, device=dev)

    def leaf(x):
        return x if isinstance(x, int) else (tuple(x.shape), x.dtype)

    abstract = serve.abstract_cache(model, 2, LM_MAX_SEQ, torch.float32)
    if [leaf(x) for x in tree_leaves(abstract)] != \
            [leaf(x) for x in tree_leaves(cache)]:
        fail("abstract_cache's shapes and dtypes differ from init_cache's")
    prefill = serve.make_prefill_step(model)
    decode = serve.make_decode_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill(params, {"tokens": tokens[:, :SERVE_PREFILL]}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    err, worst = _within(lg, full[:, SERVE_PREFILL - 1], SERVE_TOL)
    errs, worsts, step_ms = [err], [worst], []
    for t in range(SERVE_PREFILL, n):
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, tokens[:, t:t + 1])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        e, w = _within(lg, full[:, t], SERVE_TOL)
        errs.append(e)
        worsts.append(w)
    err = max(e.item() for e in errs)
    if not (max(w.item() for w in worsts) <= 0 and math.isfinite(err)):
        fail(f"serve steps disagree with the forward: max |diff| {err}")
    print(f"11a {LM_ARCH} (float32) make_prefill_step over 2 x "
          f"{SERVE_PREFILL} tokens into a {LM_MAX_SEQ}-slot cache, then "
          f"{SERVE_STEPS} make_decode_step steps: logits == forward, max "
          f"|diff| {err:.3e} (rtol=atol={SERVE_TOL}); abstract_cache == "
          f"init_cache ({len(tree_leaves(cache))} leaves); prefill "
          f"{prefill_ms:.3f} ms, decode step median "
          f"{statistics.median(step_ms):.3f} ms (range {min(step_ms):.3f}-"
          f"{max(step_ms):.3f}, host clock after synchronize); card={smi}")
    del full, params, cache

    wcfg = get_config("whisper-small", smoke=True)
    wm = build(wcfg)
    wp = init_params(gen, wm.param_specs(), torch.float32, device=dev)
    batch = {"tokens": torch.randint(0, wcfg.vocab_size, (2, 8), device=dev,
                                     generator=gen),
             "frames": torch.randn(2, wcfg.enc_dec.enc_seq, wcfg.d_model,
                                   device=dev, generator=gen)}
    ref, _ = wm.forward(wp, batch)
    wcache = wm.init_cache(batch_size=2, max_seq=16, dtype=torch.float32,
                           device=dev)
    lg, wcache = serve.make_prefill_step(wm)(wp, batch, wcache)
    e, w = _within(lg, ref[:, -1], SERVE_TOL)
    if not w.item() <= 0:
        fail(f"whisper prefill != its forward's last logits ({e.item()})")
    print(f"11a whisper-small smoke: the enc-dec prefill (start_cache, "
          f"forward) == the forward's last logits, max |diff| "
          f"{e.item():.3e}")


def dryrun_against_card(smi):
    """Phase 11b: the dry run's accounting on a 1 x 1 mesh against the
    same steps on the card."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.common import init_params, param_count
    from repro_torch.models.registry import build

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_config(LM_ARCH)
    model = build(cfg)
    dev = LM_DEVICE
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 12)
    b, s = CARD_TRAIN
    train_rec = dryrun.lower(cfg, ShapeSpec("card_train", s, b, "train"),
                             mesh)
    if train_rec["n_micro"] != 1:
        fail(f"card train cell: n_micro {train_rec['n_micro']} != 1")

    def train_step():
        state = init_state(model, cfg, generator=gen, device=dev)
        batch = {k: torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                  generator=gen, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = make_train_step(model, cfg, None, optim.AdamWConfig())
        return (state, batch), lambda: step(state, batch)

    held_train, peak_train = _card_peak(train_step)
    b, s = CARD_DECODE
    decode_rec = dryrun.lower(cfg, ShapeSpec("card_decode", s, b, "decode"),
                              mesh)

    def decode_step():
        params = init_params(gen, model.param_specs(), torch.bfloat16,
                             device=dev)
        cache = model.init_cache(batch_size=b, max_seq=s,
                                 dtype=torch.bfloat16, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (b, 1), device=dev,
                               generator=gen, dtype=torch.int32)
        step = serve.make_decode_step(model)

        def run():
            with torch.no_grad():
                return step(params, cache, tokens)
        return (params, cache, tokens), run

    held_decode, peak_decode = _card_peak(decode_step)
    n_params = param_count(model.param_specs())
    for kind, rec, held, peak in (
            ("train", train_rec, held_train, peak_train),
            ("decode", decode_rec, held_decode, peak_decode)):
        mem = rec["memory"]
        if rec["trace_scope"] != "device":
            fail(f"{kind}: the trace on a 1 x 1 mesh is not the device's "
                 f"own step ({rec['trace_scope']})")
        if mem["argument_bytes"] != held:
            fail(f"{kind}: predicted argument bytes {mem['argument_bytes']} "
                 f"!= the {held} bytes of the tensors the card holds")
        predicted = (mem["argument_bytes"] + mem["output_bytes"]
                     + mem["temp_bytes"] - mem["alias_bytes"])
        lo, hi = PEAK_BAND[kind]
        ratio = predicted / peak
        print(f"11b {kind} ({LM_ARCH}, {rec['trace_mode']} trace in "
              f"{rec['compile_s']} s): argument bytes predicted "
              f"{mem['argument_bytes']} == held on the card {held}; peak "
              f"predicted {predicted} bytes ({predicted / 2**30:.3f} GiB: "
              f"temp {mem['temp_bytes']}, output {mem['output_bytes']}, "
              f"alias {mem['alias_bytes']}) against "
              f"torch.cuda.max_memory_allocated() {peak} bytes "
              f"({peak / 2**30:.3f} GiB): ratio {ratio:.4f}, "
              f"{'inside' if lo <= ratio <= hi else 'OUTSIDE'} the band "
              f"{lo}-{hi}; card={smi}")
    flops = train_rec["cost"]["flops"]
    six_nt = 6 * n_params * CARD_TRAIN[0] * CARD_TRAIN[1]
    print(f"11b traced train-step FLOPs {flops:.4e} against 6 N T = 6 x "
          f"{n_params} x {CARD_TRAIN[0] * CARD_TRAIN[1]} = {six_nt:.4e}: "
          f"ratio {flops / six_nt:.4f} (attention, the loss and AdamW are "
          f"outside 6 N T; remat_dup {train_rec['remat_dup']}); "
          f"bytes_accessed {train_rec['cost']['bytes_accessed']:.4e}")


def _card_peak(make):
    """(bytes of the tensors `make` allocates, peak device bytes above
    what was allocated before them while its step runs)."""
    import torch

    from repro_torch.models.common import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args, run = make()
    held = sum(t.numel() * t.element_size() for t in tree_leaves(args)
               if isinstance(t, torch.Tensor))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del args, run, out
    torch.cuda.empty_cache()
    return held, peak


def rank0_on_card(smi, child=None, repaired=None):
    """Phase 11e: the dry run's partitioned trace of a production cell
    against the same partitioned step run on the card as rank 0.
    `child`, if given, is the process started with RANK0_CHILD, whose
    records of RANK0_TRACED the cells take, and `repaired` the one
    started with REPAIRED_CHILD, whose records the cells it traced take
    (any other cell is traced here)."""
    import json

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES

    t_cells = time.perf_counter()
    jobs = [(job, what, cells) for job, what, cells in (
        (repaired, "11c's traces of the repaired cells",
         [(a, s, False) for a, s in REPAIRED_CELLS]),
        (child, f"11e's traces of {RANK0_TRACED}", RANK0_TRACED))
        if job is not None]
    records = {}
    cells = ([(a, s, False) for a, s in RANK0_CELLS]
             + [(a, s, True) for a, s in RANK0_MULTI_CELLS])
    for arch, shape_name, multi_pod in cells:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        mesh = make_production_mesh(multi_pod=multi_pod)
        name = "2x16x16" if multi_pod else "16x16"
        key = f"{arch}|{shape_name}|{name}"
        t0 = time.perf_counter()
        for job, what, traced in jobs:
            if (arch, shape_name, multi_pod) in traced and \
                    key not in records:
                out, wall = _finish(job, what)
                records.update(json.loads(out.strip().splitlines()[-1]))
                print(f"11e {what} ended {wall:.3f} s after they started "
                      f"(phase 9)")
        if key in records:
            rec = records[key]
            host_s = rec["lower_s"] + rec["compile_s"]
        else:
            rec = dryrun.lower(cfg, shape, mesh, shortcut=(
                True if (arch, shape_name) in SHORTCUT_CELLS else None))
            host_s = time.perf_counter() - t0
        if rec.get("status") != "OK" or not rec["partitioned"] or \
                rec["trace_scope"] != "device":
            fail(f"11e {arch} {shape_name} ({name}): the dry run's record "
                 f"is not a partitioned device trace: {rec}")
        held = {}

        def before(local):
            torch.cuda.synchronize()
            held["bytes"] = sum(t.numel() * t.element_size() for t in local)
            torch.cuda.reset_peak_memory_stats()

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        dryrun.run_on_rank(cfg, shape, mesh, LM_DEVICE, before_step=before)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.empty_cache()
        mem = rec["memory"]
        if mem["argument_bytes"] != held["bytes"]:
            fail(f"11e {arch} {shape_name} ({name}): predicted argument "
                 f"bytes {mem['argument_bytes']} != the {held['bytes']} "
                 f"bytes of the local tensors rank 0 holds on the card")
        predicted = (mem["argument_bytes"] + mem["output_bytes"]
                     + mem["temp_bytes"] - mem["alias_bytes"])
        lo, hi = PEAK_BAND[shape.kind]
        ratio = predicted / peak
        if not lo <= ratio <= hi:
            fail(f"11e {arch} {shape_name} ({name}): predicted peak "
                 f"{predicted} over max_memory_allocated() {peak} = "
                 f"{ratio:.4f}, outside {lo}-{hi}")
        traced, implied = rec["collectives_traced"], rec["collectives"]
        scanned = cfg.scan_layers and not cfg.moe_dense_layers
        per, unit = ((1, "step")
                     if multi_pod or (arch, shape_name) in STEP_CELLS
                     else (rec["n_micro"] * cfg.num_layers,
                           "layer of a microbatch")
                     if shape.kind == "train" and scanned
                     else (rec["n_micro"], "microbatch")
                     if shape.kind == "train"
                     else (cfg.num_layers, "layer") if scanned
                     else (1, "step"))
        gather = traced.get("all-gather", 0.0) / per
        ref = (REF_ALL_GATHER_MULTI if multi_pod
               else REF_ALL_GATHER)[arch, shape_name]
        if gather > GATHER_OVER_REF * ref:
            fail(f"11e {arch} {shape_name} ({name}): traced all-gather "
                 f"{gather:.0f} bytes a {unit}, above {GATHER_OVER_REF} x the "
                 f"reference's {ref:.0f}")
        host = (HOST_ALL_GATHER_MULTI if multi_pod
                else HOST_ALL_GATHER).get((arch, shape_name))
        if host is not None and abs(traced.get("all-gather", 0.0) / host
                                    - 1) > HOST_AGREE:
            fail(f"11e {arch} {shape_name} ({name}): traced all-gather "
                 f"{traced.get('all-gather', 0.0):.0f} bytes a step on this "
                 f"host's torch {torch.__version__}, not within "
                 f"{HOST_AGREE:.0%} of the {host} bytes traced on torch 2.13")
        print(f"11e {arch} {shape_name}, rank 0 of {name} "
              f"({rec['trace_mode']} partitioned trace, "
              f"{rec.get('n_micro', 1)} microbatch(es) on the host, one on "
              f"the card): argument bytes predicted "
              f"{mem['argument_bytes']} == held on the card "
              f"{held['bytes']}; peak predicted {predicted} bytes "
              f"({predicted / 2**30:.3f} GiB: temp {mem['temp_bytes']}, "
              f"output {mem['output_bytes']}, alias {mem['alias_bytes']}) "
              f"against torch.cuda.max_memory_allocated() {peak} bytes "
              f"({peak / 2**30:.3f} GiB): ratio {ratio:.4f}, inside "
              f"{lo}-{hi}; flops {rec['cost']['flops']:.4e}, "
              f"bytes_accessed {rec['cost']['bytes_accessed']:.4e}; "
              f"collectives_traced total {traced['total']:.4e} "
              f"({ {k: v for k, v in traced.items() if k != 'total'} }) "
              f"beside collectives total {implied['total']:.4e} "
              f"({ {k: v for k, v in implied.items() if k != 'total'} }); "
              f"traced all-gather {gather:.0f} bytes a {unit}, "
              f"{gather / ref:.4f} x the reference's XLA program's "
              f"{ref:.0f} (limit {GATHER_OVER_REF}), "
              f"all-to-all {traced.get('all-to-all', 0.0) / per:.0f} "
              f"bytes a {unit}; scan trips counted "
              f"{rec['scan_trips_counted']} (their collectives "
              f"{rec['scan_collectives']}); "
              f"host {host_s:.3f} s to trace, {run_s:.3f} s to run on the "
              f"card; card={smi}")
    print(f"11e: {len(cells)} cells in "
          f"{time.perf_counter() - t_cells:.3f} s wall")


def quickstart_on_card(smi):
    """Phase 11d: the quickstart's entry point on the card, rst_read's
    launches counted; its checksum against the plain version's on the
    host.  Returns the launches."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core import RSTParams
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_read import rst_read

    out = io.StringIO()
    argv = [] if LM_DEVICE == "cuda" else ["--device", LM_DEVICE]
    t0 = time.perf_counter()
    rst_read.launches = 0
    with contextlib.redirect_stdout(out):
        sample = quickstart.main(argv)
    launches = rst_read.launches
    wall = time.perf_counter() - t0
    text = out.getvalue()
    if launches <= 0:
        fail("the quickstart launched rst_read no time")
    engine = "CUDA kernel" if LM_DEVICE == "cuda" else "plain PyTorch"
    if not text.rstrip().endswith("quickstart OK") or \
            f"({engine} on {LM_DEVICE})" not in text or \
            f"finite=True on {LM_DEVICE}" not in text:
        fail(f"quickstart on the card:\n{text}")
    tile = ops.tile_bytes(torch.float32)
    p = RSTParams(n=64, b=tile, s=tile, w=64 * tile)
    host = ops.measure_read_bandwidth(p, device="cpu")
    got = float(sample.checksum[0, 0])
    # Every lane against the plain version, at phase 3's f32 tolerance.
    if sample.checksum.shape != host.checksum.shape:
        fail(f"quickstart checksum shape {sample.checksum.shape} != the "
             f"plain version's {host.checksum.shape}")
    diff = np.abs(sample.checksum.astype(np.float64)
                  - host.checksum.astype(np.float64))
    if not (diff <= 1e-4 + 1e-5 * np.abs(host.checksum)).all():
        fail(f"quickstart checksum differs from the plain version's on the "
             f"host: max |diff| {diff.max():.3e} (rtol 1e-5, atol 1e-4)")
    if got != float(host.checksum[0, 0]):
        fail(f"quickstart checksum[0,0] {got} != the plain version's "
             f"{float(host.checksum[0, 0])} on the host")
    operand = ops.params_operand(p, torch.float32, TILE_ROWS)
    buf = ops.make_working_buffer(p, torch.float32, device=LM_DEVICE)
    ms = cuda_ms(lambda: rst_read(operand, buf, grid_txns=p.n), 50)
    bound = (p.n * p.b + p.b) / PEAK_BYTES_PER_S * 1e3
    for line in text.splitlines():
        if line.startswith(("HBM idle", "Aggregate", "sequential",
                            "contiguous", "best KV", "gemma3")):
            print(f"11d   {line}")
    print(f"11d python -m repro_torch.examples.quickstart (its main, "
          f"in-process) on the card: rst_read launched {launches} times; "
          f"checksum {sample.checksum.shape} against the plain version's "
          f"on the host: max |diff| {diff.max():.3e} (rtol 1e-5, atol "
          f"1e-4), checksum[0,0] {got} equal; its "
          f"shape (n = {p.n}, B = S = {p.b}, W = {p.w}) takes "
          f"{ms:.5f} ms a call against a {bound:.6f} ms bytes bound "
          f"(launch-bound); {wall:.3f} s wall; card={smi}")
    return launches


def launch_layer(smi, repaired, rank0=None):
    """Phase 11: the launch layer, the dry run and the analytic report,
    and the quickstart (see the module docstring); `repaired` is the
    child tracing REPAIRED_CELLS, `rank0` the one tracing RANK0_TRACED,
    both started before phase 9.  Returns the quickstart's rst_read
    launches."""
    phase("11. launch layer, dry run and quickstart")
    t_phase = time.perf_counter()
    print(f"card: {smi}")
    _tf32_off()
    shutil.rmtree(os.path.join(ROOT, DRYRUN_OUT), ignore_errors=True)
    # (c) runs on the host's cores while (a), (b) and (e) use the card.
    cells = _start(["repro_torch.launch.dryrun", "--arch", LM_ARCH,
                    "--mesh", "both", "--out-dir", DRYRUN_OUT])
    lowered = _start(["repro_torch.launch.dryrun", "--all", "--mesh",
                      "both", "--no-compile"])
    no_card = _start(["-c", NO_CARD_CHILD])

    serve_steps(smi)
    dryrun_against_card(smi)
    rank0_on_card(smi, rank0, repaired)

    for started, what, want in (
            (cells, f"dryrun --arch {LM_ARCH} --mesh both", (8, 0, 0, 0, 8)),
            (lowered, "dryrun --all --mesh both --no-compile",
             (0, 66, 14, 0, 80)),
            (repaired, f"dryrun of the {len(REPAIRED_CELLS)} repaired "
             f"cells (16x16)",
             (len(REPAIRED_CELLS), 0, 0, 0, len(REPAIRED_CELLS)))):
        out, wall = _finish(started, what)
        m = DRYRUN_SUMMARY.search(out)
        if not m or tuple(map(int, m.groups())) != want:
            fail(f"{what}: want OK/LOWERED/SKIP/FAIL/cells {want}:\n{out}")
        for line in out.splitlines():
            if line.startswith("[OK"):
                print(f"11c   {line}")
        where = ("from phase 9 on, beside phases 9-11" if started is repaired
                 else "beside 11a-b, 11e")
        print(f"11c python -m repro_torch.launch.{what}: {m.group(0)} "
              f"({wall:.3f} s wall, on the host's CPU {where})")
    out, wall = _finish(no_card, "a dry-run cell's process")
    if out.splitlines()[-1].split() != ["OK", "False"]:
        fail(f"a dry-run cell's process initialised CUDA: {out}")
    print(f"11c a traced dry-run cell (decode_32k, 16x16) in its own "
          f"process leaves torch.cuda.is_initialized() False "
          f"({wall:.3f} s wall)")
    proc, wall = run_module(["repro_torch.launch.roofline", "--in-dir",
                             DRYRUN_OUT])
    rows = [ln for ln in proc.stdout.splitlines()
            if ln.startswith(f"| {LM_ARCH} |")]
    analytic = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("| analytic |")]
    if len(rows) != 8 or len(analytic) != 8:
        fail(f"roofline --in-dir {DRYRUN_OUT}: {len(rows)} rows, "
             f"{len(analytic)} analytic rows, want 8:\n{proc.stdout}")
    for line in rows + [ln for ln in proc.stdout.splitlines()
                        if "->" in ln]:
        print(f"11c   {line}")
    print(f"11c python -m repro_torch.launch.roofline --in-dir {DRYRUN_OUT}: "
          f"8 rows on the default chip h100_sxm (a model from its data "
          f"sheet, not a measurement; {wall:.3f} s wall)")

    launches = quickstart_on_card(smi)
    print(f"phase 11: {time.perf_counter() - t_phase:.3f} s wall")
    return launches


def main() -> None:
    name, count, smi = environment()
    sys.path.insert(0, SRC)
    baseline = build()
    errors = {"rst_read": 0.0, "rst_write": 0.0, "rst_contend_read": 0.0,
              "rst_contend_mix_read": 0.0}
    compare_kernels(errors)
    compare_contend_kernels(errors)
    compare_cta_counts(errors)
    compare_buffers()
    launches = main_path()
    bench_cli()
    launches.update(contention_path())
    kernels = measure(launches, errors, smi, baseline)
    kernels += measure_contention(launches, errors, smi, baseline)
    roofline_launches, prices, peak_gbps = grid_tier(smi)
    campaign_launches = campaign_path(smi, prices)
    roofline_cli_refuses()
    static_analysis()
    # 11c's trace of the repaired cells runs on the host's cores from
    # here, beside the card's phases 9-11.
    repaired = _start(["-c", REPAIRED_CHILD])
    rank0 = _start(["-c", RANK0_CHILD])
    lm_serving(smi, peak_gbps)
    lm_training(smi, peak_gbps)
    quickstart_launches = launch_layer(smi, repaired, rank0)
    for k in kernels:
        if k["name"] == "rst_contend_read":
            k["launches"] += roofline_launches + campaign_launches
        if k["name"] == "rst_read":
            k["launches"] += quickstart_launches
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
