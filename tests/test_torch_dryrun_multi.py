"""The port's partitioned dry run against the reference's compiled cells
on the multi-pod mesh, 2 x 16 x 16 over ("pod", "data", "model").

There the batch is split over pod x data (`"batch": ("pod", "data")`),
so a train step reduces its gradients over both, an MoE layer's routing
groups are split over both, and a decode step's FSDP weights meet a
third axis when `models.common.project` looks for an idle one of their
split's size.  The reference compiles each cell with
`repro.launch.dryrun.lower_cell(arch, shape, True)` (512 placeholder CPU
devices, in one child); the port traces the same cells as rank 0 of
that mesh (`repro_torch.launch.dryrun.lower_cell(arch, shape, True)`),
meanwhile.  Held for each cell, as tests/test_torch_dryrun_ref.py holds
the 16x16 cells (`_held_against_xla`):

* argument and alias bytes exactly as the two programs hold them (a
  train step's equal; a serving step's XLA's + 4 B of the cache's
  `index`, less `unread_bytes` on this mesh);
* the per-device peak over XLA's in MULTI_PEAK_BAND, measured here;
* the traced all-gather a step at most GATHER_BAND[1] x XLA's as its
  step runs them (`executed_collectives`: each HLO collective times the
  trips of the loops around it); deepseek-v2-lite's decode, which
  gathers its bf16 latent where XLA moves float32 keys and values by
  all-to-all, in MULTI_GATHER_ALONE_BAND, and with its all-to-all at
  most GATHER_BAND[1] x XLA's;
* the traced all-reduce and reduce-scatter a step together at most
  GATHER_BAND[1] x XLA's as its step runs them: deepseek-v2-lite's
  decode reduces its experts' input, a partial sum over pod x data,
  onto D over "data" first and then over "pod" a shard at a time
  (`models.common.shards_first`), 0.418 x XLA's (3.230 while it
  all-reduced the whole sum over "pod" first).

`python tests/test_torch_dryrun_ref.py --all --mesh multi` compares
every runnable 2x16x16 cell outside this tier (PERF.md §6).
"""
import pytest

from repro_torch.configs import get_config
from test_torch_dryrun_ref import _both, _held_against_xla

CELLS = (("starcoder2-7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
         ("deepseek-v2-lite-16b", "decode_32k"), ("rwkv6-7b", "long_500k"),
         ("gemma3-1b", "decode_32k"), ("whisper-small", "decode_32k"))
# Peak over XLA's, measured first (jax 0.9.0, torch 2.13 on the CPU;
# the 16x16 figure in brackets): starcoder2-7b train_4k 0.609 (0.606),
# qwen2-moe-a2.7b prefill_32k 0.563 (0.575), deepseek-v2-lite-16b
# decode_32k 0.377 (0.391), rwkv6-7b long_500k 0.393 (0.503), gemma3-1b
# decode_32k 0.681 (0.886), whisper-small decode_32k 0.321 (0.319).
MULTI_PEAK_BAND = {("starcoder2-7b", "train_4k"): (0.55, 0.67),
                   ("qwen2-moe-a2.7b", "prefill_32k"): (0.51, 0.62),
                   ("deepseek-v2-lite-16b", "decode_32k"): (0.34, 0.42),
                   ("rwkv6-7b", "long_500k"): (0.35, 0.44),
                   ("gemma3-1b", "decode_32k"): (0.61, 0.75),
                   ("whisper-small", "decode_32k"): (0.29, 0.36)}
# deepseek-v2-lite's decode gathers its bf16 latent cache over the
# slots, 4,251,294,720 B a step, where XLA expands each device's slots
# and moves float32 keys and values to the heads by all-to-all
# (4,529,881,088 B) beside 500,953,344 B of all-gather.  Measured: its
# all-gather alone 8.486 x XLA's (16.62 on 16x16, where XLA's gather is
# half this mesh's), with the all-to-all 0.845 x.
MULTI_GATHER_ALONE_BAND = {("deepseek-v2-lite-16b", "decode_32k"):
                           (8.1, 8.9)}


@pytest.fixture(scope="module")
def multi_records():
    return _both(CELLS, multi_pod=True)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_multi_pod_cell_against_xla(arch, shape, multi_records):
    port, ref = multi_records
    rec = port[f"{arch}|{shape}"]
    assert rec["mesh"] == "2x16x16"
    _held_against_xla(arch, shape, rec, ref[f"{arch}|{shape}"],
                      get_config(arch), peak_bands=MULTI_PEAK_BAND,
                      alone_bands=MULTI_GATHER_ALONE_BAND,
                      step_held=CELLS, gather_held=CELLS)
