"""`models.common.contract`, the batched product of the port's models.

* On plain tensors it is `torch.einsum` bit for bit, for every equation
  the models pass it (read from their sources, so a new call site is
  listed or this fails).
* Over DTensors on the mini dry run's (2, 2, 2) mesh, as rank 0 of a
  one-rank fake process group (`launch.dryrun.one_rank`, inside
  `gspmd_choices`, as the dry run traces): attention's scores with the
  batch split over the data axis and the heads over the model axis, and
  the MoE dispatch with its groups over data and its experts over model,
  keep both split through the product and its backward (no all-gather;
  the local result is this rank's part of both), where `torch.einsum`
  on the same DTensors gathers the heads.
* Letters split differently in two operands: the smaller is moved to
  the larger's placement (an all-to-all where it holds the letter), and
  a contracted split letter leaves a partial sum.

Values over two gloo ranks: tests/test_torch_partitioned_values.py.
"""
import os
import re

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import contiguous_stride, contract

MODELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "src", "repro_torch", "models")
# Every equation the models pass to `contract`, by file.
EQUATIONS = {
    "attention.py": ("bqghd,bkhd->bghqk", "bghqk,bkhd->bqghd",
                     "bghqk,bkhd->bghqd", "bsc,chk->bshk"),
    "encdec.py": ("bsd,dhk->bshk", "bshk,hkd->bsd", "bsd,ldhk->lbshk"),
    "moe.py": ("ecd,edf->ecf", "ecf,efd->ecd", "gtec,gtd->egcd",
               "egcd,gtec->gtd"),
    "ssm.py": ("bhk,bhv->bhkv", "bhk,bhkv->bhv", "bchk,bhkv->bchv",
               "bthk,bjhk->bhtj", "bthk,bthk->bht", "bhtj,bjhv->bthv",
               "bjhk,bjhv->bhkv", "bce,en->bcen", "bcn,bcen->bce",
               "btje,en->btjen", "btjen,btn,bjn->btje", "btn,bjn->btjn",
               "btjen,btjn->btje", "btje,bje->bte", "bje,en->bjen",
               "be,en->ben", "bjen,bje,bjn->ben"),
}
ALL = sorted({eq for eqs in EQUATIONS.values() for eq in eqs})
# A size for each letter, distinct where two letters meet.
SIZES = {c: 2 + i % 5 for i, c in enumerate("bqghdkscleftjvn")}
MESH = make_mesh((2, 2, 2), ("pod", "data", "model"))


def test_every_model_equation_is_listed():
    for name in sorted(os.listdir(MODELS)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(MODELS, name)) as f:
            found = set(re.findall(r'contract\(\s*"([^"]+)"', f.read()))
        assert found == set(EQUATIONS.get(name, ())), name


@pytest.mark.parametrize("equation", ALL)
def test_plain_tensors_are_einsum_bit_for_bit(equation):
    rng = np.random.default_rng(0)
    ins = equation.split("->")[0].split(",")
    ops = [torch.from_numpy(rng.standard_normal(
        [SIZES[c] for c in letters], dtype=np.float32)) for letters in ins]
    got = contract(equation, *ops)
    assert type(got) is torch.Tensor
    assert torch.equal(got, torch.einsum(equation, *ops))


def _split(dm, shape, places):
    """A meta DTensor of global `shape` on `dm`, this rank's part of it."""
    local = compute_local_shape_and_global_offset(shape, dm, places)[0]
    return DTensor.from_local(
        torch.empty(local, device="meta"), dm, places, run_check=False,
        shape=shape, stride=contiguous_stride(*shape)).requires_grad_(True)


def _traced(equation, shapes, places, product=contract):
    """`product(equation, ...)` and its backward over meta DTensors of
    `shapes` split as `places` (pod, data, model), as rank 0 of MESH:
    the result's placements and local shape, and the collectives."""
    with dryrun.one_rank(MESH) as dm, dryrun.gspmd_choices():
        ops = [_split(dm, s, p) for s, p in zip(shapes, places)]
        tr = dryrun._Trace()
        with tr:
            out = product(equation, *ops)
            grads = torch.autograd.grad(out.sum(), ops)
        return (tuple(out.placements), tuple(out.to_local().shape),
                [tuple(g.placements) for g in grads], dict(tr.collectives))


B, SQ, G, H, D, SKV = 8, 6, 2, 4, 16, 6
SCORES = ("bqghd,bkhd->bghqk", [(B, SQ, G, H, D), (B, SKV, H, D)],
          [[Replicate(), Shard(0), Shard(3)],
           [Replicate(), Shard(0), Shard(2)]])


def test_scores_keep_batch_and_heads_split():
    places, local, grads, coll = _traced(*SCORES)
    assert places == (Replicate(), Shard(0), Shard(2))
    assert local == (B // 2, G, H // 2, SQ, SKV)
    assert grads == [tuple(p) for p in SCORES[2]]
    assert "all-gather" not in coll and "all-to-all" not in coll


def test_einsum_gathers_the_heads_flattened_with_the_batch():
    """The fault `contract` repairs: DTensor's einsum flattens b and h
    for a bmm, and its reshape keeps only b split."""
    coll = _traced(*SCORES, product=torch.einsum)[3]
    assert coll["all-gather"] > 0


def test_moe_dispatch_keeps_groups_and_experts_split():
    g, t, e, c, d = 4, 8, 4, 3, 16
    places, local, grads, coll = _traced(
        "gtec,gtd->egcd", [(g, t, e, c), (g, t, d)],
        [[Replicate(), Shard(0), Shard(2)],
         [Replicate(), Shard(0), Replicate()]])
    assert places == (Replicate(), Shard(1), Shard(0))
    assert local == (e // 2, g // 2, c, d)
    # The tokens' gradient sums over the experts: a partial sum over the
    # model axis, which the tokens' producer reduces where it needs it
    # (the tokens, already placed, are not redistributed, so nothing
    # reduces it back to their whole placement here).
    assert grads[1] == (Replicate(), Shard(0), Partial())
    assert "all-gather" not in coll and "all-to-all" not in coll
    assert "all-reduce" not in coll


def test_a_letter_split_differently_moves_the_smaller_operand():
    """q (the larger) splits the batch over the model axis, k its heads:
    k is moved to the batch, an all-to-all of k's local bytes; the
    result keeps the batch split."""
    places, local, grads, coll = _traced(
        "bqghd,bkhd->bghqk", [(B, 4 * SQ, G, H, D), (B, SKV, H, D)],
        [[Replicate(), Replicate(), Shard(0)],
         [Replicate(), Replicate(), Shard(2)]])
    assert places == (Replicate(), Replicate(), Shard(0))
    assert local == (B // 2, G, H, 4 * SQ, SKV)
    assert grads[1] == (Replicate(), Replicate(), Shard(2))
    assert "all-gather" not in coll
    # Forward and backward: k there, its gradient back.
    assert coll["all-to-all_count"] == 2
    assert coll["all-to-all"] == 2 * B * SKV * H * D * 4 // 2


def test_a_contracted_split_letter_leaves_a_partial_sum():
    places, local, _, coll = _traced(
        "bhtj,bjhv->bthv", [(B, H, SQ, SKV), (B, SKV, H, D)],
        [[Replicate(), Shard(0), Shard(3)],
         [Replicate(), Shard(0), Shard(1)]])
    assert places == (Replicate(), Shard(0), Partial())
    assert local == (B // 2, SQ, H, D)
    assert "all-gather" not in coll
