"""The partitioned program's values, on two CPU ranks.

The dry run traces the partitioned step for its memory and collectives;
this holds its values.  Two gloo processes (a `FileStore` under the
test's directory) form a ("model",) mesh of 2 and run, on DTensors split
as the production rules split them, against the plain path on the whole
tensors in float32 (rtol = atol = 1e-5):

* decode attention over a cache whose slots are split
  (`models.attention.gqa_attention`): scored whole (each rank scores its
  slots; the softmax combined across the ranks), and in chunks of
  `kv_chunk` (the slots gathered once, then the chunks in order), each
  with a chunk whose slots are all masked; and MLA's over a latent cache
  whose slots are split, its weights' heads split
  (`models.attention._latent_attention_split`), one token a row and a
  prompt, with and without a window, each rank making its mask from the
  positions; and GQA attention whose heads the axis cuts across KV
  groups, or whose rows the caller split (`_attention_split_rows`),
  prefill chunked over queries and KV, with the gradients of q, k, v;
* the loss over vocab-split logits (`launch.train.lm_loss`): its value
  and the gradient of the logits;
* the MoE FFN (`models.moe.moe_ffn`) over a batch split as the data axis
  splits it, four routing groups routed at once (two a rank), its
  experts and shared FFN split as the model axis splits them: the
  output and the aux loss, the mean over the groups of both ranks;
  and, with the batch whole and the experts split, the routing weights
  split on the experts with their gradient left split: the output and
  the gradients of the input and the router;
* inside `launch.dryrun.gspmd_choices`, as the dry run runs its step: a
  move between split dimensions (`Shard(0)` to `Shard(1)`, the
  all-to-all over the group) and the batched product
  (`models.common.contract`) with its operands split on the same
  letter, on different letters (the smaller moved by all-to-all) and on
  a contracted letter (a partial sum): the values and the operands'
  gradients; and a whole tensor added to a partial sum, made one
  (`models.common.partial_as`), its value and gradients;
* a layer's products with a weight split on its input dimension
  (`models.common.project`): one token beside it (the weight kept
  split, the product all-reduced) and a batch split on the same axis
  (the weight gathered), values and gradients; an embedding lookup on a
  table that keeps its split columns (`models.common.take_rows`), its
  value and the table's gradient; and a gemma3 layer
  (`models.transformer._layer_forward`) whose row-parallel outputs are
  reduced once before the sandwich norms, under the serving rules and
  under sequence parallelism;
* deepseek-v2-lite's smoke() prefill step (`Model.prefill`) under the
  prefill's rules, its latent cache split on slots: the last logits and
  the written cache, in float64.

Four gloo processes form a ("data", "model") mesh of (2, 2) for a
layer's product whose weight's split moves from "data" to "model"
(`models.common.project`), against the gathered weight's product; and
for rwkv6's one-token step under the long_500k rules (`models.ssm`),
its products' partial sums all-reduced and nothing gathered.

The processes are started with `torch.multiprocessing` and joined with
a deadline: a hang fails the test instead of holding the suite.
"""
import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import placements
from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.models.common import contract

TOL = 1e-5
DEADLINE_S = 120
c10d = torch.ops.c10d_functional      # as CommDebugMode counts them
# (B, Sq, H, KH, D, slots): GQA with two query heads a kv head.
ATTN_SHAPE = (3, 1, 4, 2, 8, 64)


def _attention_cases(rank, mesh):
    b, sq, h, kh, d, slots = ATTN_SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((b, sq, h, d), (b, slots, kh, d),
                             (b, slots, kh, d)))
    mask = torch.from_numpy(rng.random((b, sq, slots)) < 0.7)
    mask[:, :, 16:32] = False            # a chunk of 16 wholly masked
    mask[1, :, :] = False                # a row with no slot at all
    mask[1, :, 40] = True
    split_k = [Shard(1)]                 # the cache's slots over "model"
    for kv_chunk in (None, 16, 32):
        want = attn.gqa_attention(q, k, v, mask, kv_chunk=kv_chunk)
        got = attn.gqa_attention(
            distribute_tensor(q, mesh, [Replicate()]),
            distribute_tensor(k, mesh, split_k),
            distribute_tensor(v, mesh, split_k),
            distribute_tensor(mask, mesh, [Shard(2)]), kv_chunk=kv_chunk)
        got = got.full_tensor()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    return "attention"


def _rows_cases(rank, mesh):
    """GQA attention whose heads the model axis cuts across KV groups
    (12 heads over 4 KV heads: 6 a rank, a group and a half): the
    queries' rows split instead (`models.attention._attention_split_rows`),
    and queries whose rows the caller split (sequence parallelism), as a
    causal prefill scored whole, chunked over KV, and chunked over
    queries and KV: the output and the gradients of q, k and v."""
    b, s, h, kh, d = 2, 64, 12, 4, 8
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    pos = torch.arange(s)[None].expand(b, s)
    mask = attn.make_mask(pos, pos)
    up = torch.from_numpy(rng.standard_normal((b, s, h, d),
                                              dtype=np.float32))
    for kv_chunk, q_chunk in ((None, 4096), (16, 4096), (16, 32)):
        whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = attn.gqa_attention(*whole, mask, kv_chunk=kv_chunk,
                                  q_chunk=q_chunk)
        want_grads = torch.autograd.grad((want * up).sum(), whole)
        for q_place in (Shard(2), Shard(1)):
            split = [distribute_tensor(t, mesh, [p]).requires_grad_(True)
                     for t, p in ((q, q_place), (k, Shard(2)),
                                  (v, Shard(2)))]
            with dryrun.gspmd_choices():
                assert attn._row_axes(split[0], split[1], q_chunk) == [0]
                got = attn.gqa_attention(
                    *split, distribute_tensor(mask, mesh, [Replicate()]),
                    kv_chunk=kv_chunk, q_chunk=q_chunk)
                grads = torch.autograd.grad(
                    (got * distribute_tensor(up, mesh, [Replicate()])).sum(),
                    split)
            torch.testing.assert_close(got.full_tensor(), want, rtol=TOL,
                                       atol=TOL)
            for g, w in zip(grads, want_grads):
                torch.testing.assert_close(g.full_tensor(), w, rtol=TOL,
                                           atol=TOL)
    return "rows"


def _latent_cases(rank, mesh):
    b, h, nope, rope, vd, lora, slots = 2, 4, 8, 4, 6, 10, 64
    rng = np.random.default_rng(2)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    c, kr = randn(b, slots, lora), randn(b, slots, rope)
    w = {"w_uk": randn(lora, h, nope), "w_uv": randn(lora, h, vd)}
    kv_pos = torch.arange(slots)[None].expand(b, slots)
    # One token a row at its own position (a chunk of 16 slots wholly
    # masked on both rows), and a prompt of 20 tokens at slots 0-19.
    for pos, window in ((torch.tensor([[20], [29]]), None),
                        (torch.arange(20)[None].expand(b, 20), None),
                        (torch.arange(20)[None].expand(b, 20), 6)):
        q_nope, q_rope = (randn(b, pos.shape[1], h, n) for n in (nope, rope))
        mask = attn.make_mask(pos, kv_pos, window=window)
        for kv_chunk in (None, 16):
            want = attn._latent_attention(q_nope, q_rope, c, kr, w["w_uk"],
                                          w["w_uv"], mask, nope, rope,
                                          kv_chunk)
            split = [Shard(1)]
            got = attn._latent_attention_split(
                *(distribute_tensor(t, mesh, [Shard(2)]) for t in (q_nope,
                                                                   q_rope)),
                distribute_tensor(c, mesh, split),
                distribute_tensor(kr, mesh, split),
                {k: distribute_tensor(t, mesh, [Shard(1)])
                 for k, t in w.items()},
                distribute_tensor(pos, mesh, [Replicate()]), window, nope,
                rope, kv_chunk)
            torch.testing.assert_close(got.full_tensor(), want, rtol=TOL,
                                       atol=TOL)
    return "latent"


class _Logits:
    """A model whose forward returns the given logits."""

    def __init__(self, logits):
        self.logits = logits

    def forward(self, params, batch, rules):
        return self.logits, 0.0


def _loss_cases(rank, mesh):
    b, s, vocab = 2, 5, 37               # 37: an uneven vocab split
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(
        4 * rng.standard_normal((b, s, vocab), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, vocab, (b, s)))
    labels[0, 0], labels[1, 4] = 0, vocab - 1      # both ends of the split
    whole = logits.clone().requires_grad_(True)
    total, parts = train.lm_loss(_Logits(whole), None, {"labels": labels},
                                 None)
    total.backward()
    split = distribute_tensor(logits, mesh, [Shard(2)]).requires_grad_(True)
    got, got_parts = train.lm_loss(
        _Logits(split), None,
        {"labels": distribute_tensor(labels, mesh, [Replicate()])}, None)
    got.backward()
    torch.testing.assert_close(got.full_tensor(), total, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got_parts["ce"].full_tensor(), parts["ce"],
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(split.grad.full_tensor(), whole.grad,
                               rtol=TOL, atol=TOL)
    # The gradient stays split as the logits are: nothing was gathered.
    assert split.grad.placements == (Shard(2),)
    return "loss"


def _moe_cases(rank, mesh):
    b, s, d, group = 4, 8, 8, 8          # four groups of 8 tokens
    cfg = moe.MoEConfig(num_experts=4, top_k=2, expert_d_ff=6,
                        num_shared=1, shared_d_ff=6, capacity_factor=1.0)
    rng = np.random.default_rng(3)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            scale * rng.standard_normal(shape, dtype=np.float32))

    x = randn(b, s, d)
    p = {"router": randn(d, 4, scale=2.0), "w_gate": randn(4, d, 6),
         "w_up": randn(4, d, 6), "w_down": randn(4, 6, d),
         "shared_gate": randn(d, 6), "shared_up": randn(d, 6),
         "shared_down": randn(6, d)}
    act = common.ACTIVATIONS["silu"]
    want, want_aux = moe.moe_ffn(x, p, cfg, act, group_size=group)
    split = {"router": [Replicate()], "w_gate": [Shard(0)],
             "w_up": [Shard(0)], "w_down": [Shard(0)],
             "shared_gate": [Shard(1)], "shared_up": [Shard(1)],
             "shared_down": [Shard(0)]}
    # Under implicit replication, as the dry run's step runs: the
    # routing's aranges are plain tensors.
    with implicit_replication():
        got, aux = moe.moe_ffn(
            distribute_tensor(x, mesh, [Shard(0)]),
            {k: distribute_tensor(t, mesh, split[k]) for k, t in p.items()},
            cfg, act, group_size=group)
    torch.testing.assert_close(got.full_tensor(), want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(aux.full_tensor(), want_aux, rtol=TOL,
                               atol=TOL)
    # The batch whole on every rank, the experts split: each rank takes
    # its experts' routing weights, and their gradient stays split.
    whole = {k: t.clone().requires_grad_(True) for k, t in
             (("x", x), ("router", p["router"]))}
    want, _ = moe.moe_ffn(whole["x"], {**p, "router": whole["router"]},
                          cfg, act, group_size=group)
    up = randn(*want.shape)
    want_grads = torch.autograd.grad((want * up).sum(), list(whole.values()))
    leaves = {k: distribute_tensor(t, mesh, [Replicate()])
              .requires_grad_(True) for k, t in whole.items()}
    placed = {k: distribute_tensor(t, mesh, split[k]) for k, t in p.items()}
    with implicit_replication():
        got, _ = moe.moe_ffn(leaves["x"],
                             {**placed, "router": leaves["router"]}, cfg,
                             act, group_size=group)
        grads = torch.autograd.grad(
            (got * distribute_tensor(up, mesh, [Replicate()])).sum(),
            list(leaves.values()))
    torch.testing.assert_close(got.full_tensor(), want, rtol=TOL, atol=TOL)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g.full_tensor(), w, rtol=TOL, atol=TOL)
    return "moe"


def _contract_cases(rank, mesh):
    rng = np.random.default_rng(4)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    # (equation, operand shapes, each operand's placement on "model")
    cases = [("bqghd,bkhd->bghqk", ((4, 6, 2, 4, 8), (4, 5, 4, 8)),
              (Shard(3), Shard(2))),                     # heads, both
             ("bqghd,bkhd->bghqk", ((4, 6, 2, 4, 8), (4, 5, 4, 8)),
              (Shard(0), Shard(2))),                     # k moved
             ("bhtj,bjhv->bthv", ((4, 2, 6, 6), (4, 6, 2, 8)),
              (Shard(3), Shard(1))),                     # a partial sum
             ("gtec,gtd->egcd", ((4, 6, 4, 3), (4, 6, 8)),
              (Shard(2), Shard(0)))]                     # tokens gathered
    with dryrun.gspmd_choices():
        x = randn(4, 6, 8)
        moved = distribute_tensor(x, mesh, [Shard(0)]).redistribute(
            mesh, [Shard(1)])
        assert moved.placements == (Shard(1),)
        torch.testing.assert_close(moved.full_tensor(), x, rtol=0, atol=0)
        for equation, shapes, places in cases:
            whole = [randn(*shape).requires_grad_(True) for shape in shapes]
            want = torch.einsum(equation, *whole)
            up = randn(*want.shape)
            want_grads = torch.autograd.grad((want * up).sum(), whole)
            split = [distribute_tensor(t.detach(), mesh, [p])
                     .requires_grad_(True) for t, p in zip(whole, places)]
            got = contract(equation, *split)
            grads = torch.autograd.grad(
                (got * distribute_tensor(up, mesh, [Replicate()])).sum(),
                split)
            torch.testing.assert_close(got.full_tensor(), want, rtol=TOL,
                                       atol=TOL)
            for g, w in zip(grads, want_grads):
                torch.testing.assert_close(g.full_tensor(), w, rtol=TOL,
                                           atol=TOL)
        # A whole tensor added to a partial sum is made a partial sum
        # (`models.common.partial_as`): the sum stays one, not reduced.
        a, shares = randn(4, 8), randn(2, 4, 8)
        whole = [a.clone().requires_grad_(True),
                 shares.clone().requires_grad_(True)]
        want = whole[0] + whole[1].sum(0)
        up = randn(4, 8)
        want_grads = torch.autograd.grad((want * up).sum(), whole)
        da = distribute_tensor(a, mesh, [Replicate()]).requires_grad_(True)
        share = shares[rank].clone().requires_grad_(True)
        part = DTensor.from_local(share, mesh, [Partial()])
        got = common.partial_as(da, part) + part
        assert got.placements == (Partial(),)
        grad_a, grad_share = torch.autograd.grad(
            (got * distribute_tensor(up, mesh, [Replicate()])).sum(),
            [da, share])
        torch.testing.assert_close(got.full_tensor(), want, rtol=TOL,
                                   atol=TOL)
        torch.testing.assert_close(grad_a.full_tensor(), want_grads[0],
                                   rtol=TOL, atol=TOL)
        torch.testing.assert_close(grad_share, want_grads[1][rank],
                                   rtol=TOL, atol=TOL)
    return "contract"


def _layer_cases(rank, mesh):
    rng = np.random.default_rng(5)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    # (equation, activations' shape and placement): one token, and a
    # batch split on the axis that splits the weight's input dimension.
    w = randn(8, 4, 3)
    for x_shape, x_place in (((1, 1, 8), Replicate()), ((4, 2, 8), Shard(0))):
        x = randn(*x_shape)
        whole = [t.clone().requires_grad_(True) for t in (x, w)]
        want = torch.einsum("bsd,dhk->bshk", *whole)
        up = randn(*want.shape)
        want_grads = torch.autograd.grad((want * up).sum(), whole)
        split = [distribute_tensor(x, mesh, [x_place]).requires_grad_(True),
                 distribute_tensor(w, mesh, [Shard(0)]).requires_grad_(True)]
        with dryrun.gspmd_choices():
            got = common.project("bsd,dhk->bshk", *split)
            if x_place.is_replicate():
                # The weight kept split, the one token's partial product
                # all-reduced at once.
                assert got.placements[0].is_replicate()
            grads = torch.autograd.grad(
                (got * distribute_tensor(up, mesh, [Replicate()])).sum(),
                split)
        torch.testing.assert_close(got.full_tensor(), want, rtol=TOL,
                                   atol=TOL)
        for g, ww in zip(grads, want_grads):
            torch.testing.assert_close(g.full_tensor(), ww, rtol=TOL,
                                       atol=TOL)
    # A table larger than its lookup keeps its split columns.
    table = randn(16, 8)
    ids = torch.from_numpy(rng.integers(0, 16, (1, 3)))
    whole = table.clone().requires_grad_(True)
    want = common.take_rows(whole, ids)
    up = randn(*want.shape)
    (want_grad,) = torch.autograd.grad((want * up).sum(), [whole])
    split = distribute_tensor(table, mesh, [Shard(1)]).requires_grad_(True)
    got = common.take_rows(split, distribute_tensor(ids, mesh, [Replicate()]))
    (grad,) = torch.autograd.grad(
        (got * distribute_tensor(up, mesh, [Replicate()])).sum(), [split])
    torch.testing.assert_close(got.full_tensor(), want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(grad.full_tensor(), want_grad, rtol=TOL,
                               atol=TOL)
    assert grad.placements == (Shard(1),)
    # A gemma3 layer: its FFN's and attention's outputs are partial sums
    # over "model", each reduced once before its sandwich norm.
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params, param_sharding
    cfg = get_config("gemma3-1b", smoke=True)
    specs = transformer.param_specs(cfg)["layer_list"][0]
    gen = torch.Generator().manual_seed(6)
    lp = init_params(gen, specs, dtype=torch.float32, device="cpu")
    x = randn(2, 8, cfg.d_model)
    for seq in (None, "model"):
        rules = {**train.make_rules(cfg, ("model",)), "seq": seq}
        pos = {"pos": common.token_positions(x)}
        want, _, _ = transformer._layer_forward(x, lp, cfg, pos, 0)
        places = common.tree_leaves(param_sharding(specs, rules),
                                    lambda t: isinstance(t, tuple))
        with dryrun.gspmd_choices(), implicit_replication():
            dx = distribute_tensor(x, mesh, [Replicate()])
            dlp = common.tree_unflatten(lp, [
                distribute_tensor(t, mesh, placements(mesh, sp))
                for t, sp in zip(common.tree_leaves(lp), places)])
            got, _, _ = transformer._layer_forward(
                dx, dlp, cfg, {"pos": common.token_positions(dx)}, 0,
                rules=rules)
        torch.testing.assert_close(got.full_tensor(), want, rtol=TOL,
                                   atol=TOL)
    return "layer"


def _prefill_cases(rank, mesh):
    """deepseek's smoke() prefill step, its parameters split as the
    production rules split them over "model" and its latent cache split
    on slots, as the prefill's rules split it (each rank making its
    rows' mask from the positions), against the plain step, both in
    float64: a whole step in float32 is itself 2.6e-5 from float64, the
    rounding of its three layers, where TOL holds the partitioned
    program's own difference."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    model = build(cfg)
    specs = model.param_specs()
    params = init_params(torch.Generator().manual_seed(7), specs,
                         dtype=torch.float64, device="cpu")
    b, s, slots = 2, 12, 16
    tokens = torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg.vocab_size, (b, s)))
    cache = model.init_cache(b, slots, dtype=torch.float64, device="cpu")
    rules = dryrun._shape_rules(train.make_rules(cfg, mesh),
                                ShapeSpec("mini", slots, b, "prefill"), mesh,
                                cfg)

    def place(tree, shardings):
        return common.tree_unflatten(tree, [
            distribute_tensor(t, mesh, sh.placements())
            if isinstance(t, torch.Tensor) else t
            for t, sh in zip(common.tree_leaves(tree),
                             common.tree_leaves(shardings))])

    split_params = place(params, dryrun._param_shardings(specs, rules, mesh))
    split_cache = place(cache, serve_lib.cache_shardings(cache, mesh, rules))
    assert common.is_split(split_cache["stack"]["mixer"]["c_kv"], 2)
    want, want_cache = model.prefill(
        params, {"tokens": tokens},
        model.init_cache(b, slots, dtype=torch.float64, device="cpu"))
    with dryrun.gspmd_choices(), implicit_replication():
        got, got_cache = model.prefill(
            split_params, {"tokens": distribute_tensor(tokens, mesh,
                                                       [Replicate()])},
            split_cache, rules)
    torch.testing.assert_close(got.full_tensor(), want, rtol=TOL, atol=TOL)
    for entry, want_entry in ((got_cache["prefix"][0], want_cache["prefix"][0]),
                              (got_cache["stack"], want_cache["stack"])):
        for key in ("c_kv", "k_rope"):
            torch.testing.assert_close(entry["mixer"][key].full_tensor(),
                                       want_entry["mixer"][key], rtol=TOL,
                                       atol=TOL)
    assert got_cache["index"] == want_cache["index"] == s
    return "prefill"


def _on_mesh(rank, store_path, out_dir, shape, names, cases):
    """`cases`, each called with (rank, mesh) in turn, as rank `rank` of
    gloo processes forming a CPU mesh of `shape` and axis `names`; writes
    what each returned, or the traceback that stopped them, for the
    test."""
    world = int(np.prod(shape))
    done = []
    try:
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                store=dist.FileStore(store_path, world))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        done = [case(rank, mesh) for case in cases]
        dist.barrier()
    except Exception:
        done = [traceback.format_exc()]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
            f.write("\n".join(done))


def _rank(rank, store_path, out_dir):
    _on_mesh(rank, store_path, out_dir, (2,), ("model",),
             [_attention_cases, _rows_cases, _latent_cases, _loss_cases,
              _moe_cases, _contract_cases, _layer_cases, _prefill_cases])


def _spawn(target, nprocs, tmp_path):
    """`target(rank, store_path, out_dir)` in `nprocs` processes, joined
    with the deadline; returns what each rank wrote."""
    ctx = mp.start_processes(target, args=(str(tmp_path / "store"),
                                           str(tmp_path)),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{nprocs} ranks still running after "
                            f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [(tmp_path / f"rank{rank}.txt").read_text()
            for rank in range(nprocs)]


def test_partitioned_values_equal_the_plain_path(tmp_path):
    for rank, said in enumerate(_spawn(_rank, 2, tmp_path)):
        assert said == ("attention\nrows\nlatent\nloss\nmoe\ncontract\n"
                        "layer\nprefill"), \
            f"rank {rank}:\n{said}"


def _moved_cases(rank, mesh):
    """A layer's product with a weight split on its input dimension over
    "data", which also splits the activations' batch, on a (2, 2) mesh
    of ("data", "model"), "model" holding both whole: where the product
    is smaller than the weight (a decode step's tokens), the weight's
    split moves to "model" (`models.common._SwapSplit`, a permutation of
    the shards) and the product's partial sum there is all-reduced;
    where it is larger, the weight is gathered.  Values and gradients
    against the plain product."""
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.standard_normal((8, 3, 2),
                                             dtype=np.float32))
    for tokens, moved in ((1, True), (16, False)):
        x = torch.from_numpy(rng.standard_normal((4, tokens, 8),
                                                 dtype=np.float32))
        whole = [t.clone().requires_grad_(True) for t in (x, w)]
        want = torch.einsum("bsd,dhk->bshk", *whole)
        up = torch.from_numpy(rng.standard_normal(tuple(want.shape),
                                                  dtype=np.float32))
        want_grads = torch.autograd.grad((want * up).sum(), whole)
        split = [distribute_tensor(t, mesh, [Shard(0), Replicate()])
                 .requires_grad_(True) for t in (x, w)]
        with dryrun.gspmd_choices(), CommDebugMode() as comm:
            got = common.project("bsd,dhk->bshk", *split)
        # Moved: one permutation of the shards (an all-to-all), the
        # product all-reduced; else the weight gathered.
        counts = comm.get_comm_counts()
        assert (counts[c10d.all_to_all_single] == 1) == moved
        assert (counts[c10d.all_gather_into_tensor] == 0) == moved
        with dryrun.gspmd_choices():
            grads = torch.autograd.grad(
                (got * distribute_tensor(up, mesh, [Replicate()] * 2))
                .sum(), split)
        torch.testing.assert_close(got.full_tensor(), want, rtol=TOL,
                                   atol=TOL)
        for g, ww in zip(grads, want_grads):
            torch.testing.assert_close(g.full_tensor(), ww, rtol=TOL,
                                       atol=TOL)
    return "moved"


def _moved_rank(rank, store_path, out_dir):
    _on_mesh(rank, store_path, out_dir, (2, 2), ("data", "model"),
             [_moved_cases])


def test_weight_split_moved_to_a_free_axis(tmp_path):
    for rank, said in enumerate(_spawn(_moved_rank, 4, tmp_path)):
        assert said == "moved", f"rank {rank}:\n{said}"


def _rwkv_cases(rank, mesh):
    """rwkv6's smoke() time mix and channel mix (`models.ssm`), one token
    of a batch of one from a state, under the long_500k rules on a (2, 2)
    mesh of ("data", "model"): the weights split as `param_sharding`
    splits them (FSDP's input dimension over "data", heads and the FFN's
    width over "model"), the state as the decode cache is split, the
    time mix's output reduced onto the residual stream as the layer's
    `exit_tp` does.  The outputs, the new WKV state and the input's
    gradient against the plain path on whole tensors.  Inside
    `gspmd_choices` the time mix gathers only its output, onto the
    residual stream, and the channel mix nothing: each product's partial
    sum is all-reduced at once (`models.common.project`), the channel
    mix's d_ff-wide product takes its input split as its weight is, and
    its gate moves its split to the axis of the product it multiplies
    (`models.common.aligned`, one all-to-all)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import ssm, transformer
    from repro_torch.models.common import param_sharding

    cfg = get_config("rwkv6-7b", smoke=True)
    rules = dryrun._shape_rules(train.make_rules(cfg, ("data", "model")),
                                SHAPES["long_500k"], None, cfg)
    assert rules["batch"] is None
    d, h = cfg.d_model, cfg.d_model // cfg.rwkv.head_size
    k = cfg.rwkv.head_size
    rng = np.random.default_rng(11)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            scale * rng.standard_normal(shape, dtype=np.float32))

    specs = {"attn": transformer._rwkv_specs(cfg),
             "mlp": transformer._rwkv_cmix_specs(cfg)}
    lp = {part: {name: randn(*sp.shape, scale=0.2)
                 for name, sp in tree.items()}
          for part, tree in specs.items()}
    x = randn(1, 1, d)
    state = {"shift": randn(1, d), "wkv": randn(1, h, k, k)}
    cm_shift = randn(1, d)
    up = randn(1, 1, d)

    def step(x, lp, state, cm_shift, rules=None):
        with CommDebugMode() as time_comm:
            mix, new = ssm.rwkv6_time_mix(x, lp["attn"], num_heads=h,
                                          state=state)
            if rules is not None:       # the layer's exit_tp
                mix = common.logical_constraint(
                    mix, rules, "batch", "seq", "act_embed")
        with CommDebugMode() as channel_comm:
            out, _ = ssm.rwkv6_channel_mix(x + mix, lp["mlp"],
                                           {"shift": cm_shift})
        return (mix, out, new["wkv"]), (time_comm.get_comm_counts(),
                                        channel_comm.get_comm_counts())

    whole = x.clone().requires_grad_(True)
    want, _ = step(whole, lp, state, cm_shift)
    (want_grad,) = torch.autograd.grad((want[1] * up).sum(), [whole])

    def place(t, spec):
        return distribute_tensor(t, mesh, placements(mesh, spec))

    shardings = param_sharding(specs, rules)
    dlp = {part: {name: place(t, shardings[part][name])
                  for name, t in tree.items()}
           for part, tree in lp.items()}
    dstate = {name: place(t, serve._cache_spec(name, t.ndim, rules))
              for name, t in state.items()}
    assert dstate["wkv"].placements[1] == Shard(1)   # heads
    dx = distribute_tensor(x, mesh, [Replicate()] * 2) \
        .requires_grad_(True)
    with dryrun.gspmd_choices(), implicit_replication():
        got, (time_mix, channel_mix) = step(
            dx, dlp, dstate,
            distribute_tensor(cm_shift, mesh, [Replicate()] * 2), rules)
    # The time mix gathers only its output, onto the residual
    # stream; the channel mix gathers nothing.
    assert time_mix[c10d.all_gather_into_tensor] == 1, time_mix
    assert channel_mix[c10d.all_gather_into_tensor] == 0, channel_mix
    assert channel_mix[c10d.all_to_all_single] == 1, channel_mix
    with dryrun.gspmd_choices(), implicit_replication():
        (grad,) = torch.autograd.grad(
            (got[1] * distribute_tensor(up, mesh, [Replicate()] * 2))
            .sum(), [dx])
    for g, w in zip(got, want):
        torch.testing.assert_close(g.full_tensor(), w, rtol=TOL,
                                   atol=TOL)
    torch.testing.assert_close(grad.full_tensor(), want_grad, rtol=TOL,
                               atol=TOL)
    return "rwkv6"


def _rwkv_rank(rank, store_path, out_dir):
    _on_mesh(rank, store_path, out_dir, (2, 2), ("data", "model"),
             [_rwkv_cases])


def test_rwkv6_one_token_step_gathers_no_activations(tmp_path):
    for rank, said in enumerate(_spawn(_rwkv_rank, 4, tmp_path)):
        assert said == "rwkv6", f"rank {rank}:\n{said}"
