"""The port's LM launch layer (repro_torch.launch.{shapes,serve,mesh,train})
against the reference's repro.launch, on the CPU.

* shapes: `SHAPES`, `cell_is_runnable`, `input_specs` (meta tensors) and
  `batch_shardings`' specs for all 40 cells, equal;
* serve: `abstract_cache` against the reference's `jax.eval_shape` cache
  (ten archs, `smoke()` and full size), `cache_shardings` leaf by leaf,
  and prefill + decode through `make_prefill_step`/`make_decode_step` on
  carried weights within 1e-4 (rtol, with an absolute floor of 1e-4 times
  max(1, max|ref|));
* mesh: `data_axes`/`dp_degree`, `make_production_mesh`'s shapes and
  names, and importing mesh.py touching no process group and no card
  (in a subprocess);
* `state_shardings`' specs, and the per-device shapes of every state,
  batch and cache leaf against the reference's
  `NamedSharding(mesh, spec).shard_shape(shape)` on 8 forced host
  devices ((2, 2, 2), `smoke()`) and 256 ((16, 16), full size), in
  subprocesses.  The reference's `shard_shape` refuses a dimension that
  does not divide its ways; XLA pads such a dimension, so the expected
  shape is then the rounded-up one.

Partition specs are compared as tuples with trailing Nones dropped, as
`resolve` writes them.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch import shapes as ref_shapes
from repro.launch import train as ref_train
from repro.launch.mesh import data_axes as ref_data_axes
from repro.launch.mesh import dp_degree as ref_dp_degree
from repro.models.common import init_params as ref_init
from repro.models.registry import build as ref_build
from repro_torch.configs import get_config
from repro_torch.launch import serve, shapes, train
from repro_torch.launch.mesh import (MeshSharding, data_axes, dp_degree,
                                     local_shape, make_mesh,
                                     make_production_mesh, placements)
from repro_torch.models.common import (params_from_numpy, params_to_numpy,
                                       tree_leaves)
from repro_torch.models.registry import build
from test_torch_archs import _batch, _tokens, close, tree_close

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
CELLS = [(a, s) for a in ARCH_IDS for s in ref_shapes.SHAPES]
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


class RefMesh:
    """The reference's mesh helpers read `axis_names` and `shape[name]`."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def norm(spec):
    """A PartitionSpec or spec tuple as a tuple without trailing Nones,
    each entry None, a name or a tuple of names."""
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def ref_mesh(names):
    """A one-device jax mesh with `names`: NamedSharding needs the axis
    names only."""
    return jax.make_mesh((1,) * len(names), tuple(names))


def ref_shape_rules():
    """The reference dry run's `_shape_rules` and `_n_micro`.  Importing
    the module sets XLA_FLAGS to 512 host devices; the backend is
    initialised first (one device stays one) and the flag restored, so
    no later subprocess of this worker inherits it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


# ------------------------------------------------------------- shapes


def test_shapes_equal_the_reference():
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    for k, s in shapes.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            ref_shapes.SHAPES[k])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_and_batch_shardings(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    s, rs = shapes.SHAPES[shape], ref_shapes.SHAPES[shape]
    assert shapes.cell_is_runnable(cfg, s) == \
        ref_shapes.cell_is_runnable(rcfg, rs)
    got, ref = shapes.input_specs(cfg, s), ref_shapes.input_specs(rcfg, rs)
    assert list(got) == list(ref)
    rdt = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == ref[k].shape
        assert v.dtype == rdt[ref[k].dtype.type], (k, v.dtype, ref[k].dtype)
    names = ("pod", "data", "model")
    mesh = ref_mesh(names)
    rsh = ref_shapes.batch_shardings(rcfg, rs, mesh,
                                     ref_train.make_rules(rcfg, mesh))
    psh = shapes.batch_shardings(cfg, s, make_mesh((2, 16, 16), names),
                                 train.make_rules(cfg, names))
    assert {k: norm(v.spec) for k, v in psh.items()} == \
        {k: norm(v.spec) for k, v in rsh.items()}


# ------------------------------------------------------------- serve


def _shape_dtype(leaf):
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


def same_cache_leaves(port, ref):
    """Port cache leaves against the reference's (shape, dtype) pairs.
    The port's `index` cursors are Python ints, one per stack, where the
    reference keeps an int32 scalar, one copy per layer when stacked."""
    assert len(port) == len(ref)
    for leaf, (shape, dtype) in zip(port, ref):
        if isinstance(leaf, int):
            assert dtype == "int32" and len(shape) <= 1, (shape, dtype)
        else:
            assert _shape_dtype(leaf) == (tuple(shape), dtype)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_equals_the_reference(arch, smoke):
    b, s = (2, 64) if smoke else (4, 32768)
    m = build(get_config(arch, smoke))
    got = serve.abstract_cache(m, b, s)
    ref = ref_serve.abstract_cache(ref_build(ref_config(arch, smoke)), b, s)
    pl = tree_leaves(got)
    same_cache_leaves(pl, [(r.shape, str(r.dtype))
                           for r in jax.tree.leaves(ref)])
    assert all(x.device.type == "meta" for x in pl if not isinstance(x, int))
    if smoke:                  # the same tree as a real cache's
        real = m.init_cache(batch_size=2, max_seq=8, device="cpu")
        small = serve.abstract_cache(m, 2, 8)
        assert [x if isinstance(x, int) else _shape_dtype(x)
                for x in tree_leaves(small)] == \
            [x if isinstance(x, int) else _shape_dtype(x)
             for x in tree_leaves(real)]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_the_reference(arch, shape):
    names = ("pod", "data", "model")
    rd = ref_shape_rules()
    from repro_torch.launch import dryrun
    cfg, rcfg = get_config(arch), ref_config(arch)
    s, rs = shapes.SHAPES[shape], ref_shapes.SHAPES[shape]
    mesh, pmesh = ref_mesh(names), make_mesh((2, 16, 16), names)
    rrules = rd._shape_rules(ref_train.make_rules(rcfg, mesh), rs, mesh,
                             rcfg)
    rules = dryrun._shape_rules(train.make_rules(cfg, names), s, pmesh, cfg)
    assert rules == rrules
    rcache = ref_serve.abstract_cache(ref_build(rcfg), 8, 1024)
    cache = serve.abstract_cache(build(cfg), 8, 1024)
    ref = jax.tree.leaves(ref_serve.cache_shardings(rcache, mesh, rrules))
    got = tree_leaves(serve.cache_shardings(cache, pmesh, rules))
    assert [norm(g.spec) for g in got] == [norm(r.spec) for r in ref]


@pytest.fixture(scope="module", params=ARCH_IDS)
def serve_case(request):
    arch = request.param
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    rm, m = ref_build(rcfg), build(cfg)
    rp = ref_init(jax.random.key(2), rm.param_specs(), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    return arch, cfg, rm, m, rp, params


PREFILL, STEPS, MAX_SEQ = 20, 6, 32


def test_prefill_then_decode_steps_equal_the_reference(serve_case):
    """`make_prefill_step` (whisper: start_cache and the forward's last
    logits) then `make_decode_step`, on the reference's carried weights:
    logits and caches step by step."""
    arch, cfg, rm, m, rp, params = serve_case
    tokens = _tokens(cfg, 2, PREFILL + STEPS, seed=7)
    rbatch, pbatch = _batch(cfg, tokens[:, :PREFILL])
    rcache = rm.init_cache(batch_size=2, max_seq=MAX_SEQ, dtype=jnp.float32)
    cache = m.init_cache(batch_size=2, max_seq=MAX_SEQ, dtype=torch.float32,
                         device="cpu")
    rlg, rcache = jax.jit(ref_serve.make_prefill_step(rm))(rp, rbatch, rcache)
    lg, cache = serve.make_prefill_step(m)(params, pbatch, cache)
    close(lg, rlg, what=f"{arch} prefill")
    tree_close(params_to_numpy(cache), jax.tree.map(np.asarray, rcache),
               f"{arch} prefill cache")
    rdecode = jax.jit(ref_serve.make_decode_step(rm))
    decode = serve.make_decode_step(m)
    start = 0 if cfg.is_encdec else PREFILL
    for t in range(start, start + STEPS):
        rlg, rcache = rdecode(rp, rcache, jnp.asarray(tokens[:, t:t + 1],
                                                       jnp.int32))
        lg, cache = decode(params, cache, torch.from_numpy(
            tokens[:, t:t + 1]))
        close(lg, rlg, what=f"{arch} decode {t}")
    tree_close(params_to_numpy(cache), jax.tree.map(np.asarray, rcache),
               f"{arch} decode cache")


# ------------------------------------------------------------- mesh


@pytest.mark.parametrize("which", sorted(PRODUCTION))
def test_data_axes_and_dp_degree_equal_the_reference(which):
    shape, names = PRODUCTION[which]
    mesh = make_mesh(shape, names)
    rmesh = RefMesh(shape, names)
    assert data_axes(mesh) == ref_data_axes(rmesh)
    assert dp_degree(mesh) == ref_dp_degree(rmesh)
    assert dp_degree(mesh) == {"single": 16, "multi": 32}[which]


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"))
    spec = (("pod", "data"), None, "model")
    places = placements(mesh, spec)
    assert places == [Shard(0), Shard(0), Shard(2)]
    assert placements(mesh, ()) == [Replicate()] * 3
    assert local_shape(mesh, places, (8, 3, 10)) == (2, 3, 3)   # 10/4 -> 3
    sh = MeshSharding(mesh, ("data",))
    assert sh.shard_shape((5, 7)) == (3, 7)
    assert sh.placements() == [Replicate(), Shard(0), Replicate()]


MESH_CHILD = textwrap.dedent("""
    import json, torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    out = {"group_at_import": dist.is_initialized(),
           "cuda_at_import": torch.cuda.is_initialized()}
    for multi in (False, True):
        M.make_production_mesh(multi_pod=multi)
    out["group_after"] = dist.is_initialized()
    out["cuda_after"] = torch.cuda.is_initialized()
    print(json.dumps(out))
""")


def _child(code, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_production_meshes_over_the_fake_group():
    """The production meshes are plain descriptions: the right shapes and
    names, and neither importing mesh.py nor making them initialises a
    process group or the card (checked in a fresh interpreter)."""
    out = _child(MESH_CHILD)
    assert out == {"group_at_import": False, "cuda_at_import": False,
                   "group_after": False, "cuda_after": False}
    got = {multi: make_production_mesh(multi_pod=multi)
           for multi in (False, True)}
    assert [(m.shape, m.mesh_dim_names, dp_degree(m), data_axes(m))
            for m in got.values()] == [
        ((16, 16), ("data", "model"), 16, ("data",)),
        ((2, 16, 16), ("pod", "data", "model"), 32, ("pod", "data"))]
    assert got[False] == make_mesh((16, 16), ("data", "model"))
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("data",))


# ------------------------------------------------------ state shardings


@pytest.mark.parametrize("which", sorted(PRODUCTION))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_shardings_equal_the_reference(arch, which):
    shape, names = PRODUCTION[which]
    cfg, rcfg = get_config(arch), ref_config(arch)
    mesh = ref_mesh(names)
    rrules = ref_train.make_rules(rcfg, mesh)
    rules = train.make_rules(cfg, make_mesh(shape, names))
    assert rules == rrules
    ref = ref_train.state_shardings(ref_build(rcfg).param_specs(), rrules,
                                    mesh)
    got = train.state_shardings(build(cfg).param_specs(), rules,
                                make_mesh(shape, names))
    assert type(got).__name__ == "AdamWState"
    rl, pl = jax.tree.leaves(ref), tree_leaves(got)
    assert len(rl) == len(pl)
    assert [norm(p.spec) for p in pl] == [norm(r.spec) for r in rl]
    assert norm(got.step.spec) == ()


LOCAL_SHAPES_CHILD = textwrap.dedent("""
    import os, sys, json, math
    os.environ["XLA_FLAGS"] = \
        "--xla_force_host_platform_device_count={devices}"
    import jax
    jax.devices()
    from repro.configs import ARCH_IDS, get_config
    from repro.launch import serve, train
    from repro.launch.dryrun import _shape_rules
    from repro.launch.mesh import make_mesh
    from repro.launch.shapes import (SHAPES, batch_shardings,
                                     cell_is_runnable, input_specs)
    from repro.models.registry import build

    mesh = make_mesh({shape}, {names})
    uneven = 0

    def local(sharding, shape):
        global uneven
        try:
            return list(sharding.shard_shape(tuple(shape)))
        except ValueError:              # XLA pads: round up
            uneven += 1
            out = list(shape)
            for d, e in enumerate(sharding.spec):
                axes = () if e is None else (e,) if isinstance(e, str) \
                    else tuple(e)
                out[d] = -(-out[d] // math.prod(mesh.shape[a]
                                                for a in axes))
            return out

    out = {{}}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke={smoke})
        model = build(cfg)
        base = train.make_rules(cfg, mesh)
        rec = {{}}
        rules = _shape_rules(base, SHAPES["train_4k"], mesh, cfg)
        st = train.abstract_state(model)
        sh = train.state_shardings(model.param_specs(), rules, mesh)
        rec["state"] = [local(s, l.shape) for l, s in
                        zip(jax.tree.leaves(st), jax.tree.leaves(sh))]
        for name, shp in SHAPES.items():
            if not cell_is_runnable(cfg, shp)[0]:
                continue
            rules = _shape_rules(base, shp, mesh, cfg)
            bs = batch_shardings(cfg, shp, mesh, rules)
            cell = {{"batch": {{k: local(bs[k], v.shape) for k, v in
                               input_specs(cfg, shp).items()}}}}
            if shp.kind != "train":
                c = serve.abstract_cache(model, shp.global_batch,
                                         shp.seq_len)
                cs = serve.cache_shardings(c, mesh, rules)
                cell["cache"] = [[local(s, l.shape), str(l.dtype)]
                                 for l, s in zip(jax.tree.leaves(c),
                                                 jax.tree.leaves(cs))]
            rec[name] = cell
        out[arch] = rec
    out["uneven"] = uneven
    print(json.dumps(out))
""")

LOCAL_MESHES = {"smoke-2x2x2": (8, (2, 2, 2), ("pod", "data", "model"), True),
                "full-16x16": (256, (16, 16), ("data", "model"), False)}


@pytest.fixture(scope="module", params=sorted(LOCAL_MESHES))
def ref_local_shapes(request):
    devices, shape, names, smoke = LOCAL_MESHES[request.param]
    code = LOCAL_SHAPES_CHILD.format(devices=devices, shape=shape,
                                     names=names, smoke=smoke)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return (make_mesh(shape, names), smoke,
            json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shapes_equal_the_reference(arch, ref_local_shapes):
    from repro_torch.launch import dryrun
    mesh, smoke, ref = ref_local_shapes
    rec = ref[arch]
    cfg = get_config(arch, smoke)
    model = build(cfg)
    base = train.make_rules(cfg, mesh)

    def local(sharding, leaf):
        return list(sharding.shard_shape(leaf.shape))

    rules = dryrun._shape_rules(base, shapes.SHAPES["train_4k"], mesh, cfg)
    st = train.abstract_state(model)
    sh = train.state_shardings(model.param_specs(), rules, mesh)
    assert [local(s, l) for l, s in zip(tree_leaves(st), tree_leaves(sh))] \
        == rec["state"]
    cells = [n for n, s in shapes.SHAPES.items()
             if shapes.cell_is_runnable(cfg, s)[0]]
    assert cells == [n for n in rec if n != "state"]
    for name in cells:
        shp = shapes.SHAPES[name]
        rules = dryrun._shape_rules(base, shp, mesh, cfg)
        bs = shapes.batch_shardings(cfg, shp, mesh, rules)
        got = {k: local(bs[k], v)
               for k, v in shapes.input_specs(cfg, shp).items()}
        assert got == rec[name]["batch"], name
        if shp.kind != "train":
            c = serve.abstract_cache(model, shp.global_batch, shp.seq_len)
            cs = serve.cache_shardings(c, mesh, rules)
            local_leaves = [
                leaf if isinstance(leaf, int) else torch.empty(
                    local(sh_, leaf), dtype=leaf.dtype, device="meta")
                for leaf, sh_ in zip(tree_leaves(c), tree_leaves(cs))]
            same_cache_leaves(local_leaves, rec[name]["cache"])
