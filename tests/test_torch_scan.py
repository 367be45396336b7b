"""The chunked scans of the SSM mixers (`models.common.scan`) and the dry
run's counted scans (`launch.dryrun._Trace.scan`).

* On plain tensors `scan` is the Python loop `models/ssm.py` wrote
  before it (each chunk under `remat(step, "full")`, stacked on
  dimension 1): `mamba_chunked`'s and `wkv6_chunked`'s outputs and
  gradients are bit for bit that loop's.
* Under the dry run's trace a scan of more than 2 * SCAN_RUN trips runs
  the first and last SCAN_RUN and counts the others by a run trip's
  increment.  Every additive count, the collectives and the peak equal
  those of running every trip, for hymba's Mamba scan and rwkv6's WKV
  scan at smoke width, in every step kind (a train step without and
  with remat, whose backward recomputes each layer's scan, a prefill,
  a decode step, which scans no chunks), at 2, 3, 7 and 10 trips (7 is
  the fewest a scan counts, one trip), on a plain trace and on a
  partitioned one (a (2, 2, 2) mesh: DTensors, contract's partial
  gradients).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec, batch_shardings, input_specs
from repro_torch.models import common, ssm
from test_torch_dryrun import STEP_KINDS, _inputs

ARCHS = ("hymba-1.5b", "rwkv6-7b")
# Trips a scan makes (a sequence of 16 tokens a chunk).
TRIPS = (2, 3, 7, 10)
CASES = [(step, trips) for step in ("train", "train-remat", "prefill")
         for trips in TRIPS] + [("decode", 2)]
KEYS = (*dryrun._ADDITIVE, "peak", "coll_micro", "coll_once")


def _counted(cfg, kind, trips) -> int:
    """The trips a trace counts: of each layer's scan, all but the
    2 * SCAN_RUN it runs; twice in a train step with remat (the layer's
    forward, and its recomputation in the backward pass)."""
    if kind == "decode" or trips <= 2 * dryrun.SCAN_RUN:
        return 0
    runs = 2 if kind == "train" and cfg.remat != "none" else 1
    return cfg.num_layers * runs * (trips - 2 * dryrun.SCAN_RUN)


def _every_trip_run(trace, monkeypatch):
    """`trace()` with every scan trip run (no scan has more than twice
    SCAN_RUN trips)."""
    with monkeypatch.context() as patch:
        patch.setattr(dryrun, "SCAN_RUN", 10 ** 9)
        return trace()


@pytest.mark.parametrize("step,trips", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_counted_scan_equals_every_trip_run(arch, step, trips, monkeypatch):
    kind, remat = STEP_KINDS[step]
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    inputs = _inputs(cfg, kind, s=16 * trips)

    def trace():
        return dryrun.trace_step(cfg, kind, inputs, 256)
    counted = trace()
    run = _every_trip_run(trace, monkeypatch)
    for key in KEYS:
        assert counted[key] == run[key], key
    assert counted["scan_trips_counted"] == _counted(cfg, kind, trips)
    assert run["scan_trips_counted"] == 0


@pytest.mark.parametrize("step", ["train-remat", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counted_scan_equals_every_trip_run_partitioned(arch, step,
                                                       monkeypatch):
    """On a (2, 2, 2) mesh, one layer, 7 trips: the step's DTensors, and
    no collective in a trip (the chunks' products keep batch and
    channels split, `models.common.contract`)."""
    kind, remat = STEP_KINDS[step]
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat,
                              num_layers=1)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = ShapeSpec("mini", 112, 8, kind)
    rules = dryrun._shape_rules(train_lib.make_rules(cfg, mesh), shape,
                                mesh, cfg)
    b_shard = batch_shardings(cfg, shape, mesh, rules)
    n_micro = dryrun._n_micro(cfg, shape, mesh) if kind == "train" else 1
    inputs = dryrun._trace_inputs(input_specs(cfg, shape), b_shard,
                                  n_micro, True)
    def trace():
        return dryrun.trace_step(cfg, kind, inputs, 112, rules, mesh=mesh,
                                 shardings={k: b_shard[k] for k in inputs})
    out = {True: trace(), False: _every_trip_run(trace, monkeypatch)}
    for key in KEYS:
        assert out[True][key] == out[False][key], key
    assert out[True]["scan_trips_counted"] == _counted(cfg, kind, 7)
    assert not out[True]["scan_collectives"]


def _loop(step, carry, xs):
    """The loop `scan` took the place of, as `models/ssm.py` wrote it."""
    step = common.remat(step, "full")
    ys = []
    for i in range(xs[0].shape[1]):
        carry, y = step(carry, *[x[:, i] for x in xs])
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _mamba(rng, b=2, s=64, e=8, n=4):
    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, requires_grad=True)
    dt = torch.tensor(rng.uniform(0.01, 0.2, (b, s, e)), dtype=torch.float32,
                      requires_grad=True)
    A = torch.tensor(-rng.uniform(0.5, 2.0, (e, n)), dtype=torch.float32,
                     requires_grad=True)
    return (ssm.mamba_chunked,
            (t(b, s, e), dt, A, t(b, s, n), t(b, s, n), t(e), t(b, e, n)))


def _wkv6(rng, b=2, s=64, h=2, k=4):
    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            requires_grad=True)
    w = torch.tensor(rng.uniform(0.5, 0.99, (b, s, h, k)),
                     dtype=torch.float32, requires_grad=True)
    return (ssm.wkv6_chunked,
            (t(b, s, h, k), t(b, s, h, k), t(b, s, h, k), w, t(h, k),
             t(b, h, k, k)))


@pytest.mark.parametrize("make", [_mamba, _wkv6])
def test_scan_is_the_loop_it_replaced(make, monkeypatch):
    """`mamba_chunked` and `wkv6_chunked` on plain tensors: outputs and
    every input's gradient bit for bit those of the loop before `scan`."""
    got = {}
    for loop in (common.scan, _loop):
        monkeypatch.setattr(ssm, "scan", loop)
        fn, args = make(np.random.default_rng(0))
        y, state = fn(*args)
        (y.square().sum() + state.sum()).backward()
        got[loop] = [y, state] + [a.grad for a in args]
    for new, old in zip(got[common.scan], got[_loop]):
        assert torch.equal(new, old)
