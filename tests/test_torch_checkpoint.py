"""The port's checkpointer (repro_torch.checkpoint) against the
reference's (repro.checkpoint), on the CPU.

The on-disk format interchanges: a checkpoint written by either package
restores in the other with every leaf equal (bf16 bit for bit), and the
two packages write the same manifest for the same state, key for key
(paths, file names, shapes, logical dtypes).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ropt
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.models.common import tree_map
from repro_torch.optim.adamw import state_from_numpy, state_to_numpy


def _meta(tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _ref_template(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)


def _numpy_state(seed):
    """An AdamWState of NumPy arrays with the port's tree layout: dict
    keys, a list of layers, a stacked leaf."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        def r(*s):
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return {"embed": r(16, 8), "final_norm": {"scale": r(8)},
                "layer_list": [{"attn": {"wq": r(8, 2, 4)}, "ln1": r(8)},
                               {"attn": {"wq": r(8, 2, 4)}, "ln1": r(8)}],
                "layers": {"w": r(3, 8, 8)}}
    return ropt.AdamWState(step=np.asarray(7, np.int32), master=tree(1.0),
                           m=tree(0.1), v=jax.tree.map(np.abs, tree(0.01)))


def _assert_tree_equal(port_tree, ref_tree):
    got = jax.tree.leaves(state_to_numpy(port_tree)
                          if isinstance(port_tree, optim.AdamWState)
                          else tree_map(_np, port_tree))
    want = jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.shape(a) == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      b.astype(np.float64))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------------------------ interchange


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    st = _numpy_state(0)
    ref_state = ropt.AdamWState(*jax.tree.map(jnp.asarray, tuple(st)))
    RefCheckpointer(str(tmp_path)).save(3, ref_state, blocking=True)
    port_tmpl = _meta(state_from_numpy(st, device="cpu"))
    got = Checkpointer(str(tmp_path)).restore(port_tmpl, device="cpu")
    assert isinstance(got, optim.AdamWState)
    assert got.step.dtype == torch.int32 and got.step.ndim == 0
    assert got.master["layers"]["w"].device.type == "cpu"
    _assert_tree_equal(got, st)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    st = _numpy_state(1)
    Checkpointer(str(tmp_path)).save(
        4, state_from_numpy(st, device="cpu"), blocking=True)
    ref_tmpl = _ref_template(ropt.AdamWState(
        *jax.tree.map(jnp.asarray, tuple(st))))
    got = RefCheckpointer(str(tmp_path)).restore(ref_tmpl)
    assert int(got.step) == 7
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(st)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_manifests_equal_key_for_key(tmp_path):
    st = _numpy_state(2)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RefCheckpointer(ref_dir).save(
        5, ropt.AdamWState(*jax.tree.map(jnp.asarray, tuple(st))),
        blocking=True)
    Checkpointer(port_dir).save(5, state_from_numpy(st, device="cpu"),
                                blocking=True)
    ref, port = _manifest(ref_dir, 5), _manifest(port_dir, 5)
    assert port == ref
    assert list(port["leaves"]) == list(ref["leaves"])
    assert port["leaves"][".step"] == {"file": "leaf_00000.npy",
                                       "shape": [], "dtype": "int32"}
    assert ".master/layer_list/1/attn/wq" in port["leaves"]
    assert ".v/layers/w" in port["leaves"]
    for key, info in port["leaves"].items():
        a = np.load(os.path.join(port_dir, "step_00000005", info["file"]))
        b = np.load(os.path.join(ref_dir, "step_00000005", info["file"]))
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_bf16_leaf_round_trips_and_interchanges(tmp_path):
    bits = np.random.default_rng(3).integers(0, 2**16, (5, 7),
                                             dtype=np.uint16)
    bits[0, :4] = [0x7F80, 0xFF80, 0x7FC1, 0x0001]   # inf, -inf, nan, tiny
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    tree = {"p": t, "f": torch.arange(3, dtype=torch.float32)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, blocking=True)
    info = _manifest(str(tmp_path), 1)["leaves"]["p"]
    assert info["dtype"] == "bfloat16" and info["shape"] == [5, 7]
    stored = np.load(os.path.join(tmp_path, "step_00000001", info["file"]))
    assert stored.dtype == np.uint16
    np.testing.assert_array_equal(stored, bits)
    back = ck.restore(_meta(tree), device="cpu")
    assert back["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["p"].view(torch.int16).numpy(),
                                  bits.view(np.int16))
    ref = RefCheckpointer(str(tmp_path)).restore(
        {"p": jax.ShapeDtypeStruct((5, 7), jnp.bfloat16),
         "f": jax.ShapeDtypeStruct((3,), jnp.float32)})
    np.testing.assert_array_equal(np.asarray(ref["p"]).view(np.uint16), bits)


def test_reference_bf16_restores_in_the_port(tmp_path):
    vals = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    RefCheckpointer(str(tmp_path)).save(
        2, {"w": jnp.asarray(vals, jnp.bfloat16)}, blocking=True)
    got = Checkpointer(str(tmp_path)).restore(
        {"w": torch.empty((4, 6), dtype=torch.bfloat16, device="meta")},
        device="cpu")
    np.testing.assert_array_equal(
        got["w"].float().numpy(),
        np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32)))


def test_async_save_snapshots_cpu_tensors(tmp_path):
    """In-place updates right after a non-blocking save (what a train step
    that updates its state in place does) do not reach the checkpoint."""
    tree = {"w": torch.full((256, 256), 2.0),
            "b": torch.ones(256, dtype=torch.bfloat16)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)                   # non-blocking
    tree["w"].add_(5.0)
    tree["b"].mul_(3.0)
    ck.wait()
    got = ck.restore(_meta(tree), device="cpu")
    assert float(got["w"].min()) == float(got["w"].max()) == 2.0
    assert float(got["b"].float().min()) == float(got["b"].float().max()) \
        == 1.0


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)}, blocking=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore({"w": torch.empty(2, device="meta")})


def test_missing_leaf_and_no_checkpoint_raise(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.empty(2, device="meta")}, device="cpu")
    ck.save(1, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(KeyError, match="'v'"):
        ck.restore({"v": torch.empty(2, device="meta")}, device="cpu")


def test_failed_write_surfaces_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))

    class Bad:
        pass
    ck.save(1, {"w": np.array([Bad()], dtype=object)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()


# ------------------------------------------------------------ reference cases


class TestCheckpointerReferenceCases:
    """tests/substrate/test_optim_data_ckpt.py::TestCheckpointer, on the
    port."""

    def _tree(self, scale=1.0):
        return {"params": {"w": torch.full((8, 8), scale,
                                           dtype=torch.bfloat16)},
                "opt": {"m": torch.full((8, 8), scale / 2)},
                "step": torch.tensor(7, dtype=torch.int32)}

    def test_roundtrip(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        tree = self._tree(3.0)
        ck.save(100, tree, blocking=True)
        out = ck.restore(_meta(tree), device="cpu")
        np.testing.assert_array_equal(out["params"]["w"].float().numpy(),
                                      3.0)
        assert int(out["step"]) == 7

    def test_latest_and_retention(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, self._tree(float(s)), blocking=True)
        assert ck.latest_step() == 4
        assert ck.all_steps() == [3, 4]

    def test_atomic_no_partial_dirs(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(5, self._tree(), blocking=True)
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))

    def test_shape_mismatch_rejected(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, self._tree(), blocking=True)
        bad = {"params": {"w": torch.empty((4, 4), dtype=torch.bfloat16,
                                           device="meta")},
               "opt": {"m": torch.empty((8, 8), device="meta")},
               "step": torch.empty((), dtype=torch.int32, device="meta")}
        with pytest.raises(ValueError, match="shape"):
            ck.restore(bad, device="cpu")

    def test_async_overlaps(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, self._tree())
        ck.save(2, self._tree())
        ck.wait()
        assert set(ck.all_steps()) == {1, 2}
