"""The port's data pipeline (repro_torch.data) against the reference's
(repro.data), on the CPU.  Batches must be equal, element for element,
for every seed, step, shard count and vocabulary below (the uint64
splitmix arithmetic included)."""
import numpy as np
import pytest

from repro.data import pipeline as rpipe
from repro_torch.data import (EOS, DataConfig, DataLoader, global_batch_at,
                              shard_batch)
from repro_torch.data import pipeline as tpipe


def _both(**kw):
    return rpipe.DataConfig(**kw), DataConfig(**kw)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1])
@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=64, global_batch=8),
    dict(vocab_size=262144, seq_len=1024, global_batch=4),
    dict(vocab_size=3, seq_len=17, global_batch=5, mean_doc_len=2),
    dict(vocab_size=512, seq_len=32, global_batch=2, mean_doc_len=8),
])
def test_global_batch_equals_reference(seed, kw):
    rcfg, tcfg = _both(seed=seed, **kw)
    for step in (0, 1, 17, 4096, 2**33 + 5):
        _equal(global_batch_at(step, tcfg), rpipe.global_batch_at(step, rcfg))


def test_splitmix_equals_reference():
    x = np.array([0, 1, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15],
                 dtype=np.uint64)
    np.testing.assert_array_equal(tpipe._splitmix64(x),
                                  rpipe._splitmix64(x))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_shard_batch_and_loader_equal_reference(shards):
    rcfg, tcfg = _both(vocab_size=777, seq_len=48, global_batch=8, seed=9)
    full_r = rpipe.global_batch_at(6, rcfg)
    for i in range(shards):
        _equal(shard_batch(global_batch_at(6, tcfg), i, shards),
               rpipe.shard_batch(full_r, i, shards))
        rl = rpipe.DataLoader(rcfg, shard=i, num_shards=shards)
        tl = DataLoader(tcfg, shard=i, num_shards=shards)
        for step in (0, 1, 2, 5, 6):
            _equal(tl.batch_at(step), rl.batch_at(step))


def test_shard_batch_refuses_an_uneven_split():
    b = global_batch_at(0, DataConfig(vocab_size=10, seq_len=4,
                                      global_batch=6))
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(b, 0, 4)


def test_iterator_yields_steps_in_order():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2, seed=1)
    it = iter(DataLoader(cfg))
    for step in range(4):
        _equal(next(it), global_batch_at(step, cfg))
    assert EOS == rpipe.EOS == 0


class TestDataReferenceCases:
    """tests/substrate/test_optim_data_ckpt.py::TestData, on the port."""
    CFG = DataConfig(vocab_size=1000, seq_len=64, global_batch=8, seed=3)

    def test_deterministic(self):
        a = global_batch_at(17, self.CFG)
        b = global_batch_at(17, self.CFG)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_steps_differ(self):
        a = global_batch_at(1, self.CFG)
        b = global_batch_at(2, self.CFG)
        assert not np.array_equal(a["tokens"], b["tokens"])

    def test_token_range(self):
        a = global_batch_at(0, self.CFG)
        assert a["tokens"].min() >= 0
        assert a["tokens"].max() < self.CFG.vocab_size

    def test_sharding_partitions(self):
        full = global_batch_at(5, self.CFG)
        parts = [shard_batch(full, i, 4) for i in range(4)]
        recon = np.concatenate([p["tokens"] for p in parts], axis=0)
        np.testing.assert_array_equal(recon, full["tokens"])

    def test_elastic_resharding_same_data(self):
        full = global_batch_at(9, self.CFG)
        two = np.concatenate(
            [shard_batch(full, i, 2)["tokens"] for i in range(2)], axis=0)
        eight = np.concatenate(
            [shard_batch(full, i, 8)["tokens"] for i in range(8)], axis=0)
        np.testing.assert_array_equal(two, eight)

    def test_loader_prefetch_consistent(self):
        dl = DataLoader(self.CFG, shard=1, num_shards=2)
        dl.batch_at(0)
        b1 = dl.batch_at(1)     # served from prefetch
        ref = shard_batch(global_batch_at(1, self.CFG), 1, 2)
        np.testing.assert_array_equal(b1["tokens"], ref["tokens"])
