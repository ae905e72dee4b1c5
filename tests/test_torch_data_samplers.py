"""apex_tpu_torch's data path against the JAX package's: the Megatron
pretraining samplers' index streams (sequential and shuffled, with
resume and rampup), ``RobustBatches``' skips and its budget, and the
batches the GPT example reads through them.

Index streams, skip counts and batch bytes are compared exactly.
"""

import itertools

import numpy as np
import pytest

from apex_tpu.data import IndexedTokenDataset
from apex_tpu.data import LMDataset as JaxLMDataset
from apex_tpu.data import batchsampler as jbs
from apex_tpu.data import robust as jrobust
from apex_tpu_torch.data import IndexedTokenDataset as PortIndexedTokenDataset
from apex_tpu_torch.data import (
    LMDataset,
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
    RobustBatches,
    SkipBudgetExceeded,
)
from apex_tpu_torch.resilience.replay import synthetic_corpus
from apex_tpu_torch.resilience.replay.journal import batch_crc


def _stream(sampler, n=None, rampup_at=None, new_size=None):
    out = []
    for i, batch in enumerate(itertools.islice(iter(sampler), n)):
        out.append(list(batch))
        if rampup_at is not None and i == rampup_at:
            sampler.local_minibatch_size = new_size
    return out


@pytest.mark.parametrize("total,consumed,mbs,rank,size,drop_last", [
    (100, 0, 4, 0, 1, True),
    (100, 37, 4, 1, 2, True),
    (103, 8, 5, 2, 3, False),
    (64, 0, 16, 0, 1, True),
])
def test_sequential_sampler_matches_jax(total, consumed, mbs, rank, size,
                                        drop_last):
    args = (total, consumed, mbs, rank, size)
    want = _stream(jbs.MegatronPretrainingSampler(*args, drop_last=drop_last))
    got = _stream(MegatronPretrainingSampler(*args, drop_last=drop_last))
    assert got == want and got
    # a batch-size rampup mid-stream
    want = _stream(jbs.MegatronPretrainingSampler(*args), rampup_at=2,
                   new_size=mbs + 2)
    got = _stream(MegatronPretrainingSampler(*args), rampup_at=2,
                  new_size=mbs + 2)
    assert got == want


@pytest.mark.parametrize("total,consumed,mbs,rank,size,seed", [
    (100, 0, 4, 0, 1, 0),
    (100, 40, 4, 1, 2, 3),
    (257, 130, 8, 3, 4, 7),
])
def test_random_sampler_matches_jax(total, consumed, mbs, rank, size, seed):
    """The same numpy permutation draws, epoch for epoch."""
    args = (total, consumed, mbs, rank, size)
    js = jbs.MegatronPretrainingRandomSampler(*args, seed=seed)
    ps = MegatronPretrainingRandomSampler(*args, seed=seed)
    assert _stream(ps) == _stream(js)
    assert ps.consumed_samples == js.consumed_samples
    # the next epoch, from where the first left off
    assert _stream(ps, 5) == _stream(js, 5)


def test_samplers_refuse_what_jax_refuses():
    for args in [(0, 0, 4, 0, 1), (10, 10, 4, 0, 1), (10, 0, 4, 2, 2),
                 (10, 0, 0, 0, 1)]:
        with pytest.raises(RuntimeError):
            jbs.MegatronPretrainingSampler(*args)
        with pytest.raises(RuntimeError):
            MegatronPretrainingSampler(*args)
    with pytest.raises(RuntimeError):
        MegatronPretrainingRandomSampler(4, 0, 8, 0, 1)


def _flaky(fail_on):
    calls = iter(range(10_000))

    def load():
        i = next(calls)
        if i >= 12:
            raise StopIteration
        if i in fail_on:
            raise OSError(f"bad page at load {i}")
        return i

    return load


@pytest.mark.parametrize("fail_on,budget", [
    ((), 0), ((1, 2, 7), 3), ((0, 1, 2, 3), 2), ((5,), 0)])
def test_robust_batches_skip_as_jax_does(fail_on, budget):
    """Each package over the same failing loader: the same batches, the
    same skip count, and the budget blown at the same load."""
    def run(cls, exc):
        batches = cls(_flaky(set(fail_on)), max_skips=budget)
        got = []
        try:
            while True:
                got.append(batches())
        except StopIteration:
            got.append("end")
        except exc:
            got.append("budget")
        return got, batches.skipped

    assert run(RobustBatches, SkipBudgetExceeded) == run(
        jrobust.RobustBatches, jrobust.SkipBudgetExceeded)
    with pytest.raises(ValueError):
        RobustBatches(lambda: 0, max_skips=-1)


def test_example_batches_and_their_crc_equal_jax(tmp_path):
    """The GPT example's stream: the sampler's ids over the synthetic
    corpus give JAX's batches byte for byte, and the journal's
    ``batch_crc`` of them is JAX's."""
    from apex_tpu.resilience.replay.journal import batch_crc as jax_crc

    prefix = synthetic_corpus(128, 20_000)
    jlm = JaxLMDataset(IndexedTokenDataset(prefix), seq_len=32)
    lm = LMDataset(PortIndexedTokenDataset(prefix), 32)
    assert len(lm) == len(jlm)
    for ids in _stream(MegatronPretrainingSampler(len(lm), 48, 16, 0, 1), 4):
        x, y = lm.batch(ids)
        jx, jy = jlm.batch(ids)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert batch_crc(x, y) == jax_crc(jx, jy)
