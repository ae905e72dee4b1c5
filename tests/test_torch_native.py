"""The native host runtime and the memory-mapped token files against the
JAX package's: ``apex_tpu_torch._native`` (the port's own copy of the C++
library, built with g++ into the kernels' cache) bit-equal to
``apex_tpu._native`` on every function, for int32 and uint16 tokens,
below and above the threaded gather's 8 MB threshold; its bounds checks
and its refusals where the JAX package falls back to numpy;
``IndexedTokenDataset`` and ``LMDataset`` over one token file equal to
JAX's (batches, epoch permutations, the dtype sidecar's errors); and the
GPT example reading ``--corpus PREFIX`` in JAX's sampler order, its
journal replaying.

Everything here is compared exactly.
"""

import os
import signal

import numpy as np
import pytest
import torch

from apex_tpu import _native as jax_native
from apex_tpu.data import IndexedTokenDataset as JaxIndexedTokenDataset
from apex_tpu.data import LMDataset as JaxLMDataset
from apex_tpu.data import write_token_file as jax_write_token_file
from apex_tpu_torch import _kernels, _native
from apex_tpu_torch.data import (
    IndexedTokenDataset,
    LMDataset,
    write_token_file,
)
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import spans as port_spans

DTYPES = [np.int32, np.uint16]


@pytest.fixture(autouse=True)
def _restore_process_state():
    """The GPT example's router installs a SIGTERM flush and flush hooks,
    and its AutoResume a SIGTERM latch: put them back after each test; its
    tiny steps run on one intra-op thread (the other test workers share
    the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    handler = signal.getsignal(signal.SIGTERM)
    hooks = list(port_router._FLUSH_HOOKS)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_router._FLUSH_HOOKS[:] = hooks
    port_spans.set_router(None)
    torch.set_num_threads(threads)


def _tokens(n, dtype, seed=0):
    hi = 50257 if dtype == np.int32 else 65535
    return np.random.RandomState(seed).randint(0, hi, n).astype(dtype)


# -- the library -------------------------------------------------------------

def test_the_library_is_the_ports_own_build_at_abi_2():
    lib = _native.library()
    assert lib.apex_tpu_native_abi_version() == _native.ABI_VERSION == 2
    path = _kernels.host_library_path("apex_tpu_C")
    assert path.exists() and path.parent == _kernels._BUILD
    assert path.name.startswith("libapex_tpu_C-")
    # the build's temp file was renamed into place
    assert not [p for p in path.parent.iterdir() if p.suffix == ".tmp"]
    # the port compiles its own copy: the same C ABI as the JAX source
    ours = (_kernels._CSRC / "apex_tpu_C.cpp").read_text()
    theirs = open(os.path.join(os.path.dirname(_kernels._CSRC.parent),
                               "csrc", "apex_tpu_C.cpp")).read()
    start = ours.index("#include <cstdint>")
    assert ours[start:] == theirs[theirs.index("#include <cstdint>"):]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,row_len", [(0, 9), (1, 1), (7, 33),
                                          (300, 129),   # 155 kB or 77 kB
                                          (1100, 2049)])  # 9 MB or 4.5 MB
def test_gather_rows_bit_equal_to_jax(dtype, rows, row_len):
    data = _tokens(rows * row_len + 5000, dtype)
    offs = np.random.RandomState(1).randint(0, len(data) - row_len + 1,
                                            rows)
    got = _native.gather_rows(data, offs, row_len)
    want = jax_native.gather_rows(data, offs, row_len)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[offs[:, None]
                                            + np.arange(row_len)])


def test_gather_rows_threads_past_8_mb(monkeypatch):
    """The threaded route runs exactly where JAX's does (8 MB of output
    and more than one thread), and gives the same rows."""
    calls = []
    lib = _native.library()
    real = lib.gather_rows_i32_mt

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(lib, "gather_rows_i32_mt", counted)
    data = _tokens(3_000_000, np.int32)
    small = _native.gather_rows(data, np.arange(4) * 2048, 2049)
    big = _native.gather_rows(data, np.arange(1024) * 2048, 2049)
    assert big.nbytes >= _native._MT_BYTES_THRESHOLD > small.nbytes
    assert calls == [1, _native._MT_THREADS]
    np.testing.assert_array_equal(
        big, jax_native.gather_rows(data, np.arange(1024) * 2048, 2049))


@pytest.mark.parametrize("offsets", [[-1], [0, 95], [100]])
def test_gather_rows_out_of_bounds_raises_index_error(offsets):
    data = _tokens(100, np.int32)
    for native in (_native, jax_native):
        with pytest.raises(IndexError, match="out of bounds"):
            native.gather_rows(data, np.asarray(offsets), 8)


def test_gather_rows_refuses_a_dtype_the_library_lacks():
    """JAX gathers int64 tokens with numpy; the port has no such route."""
    data = np.arange(100, dtype=np.int64)
    np.testing.assert_array_equal(jax_native.gather_rows(data, [3], 4),
                                  [[3, 4, 5, 6]])
    with pytest.raises(TypeError, match="int32 or uint16"):
        _native.gather_rows(data, [3], 4)


@pytest.mark.parametrize("shapes", [[], [()], [(3,), (2, 5), (), (1, 1, 7)],
                                    [(4096, 33)]])
def test_flatten_and_unflatten_bit_equal_to_jax(shapes):
    rs = np.random.RandomState(2)
    bufs = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    flat = _native.flatten(bufs)
    np.testing.assert_array_equal(flat, jax_native.flatten(bufs))
    assert flat.dtype == np.float32
    back = _native.unflatten(np.concatenate([flat, [9.0]]), shapes)
    for got, want, b in zip(back, jax_native.unflatten(flat, shapes), bufs):
        assert got.shape == want.shape == b.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, b)


def test_unflatten_refuses_shapes_past_the_buffer():
    for native in (_native, jax_native):
        with pytest.raises(ValueError, match="exceed flat buffer"):
            native.unflatten(np.zeros(5, np.float32), [(2, 3)])


@pytest.mark.parametrize("n", [0, 1, 2, 1000, 100_003])
@pytest.mark.parametrize("seed", [0, 7, 2**62 + 12345])
def test_permutation_bit_equal_to_jax(n, seed):
    got = _native.permutation(n, seed)
    np.testing.assert_array_equal(got, jax_native.permutation(n, seed))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("n_tokens,seq_len", [(0, 8), (8, 8), (9, 8),
                                              (1000, 64), (200_000, 1024),
                                              (5, 1)])
def test_lm_sample_offsets_bit_equal_to_jax(n_tokens, seq_len):
    got = _native.lm_sample_offsets(n_tokens, seq_len)
    np.testing.assert_array_equal(
        got, jax_native.lm_sample_offsets(n_tokens, seq_len))
    assert got.dtype == np.int64


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """A process with no library loaded yet, building into a temp cache."""
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path / "build")
    return tmp_path


def test_the_wrappers_raise_without_g_plus_plus(fresh_library, monkeypatch):
    """No compiler, no library: every wrapper raises (JAX's falls back)."""
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _native.permutation(4, 0)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _native.gather_rows(_tokens(10, np.int32), [0], 2)
    assert _native._LIB is None


@pytest.mark.parametrize("source,match", [
    ("int broken(", "g\\+\\+ failed"),
    ('extern "C" long apex_tpu_native_abi_version() { return 3; }',
     "speaks ABI 3"),
    ('extern "C" int unrelated() { return 0; }', "no ABI version"),
])
def test_a_library_that_does_not_build_or_speaks_another_abi_raises(
        fresh_library, monkeypatch, source, match):
    csrc = fresh_library / "csrc"
    csrc.mkdir()
    (csrc / "apex_tpu_C.cpp").write_text(source + "\n")
    monkeypatch.setattr(_kernels, "_CSRC", csrc)
    with pytest.raises(RuntimeError, match=match):
        _native.lm_sample_offsets(100, 8)
    assert not list((fresh_library / "build").glob("*.tmp"))


# -- token files ------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_token_file_batches_and_permutation_equal_jax(tmp_path, dtype):
    tokens = _tokens(40_000, dtype, seed=3)
    prefix = str(tmp_path / "corpus")
    docs = [0, 17, 900, 33_000]
    assert write_token_file(prefix, tokens, doc_offsets=docs) == \
        prefix + ".bin"
    ds, jds = IndexedTokenDataset(prefix), JaxIndexedTokenDataset(prefix)
    assert len(ds) == len(jds) == 40_000 and ds.tokens.dtype == dtype
    np.testing.assert_array_equal(ds.doc_offsets, jds.doc_offsets)
    for seq in (64, 1024):
        lm, jlm = LMDataset(ds, seq), JaxLMDataset(jds, seq_len=seq)
        assert len(lm) == len(jlm) == (40_000 - 1) // seq
        np.testing.assert_array_equal(lm.offsets, jlm.offsets)
        ids = np.random.RandomState(4).permutation(len(lm))[:16]
        for got, want in zip(lm.batch(ids), jlm.batch(ids)):
            assert got.dtype == dtype
            np.testing.assert_array_equal(got, want)
        for epoch, seed in ((0, 0), (3, 11)):
            np.testing.assert_array_equal(
                lm.epoch_permutation(epoch, seed),
                jlm.epoch_permutation(epoch, seed))


def test_the_packages_read_each_others_files(tmp_path):
    tokens = _tokens(5000, np.uint16, seed=5)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    write_token_file(ours, tokens)
    jax_write_token_file(theirs, tokens)
    for suffix in (".bin", ".dtype"):
        with open(ours + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read()
    np.testing.assert_array_equal(IndexedTokenDataset(theirs).tokens, tokens)


def test_dtype_sidecar_errors_match_jax(tmp_path):
    prefix = str(tmp_path / "c")
    write_token_file(prefix, _tokens(101, np.uint16))
    for cls in (IndexedTokenDataset, JaxIndexedTokenDataset):
        # the sidecar wins; a contradicting request raises
        assert cls(prefix).tokens.dtype == np.uint16
        with pytest.raises(ValueError, match="!= recorded"):
            cls(prefix, dtype=np.int32)
        with pytest.raises(FileNotFoundError):
            cls(str(tmp_path / "missing"))
    os.remove(prefix + ".dtype")
    for cls in (IndexedTokenDataset, JaxIndexedTokenDataset):
        # no sidecar: int32 by default, and 202 bytes are not int32s
        with pytest.raises(ValueError, match="not a multiple"):
            cls(prefix)
        assert len(cls(prefix, dtype=np.uint16)) == 101
    with pytest.raises(TypeError, match="int32 or uint16"):
        write_token_file(str(tmp_path / "d"), np.arange(4, dtype=np.int64))


def test_lm_batch_past_the_stream_raises_as_jax(tmp_path):
    prefix = str(tmp_path / "c")
    write_token_file(prefix, _tokens(1000, np.int32))
    lm = LMDataset(IndexedTokenDataset(prefix), 64)
    with pytest.raises(IndexError):
        lm.batch([len(lm)])


# -- the GPT example over a token file --------------------------------------

def test_gpt_example_reads_a_corpus_in_jax_sampler_order_and_replays(
        tmp_path):
    """``--corpus PREFIX``: the example's first batches are JAX's
    ``LMDataset`` batches of the same file in JAX's sampler order (their
    crc32s in the journal), the journal header names the file with no
    synthetic recipe, and the journal replays from it bitwise (the
    replayer reads token files)."""
    from apex_tpu.data.batchsampler import (
        MegatronPretrainingSampler as JaxSampler,
    )
    from apex_tpu.resilience.replay.journal import batch_crc as jax_crc
    from apex_tpu_torch.examples.gpt import pretrain_gpt
    from apex_tpu_torch.resilience.replay import load_journal
    from apex_tpu_torch.resilience.replay.__main__ import main as replay

    prefix = str(tmp_path / "corpus")
    write_token_file(prefix, _tokens(3_000, np.uint16, seed=6) % 128)
    save = str(tmp_path / "ck")
    records = pretrain_gpt.main([
        "--device", "cpu", "--corpus", prefix, "--steps", "4", "--layers",
        "1", "--hidden", "32", "--heads", "2", "--seq-len", "16",
        "--micro-batch", "1", "--global-batch", "8", "--vocab", "128",
        "--log-interval", "2", "--save", save, "--save-interval", "2"])
    assert [r["step"] for r in records] == [0, 1, 2, 3]
    journal = load_journal(save)
    assert journal.header["corpus"] == {"prefix": prefix}
    jlm = JaxLMDataset(JaxIndexedTokenDataset(prefix), seq_len=16)
    it = iter(JaxSampler(len(jlm), 0, 8, 0, 1))
    for step in range(4):
        ids = list(next(it))
        assert journal.steps[step]["batch"] == [ids[0], ids[-1] + 1]
        assert journal.steps[step]["batch_crc"] == jax_crc(*jlm.batch(ids))
    assert replay([save, "--device", "cpu"]) == 0
