"""The port's KmerCounter and count_reads_files against the JAX package.

Same inputs (numpy seeds) through metafast_tpu.ops.count.KmerCounter /
metafast_tpu.api.count_reads_files and their port counterparts on the
CPU; tables must be exactly equal.
"""

import numpy as np
import pytest
import torch

from metafast_tpu import api as japi
from metafast_tpu.ops.count import KmerCounter as JCounter
from metafast_tpu_torch import api as tapi
from metafast_tpu_torch.ops import stream_extract as TSE
from metafast_tpu_torch.ops.count import SATURATE, KmerCounter
from test_stream_extract import _random_reads
from torch_helpers import write_samples

CPU = torch.device("cpu")


def _port_count(codes, lengths, k, chunk, layout, batches=3):
    c = KmerCounter(k, "cpu", chunk=chunk)
    offs = np.r_[0, np.cumsum(lengths.astype(np.int64))]
    cuts = np.linspace(0, len(lengths), batches + 1).astype(int)
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        cs, ls = codes[offs[r0]:offs[r1]], lengths[r0:r1]
        if layout == "stream3":
            c.add_stream3_device(*TSE.to_device(TSE.build_stream3(cs, ls, k),
                                                CPU), ls)
        else:
            c.add_stream_device(*TSE.to_device(TSE.build_stream(cs, ls, k),
                                               CPU), ls)
    return c


@pytest.mark.parametrize("layout", ["stream3", "columns"])
@pytest.mark.parametrize("k,chunk", [(11, 1 << 27), (16, 5000), (31, 3000)])
def test_counter_matches_jax(k, chunk, layout):
    rng = np.random.default_rng(600 + k)
    codes, lengths = _random_reads(rng, k, n_reads=300)
    # repeat half of the reads so counts exceed 1
    half = len(lengths) // 2
    codes = np.concatenate([codes, codes[: int(lengths[:half].sum())]])
    lengths = np.concatenate([lengths, lengths[:half]])
    j = JCounter(k)
    j.add_stream3(codes, lengths)
    want_keys, want_counts = j.finish()
    c = _port_count(codes, lengths, k, chunk, layout)
    keys, counts = c.finish()
    assert keys.dtype == np.int64 and counts.dtype == np.int32
    assert np.array_equal(keys, want_keys)
    assert np.array_equal(counts, want_counts)
    assert c.total_kmers_seen == j.total_kmers_seen
    assert counts.max() > 1


def test_saturating_merge_matches_jax():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 4 ** 21, 3000, dtype=np.int64))
    c1 = rng.integers(SATURATE - 20, SATURATE + 1, len(keys)).astype(np.int32)
    c2 = rng.integers(0, 40, len(keys)).astype(np.int32)
    extra = np.unique(rng.integers(0, 4 ** 21, 500, dtype=np.int64))
    ce = rng.integers(1, SATURATE + 1, len(extra)).astype(np.int32)
    j = JCounter(21)
    t = KmerCounter(21, "cpu", chunk=64)
    for kk, cc in ((keys, c1), (keys, c2), (extra, ce), (keys[::3], c1[::3])):
        j.add_keys(kk, cc)
        t.add_keys(kk, cc)
    codes, lengths = _random_reads(rng, 21, n_reads=50)
    j.add_stream3(codes, lengths)
    t.add_stream3_device(*TSE.to_device(TSE.build_stream3(codes, lengths, 21),
                                        CPU), lengths)
    want = j.finish()
    got = t.finish()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[1].max() == SATURATE


def test_empty_counter():
    keys, counts = KmerCounter(31, "cpu").finish()
    assert keys.shape == (0,) and counts.shape == (0,)
    assert keys.dtype == np.int64 and counts.dtype == np.int32


def test_count_reads_files_matches_jax(tmp_path, monkeypatch):
    files = write_samples(tmp_path, 2, 4000, 1000, 8, read_len=100, seed=3)
    # small slabs: the slab loop runs many times
    monkeypatch.setattr(tapi, "SLAB_CODES", 3000)
    want_keys, want_counts, want_stats = japi.count_reads_files(files, 25)
    keys, counts, stats = tapi.count_reads_files(files, 25, "cpu",
                                                 progress=lambda d: None)
    assert np.array_equal(keys.numpy(), want_keys)
    assert np.array_equal(counts.numpy(), want_counts)
    assert stats == want_stats


def test_count_reads_files_min_len(tmp_path):
    path = tmp_path / "mixed.fa"
    path.write_text(">a\nACGTACGTAGGCTAGCTAGGATCGA\n>b\nACGTTGCA\n"
                    ">c\nTTGACCGATGCATGCNNACGATGCATCGATCGAAGT\n")
    for min_len in (0, 20):
        want = japi.count_reads_files([str(path)], 5, min_len=min_len)
        got = tapi.count_reads_files([str(path)], 5, "cpu", min_len=min_len)
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy(), want[1])
        assert got[2] == want[2]


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        KmerCounter(31, "cuda")
