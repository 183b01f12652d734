"""The port's read-batch counting route against the JAX package, on the CPU.

Batch extraction (core.extract), the counter's batch routes, add_counted,
the host spill, count_reads_files on BINQ input (the Python reader's route)
and the whole pipeline with a BINQ sample: the same numpy-seeded inputs
through both packages, exact equality.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metafast_tpu import api as japi
from metafast_tpu.core import extract as jextract
from metafast_tpu.io import native_reads
from metafast_tpu.ops.count import KmerCounter as JCounter
from metafast_tpu.pipeline import matrix_pipeline as jax_pipeline
from metafast_tpu_torch import api as tapi
from metafast_tpu_torch.core import extract
from metafast_tpu_torch.ops.count import (SpilledError, KmerCounter,
                                          card_spill, count_batch,
                                          count_batch_packed)
from metafast_tpu_torch.pipeline import matrix_pipeline
from metafast_tpu_torch.state import join_pairs
from torch_helpers import write_samples

KS = [1, 11, 16, 17, 31]


def _batch(rng, k, B=40, L=128):
    """Padded codes [B, L] with random padding and lengths, some < k."""
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(max(0, k - 3), L + 1, B).astype(np.int32)
    return codes, lengths


def _assert_extract_equal(got, want):
    keys, valid = got
    hi, lo, jvalid = (np.asarray(a) for a in want)
    assert keys.dtype == torch.int64 and valid.dtype == torch.bool
    assert np.array_equal(valid.numpy(), jvalid)
    assert np.array_equal(keys.numpy(), join_pairs(hi, lo))


@pytest.mark.parametrize("k", KS)
def test_extract_canonical_matches_jax(k):
    codes, lengths = _batch(np.random.default_rng(k), k)
    want = jextract.extract_canonical(jnp.asarray(codes),
                                      jnp.asarray(lengths), k)
    _assert_extract_equal(extract.extract_canonical(
        torch.from_numpy(codes), torch.from_numpy(lengths), k), want)


@pytest.mark.parametrize("k", KS)
def test_extract_packed_matches_jax(k):
    codes, lengths = _batch(np.random.default_rng(50 + k), k)
    packed = native_reads.pack_2bit(codes)
    L = codes.shape[1] - 2          # a row length that is not a multiple of 4
    unpacked = extract.unpack_2bit(torch.from_numpy(packed), L)
    assert np.array_equal(unpacked.numpy(),
                          np.asarray(jextract.unpack_2bit(
                              jnp.asarray(packed), L)))
    assert np.array_equal(unpacked.numpy(), codes[:, :L])
    want = jextract.extract_canonical_packed(
        jnp.asarray(packed), jnp.asarray(np.minimum(lengths, L)), k, L)
    _assert_extract_equal(extract.extract_canonical_packed(
        torch.from_numpy(packed), torch.from_numpy(np.minimum(lengths, L)),
        k, L), want)


def test_extract_rejects_k_above_length():
    with pytest.raises(ValueError):
        extract.extract_canonical(torch.zeros((2, 10), dtype=torch.uint8),
                                  torch.tensor([10, 10]), 11)


@pytest.mark.parametrize("k", [11, 31])
def test_count_batch_matches_jax(k):
    from metafast_tpu.ops.count import count_batch as jcount_batch

    codes, lengths = _batch(np.random.default_rng(70 + k), k)
    codes = np.concatenate([codes, codes])         # counts above 1
    lengths = np.concatenate([lengths, lengths])
    uh, ul, jc = (np.asarray(a) for a in jcount_batch(
        jnp.asarray(codes), jnp.asarray(lengths), k))
    live = jc > 0
    packed = native_reads.pack_2bit(codes)
    for keys, counts in (
            count_batch(torch.from_numpy(codes), torch.from_numpy(lengths),
                        k),
            count_batch_packed(torch.from_numpy(packed),
                               torch.from_numpy(lengths), k,
                               codes.shape[1])):
        assert np.array_equal(keys.numpy(), join_pairs(uh[live], ul[live]))
        assert np.array_equal(counts.numpy(), jc[live])
    assert jc.max() > 1


@pytest.mark.parametrize("chunk", [1 << 27, 3000])
@pytest.mark.parametrize("k", [11, 31])
def test_counter_batch_routes_match_jax(k, chunk):
    """add_batch, add_packed_batch and add_counted through finish()."""
    rng = np.random.default_rng(90 + k)
    batches = [_batch(rng, k, B=30) for _ in range(4)]
    batches.append(batches[0])                      # counts above 1
    extra_keys = np.unique(rng.integers(0, 4 ** k, 200, dtype=np.int64))
    extra_counts = rng.integers(1, 40000, len(extra_keys)).astype(np.int32)
    j = JCounter(k, chunk=chunk)
    t = KmerCounter(k, "cpu", chunk=chunk)
    for i, (codes, lengths) in enumerate(batches):
        if i % 2:
            packed = native_reads.pack_2bit(codes)
            j.add_packed_batch(packed, lengths, codes.shape[1])
            t.add_packed_batch(packed, lengths, codes.shape[1])
        else:
            j.add_batch(codes, lengths)
            t.add_batch(torch.from_numpy(codes), torch.from_numpy(lengths))
    ek = extra_keys.astype(np.uint64)
    j.add_counted((ek >> np.uint64(32)).astype(np.uint32),
                  (ek & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                  extra_counts)
    t.add_counted(torch.from_numpy(extra_keys),
                  torch.from_numpy(extra_counts))
    want = j.finish()
    got = t.finish()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert t.total_kmers_seen == j.total_kmers_seen
    assert got[1].max() == 32767


def test_zero_count_keys_dropped_like_jax():
    """Port fault found while porting add_counted: the port kept keys whose
    total count is 0; the JAX counter drops them."""
    keys = np.array([5, 9, 12], np.int64)
    counts = np.array([0, 3, 0], np.int32)
    j = JCounter(11)
    t = KmerCounter(11, "cpu")
    j.add_keys(keys, counts)
    t.add_keys(keys, counts)
    want, got = j.finish(), t.finish()
    assert np.array_equal(got[0], want[0]) and list(got[0]) == [9]
    assert np.array_equal(got[1], want[1])


def _spill_batches():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 4, (400, 100), dtype=np.uint8),
             np.full(400, 100, np.int32)) for _ in range(6)]


def test_spill_equals_no_spill():
    """Tables past the spill threshold move to host RAM; the result is the
    no-spill result and the JAX package's."""
    batches = _spill_batches()

    def run(spill):
        c = KmerCounter(11, "cpu", chunk=1 << 14, spill=spill)
        for codes, lengths in batches:
            c.add_batch(codes, lengths)
        return c, c.finish()

    ref_counter, ref = run(None)
    sp_counter, sp = run(1 << 12)
    j = JCounter(11, chunk=1 << 14, spill=1 << 12)
    for codes, lengths in batches:
        j.add_batch(codes, lengths)
    want = j.finish()
    assert ref_counter.spill_events == 0
    assert sp_counter.spill_events >= 2
    for got in (ref, sp):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_finish_device_raises_after_spill():
    codes, lengths = _spill_batches()[0]
    c = KmerCounter(11, "cpu", chunk=1 << 12, spill=1 << 10)
    c.add_batch(codes, lengths)
    with pytest.raises(SpilledError, match="spill"):
        c.finish_device()
    assert isinstance(SpilledError("x"), RuntimeError)
    keys, counts = c.finish()
    want = KmerCounter(11, "cpu", spill=None)
    want.add_batch(codes, lengths)
    assert np.array_equal(keys, want.finish()[0])


@pytest.mark.parametrize("n_reads", [1, 57])
def test_write_binq_bytes_and_read_back(tmp_path, n_reads):
    """The port's BINQ writer: the record layout byte for byte, and the
    Python reader (api.read_batches) gives the reads back; the packed
    batches of the same reads count the same."""
    rng = np.random.default_rng(40 + n_reads)
    lengths = rng.integers(1, 90, n_reads).astype(np.int32)
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    phred = rng.integers(1, 41, len(codes)).astype(np.uint8)
    path = tapi.write_binq(tmp_path / "r.binq", codes, lengths, phred)
    offs = np.r_[0, np.cumsum(lengths)]
    want = b"".join(int(n).to_bytes(4, "big")
                    + ((phred[a:b] << 2) | codes[a:b]).tobytes()
                    for n, a, b in zip(lengths, offs[:-1], offs[1:]))
    with open(path, "rb") as fh:
        assert fh.read() == want
    batches = list(tapi.read_batches(path, batch_reads=16))
    got = np.concatenate([row[:n] for b in batches
                          for row, n in zip(b.codes, b.lengths)])
    assert np.array_equal(got, codes)
    assert np.array_equal(np.concatenate([b.lengths for b in batches]),
                          lengths)
    via_reader = KmerCounter(7, "cpu")
    for b in batches:
        via_reader.add_batch(b.codes, b.lengths)
    via_packed = KmerCounter(7, "cpu")
    for packed, ls, L in tapi.packed_batches(codes, lengths, 16):
        via_packed.add_packed_batch(packed, ls, L)
    for a, b in zip(via_reader.finish(), via_packed.finish()):
        assert np.array_equal(a, b)


def test_card_spill_sizes_from_the_card(monkeypatch):
    """Off CUDA the main path never spills; on a card the threshold grows
    with its memory and stays at or above one chunk."""
    assert card_spill(torch.device("cpu")) is None

    def spill_for(gb):
        props = SimpleNamespace(total_memory=gb << 30)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device: props)
        return card_spill(torch.device("cuda"))

    chunk = 1 << 27
    h100 = spill_for(80)
    assert chunk < h100 <= 1 << 31
    assert spill_for(16) < h100 < spill_for(160)
    assert spill_for(1) == chunk


def _binq_reads(tmp_path, name="reads.binq", n_reads=300, seed=21):
    """A BINQ file of random reads: read 3 has a phred-0 base, reads 5 and
    6 are shorter than 20."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(30, 160, n_reads).astype(np.int32)
    lengths[5], lengths[6] = 12, 19
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    # repeat the first reads so counts exceed 1
    codes = np.concatenate([codes, codes[:int(lengths[:100].sum())]])
    lengths = np.concatenate([lengths, lengths[:100]])
    phred = rng.integers(1, 41, len(codes)).astype(np.uint8)
    phred[int(lengths[:3].sum()) + 7] = 0
    return tapi.write_binq(tmp_path / name, codes, lengths, phred)


@pytest.mark.parametrize("min_len", [0, 20])
def test_count_reads_files_binq_matches_jax(tmp_path, min_len):
    path = _binq_reads(tmp_path)
    fasta = tmp_path / "n_reads.fa"
    fasta.write_text(">a\nACGTACGTAGGCTAGCTAGGATCGATTGCA\n>b\nACGTTGCA\n"
                     ">c\nTTGACCGATGCATGCNNACGATGCATCGATCGAAGT\n")
    for files in ([path], [str(fasta), path]):
        want = japi.count_reads_files(files, 17, min_len=min_len,
                                      batch_reads=64)
        seen = []
        got = tapi.count_reads_files(files, 17, "cpu", min_len=min_len,
                                     batch_reads=64, progress=seen.append)
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy(), want[1])
        assert got[2] == want[2]
        assert got[1].max() > 1
        assert seen[-1]["path"] == path and len(seen) >= 6
    # quirks kept from the JAX package: the BINQ reader drops the phred-0
    # read before it counts it at all, and the reader's route does not
    # count short reads as skipped, while the native route does (the
    # FASTA's 8 bp read at min_len 20)
    assert want[2]["reads"] == 3 + 399
    assert want[2]["skipped"] == (1 if min_len == 0 else 2)


def test_matrix_pipeline_binq_sample_matches_jax(tmp_path):
    files = write_samples(tmp_path, 3, 30_000, 12_000, 12, seed=11)
    codes, lengths, _ = native_reads.parse_file(files[0])
    files[0] = tapi.write_binq(tmp_path / "sample_0.binq", codes, lengths)
    kw = dict(k=31, b=1, l=100, b1=100, b2=3000)
    want = jax_pipeline(files, **kw)
    got = matrix_pipeline(files, device="cpu", **kw)
    assert got.names == want.names == ["sample_0", "sample_1", "sample_2"]
    assert np.array_equal(got.matrix, want.matrix)
    assert np.array_equal(got.vectors, want.vectors)
    assert np.array_equal(got.breadth, want.breadth)
    assert got.contigs_per_sample == want.contigs_per_sample
    assert len(got.components) == len(want.components) >= 3
    for g, w in zip(got.components, want.components):
        assert np.array_equal(g.kmers, w.kmers)
        assert (g.weight, g.used_freq_threshold) == (
            w.weight, w.used_freq_threshold)
    for (gk, gc), (wk, wc) in zip(got.sample_tables, want.sample_tables):
        assert np.array_equal(gk, wk) and np.array_equal(gc, wc)
