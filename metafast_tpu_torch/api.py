"""Read-file counting (parse -> extraction -> device counter) and k-mer
file loading.

Counterpart of metafast_tpu/api.py count_reads_files (:295-434).  Two
routes, per file:

  * FASTA / FASTQ (optionally .gz / .bz2): the JAX package's jax-free
    native parser; the concatenated codes are cut into slabs of at most
    SLAB_CODES codes, packed into the compact 3-stream layout on the host,
    uploaded through pinned memory and extracted by the hand kernel.
  * anything the native parser does not take (BINQ): the Python reader's
    padded read batches (metafast_tpu.io.reads.read_batches) into
    ``KmerCounter.add_batch``.
"""

from __future__ import annotations

import numpy as np
import torch

from metafast_tpu.io import binfmt, native_reads
from metafast_tpu.io import reads as readsio

from .ops.count import SATURATE, KmerCounter, card_spill, device_table
from .ops.stream_extract import build_stream3, to_device
from .utils.device import resolve_device
from .utils.native import native_library

# codes per slab: bounds the [16, C, 256] int64 key planes of one slab to
# ~0.92 GB at 150 bp reads (2^27 codes -> ~115 M keys)
SLAB_CODES = 1 << 27


def _slabs(codes: np.ndarray, lengths: np.ndarray):
    """(codes, lengths) of consecutive read ranges, <= SLAB_CODES codes
    each (a longer single read forms its own slab)."""
    offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    r0 = 0
    while r0 < len(lengths):
        r1 = int(np.searchsorted(offs, offs[r0] + SLAB_CODES,
                                 side="right")) - 1
        r1 = min(max(r1, r0 + 1), len(lengths))
        yield codes[offs[r0]:offs[r1]], lengths[r0:r1]
        r0 = r1


def count_codes(counter: KmerCounter, codes: np.ndarray,
                lengths: np.ndarray, progress=None) -> None:
    """Feed concatenated read codes into ``counter``, slab by slab."""
    for codes_s, lengths_s in _slabs(codes, lengths):
        w0, w1, w2, vm = to_device(build_stream3(codes_s, lengths_s,
                                                 counter.k),
                                   counter.device)
        counter.add_stream3_device(w0, w1, w2, vm, lengths_s)
        if progress is not None:
            progress(lengths_s)


def read_batches(path: str, batch_reads: int = 1 << 19, min_len: int = 0):
    """Padded read batches of one file by the Python reader, which takes
    every input format (BINQ included): objects with codes [B, L] uint8,
    lengths [B] int32 and the running n_total / n_skipped, for
    ``KmerCounter.add_batch``."""
    return readsio.read_batches(path, batch_reads=batch_reads,
                                min_len=min_len)


def packed_batches(codes: np.ndarray, lengths: np.ndarray,
                   batch_reads: int = 1 << 19):
    """Concatenated read codes as 2-bit packed batches: (packed [B, L//4]
    uint8, lengths [B] int32, L), for ``KmerCounter.add_packed_batch``."""
    return native_reads.to_packed_batches(codes, lengths, batch_reads)


def write_binq(path, codes: np.ndarray, lengths: np.ndarray,
               phred: np.ndarray | None = None) -> str:
    """Reads as a BINQ file: per read a big-endian int32 length, then one
    byte per base, phred << 2 | code (A=0, G=1, C=2, T=3).  ``phred`` is
    per base, 30 where not given; the reader drops a read that holds a
    phred-0 base."""
    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    if phred is None:
        phred = np.full(len(codes), 30, dtype=np.uint8)
    rec = lengths + 4
    starts = np.cumsum(rec) - rec
    buf = np.empty(int(rec.sum()), dtype=np.uint8)
    body = np.ones(len(buf), dtype=bool)
    hdr = lengths.astype(">i4").view(np.uint8).reshape(len(lengths), 4)
    for j in range(4):
        buf[starts + j] = hdr[:, j]
        body[starts + j] = False
    buf[body] = (np.asarray(phred, dtype=np.uint8) << 2) | codes
    buf.tofile(str(path))
    return str(path)


def parse_reads(path: str, min_len: int = 0):
    """(codes uint8, lengths int32, n_total, n_skipped) of one FASTA or
    FASTQ file (optionally .gz / .bz2) by the native parser, reads shorter
    than min_len skipped; None for a format it does not take (BINQ)."""
    native_library()
    parsed = native_reads.parse_file(path)
    if parsed is None:
        return None
    codes, lengths, skipped = parsed
    total = len(lengths) + skipped
    if min_len > 0 and len(lengths):
        keep = lengths >= min_len
        skipped += int((~keep).sum())
        codes, lengths = codes[np.repeat(keep, lengths)], lengths[keep]
    return codes, lengths, total, skipped


def count_reads_files(files: list[str], k: int,
                      device: str | torch.device = "cuda",
                      min_len: int = 0, batch_reads: int = 1 << 19,
                      progress=None):
    """Canonical k-mer counts over read files (one sample).

    Parity: IOUtils.loadReads (src/io/IOUtils.java:742-803) -- all files
    accumulate into one table; reads shorter than min_len or containing
    invalid characters are skipped; counts saturate at 32767.  Files of the
    Python reader's route go in batches of ``batch_reads`` reads; as in the
    JAX package, their stats come from the reader's last batch, which does
    not count reads shorter than min_len as skipped.

    ``progress``, if given, is called per slab or batch with one dict
    (keys: path, reads, kmers).  Returns (keys int64 ascending, counts
    int32) on ``device`` and a stats dict.  The counter spills at the
    card's own threshold (``card_spill``); a table that spilled is merged
    on the host and uploaded once.
    """
    native_library()
    device = resolve_device(device)
    counter = KmerCounter(k, device, spill=card_spill(device))
    n_reads = n_skipped = reads_done = kmers_done = 0

    def report(path, ls):
        nonlocal reads_done, kmers_done
        if progress is None:
            return
        reads_done += len(ls)
        kmers_done += int(np.maximum(ls.astype(np.int64) - (k - 1),
                                     0).sum())
        progress(dict(path=path, reads=reads_done, kmers=kmers_done))

    for path in map(str, files):
        parsed = parse_reads(path, min_len)
        if parsed is not None:
            codes, lengths, total, skipped = parsed
            n_reads += total
            n_skipped += skipped
            count_codes(counter, codes, lengths,
                        lambda ls, path=path: report(path, ls))
            continue
        last = None
        for batch in read_batches(path, batch_reads, min_len):
            counter.add_batch(batch.codes, batch.lengths)
            report(path, batch.lengths)
            last = batch
        if last is not None:
            n_reads += last.n_total
            n_skipped += last.n_skipped
    keys, counts = device_table(counter)
    stats = dict(reads=n_reads, skipped=n_skipped,
                 kmers_seen=counter.total_kmers_seen, unique=len(keys))
    return keys, counts, stats


def load_kmers_bin(files: list[str], threshold: int,
                   device: str | torch.device = "cuda"):
    """Load and merge k-mer binary files, keeping records with count >
    threshold: (int64 keys ascending, int32 counts) on ``device``.

    Counterpart of metafast_tpu/api.py load_kmers_bin (:437-461); parity:
    IOUtils.loadKmers (src/io/IOUtils.java:369-401): the per-record filter
    applies before the merge, and merged counts saturate at 32767.  As in
    the JAX package, one file is only sorted (stably), not deduplicated,
    and a merged key keeps its sum whatever its sign.
    """
    device = resolve_device(device)
    keys, counts = [], []
    for path in map(str, files):
        k, c = binfmt.read_kmers_bin(path)
        keep = c > threshold
        keys.append(torch.from_numpy(k[keep]))
        counts.append(torch.from_numpy(c[keep]))
    keys = torch.cat(keys).to(device)
    counts = torch.cat(counts).to(device)
    keys, order = torch.sort(keys, stable=True)
    counts = counts[order].to(torch.int64)
    if len(files) > 1:
        keys, runs = torch.unique_consecutive(keys, return_counts=True)
        seg = torch.repeat_interleave(
            torch.arange(keys.numel(), device=device), runs)
        counts = torch.zeros(keys.numel(), dtype=torch.int64,
                             device=device).index_add_(0, seg, counts)
    return keys, counts.clamp_(max=SATURATE).to(torch.int32)
