"""Read-file counting: native parse -> stream3 layout -> device counter.

Counterpart of metafast_tpu/api.py count_reads_files (:295-434).  Files
are parsed by the JAX package's jax-free native parser; the concatenated
codes are cut into slabs of at most SLAB_CODES codes, packed into the
compact 3-stream layout on the host, uploaded through pinned memory and
counted on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from metafast_tpu.io import native_reads

from .ops.count import KmerCounter
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


def parse_reads(path: str, min_len: int = 0):
    """(codes uint8, lengths int32, n_total, n_skipped) of one FASTA or
    FASTQ file (optionally .gz / .bz2), reads shorter than min_len
    skipped."""
    native_library()
    parsed = native_reads.parse_file(path)
    if parsed is None:
        raise ValueError(f"{path}: only FASTA and FASTQ input is supported")
    codes, lengths, skipped = parsed
    total = len(lengths) + skipped
    if min_len > 0 and len(lengths):
        keep = lengths >= min_len
        skipped += int((~keep).sum())
        codes, lengths = codes[np.repeat(keep, lengths)], lengths[keep]
    return codes, lengths, total, skipped


def count_reads_files(files: list[str], k: int,
                      device: str | torch.device = "cuda",
                      min_len: int = 0, progress=None):
    """Canonical k-mer counts over read files (one sample).

    Parity: IOUtils.loadReads (src/io/IOUtils.java:742-803) -- all files
    accumulate into one table; reads shorter than min_len or containing
    invalid characters are skipped; counts saturate at 32767.

    ``progress``, if given, is called per slab with one dict (keys: path,
    reads, kmers).  Returns (keys int64 ascending, counts int32) on
    ``device`` and a stats dict.
    """
    counter = KmerCounter(k, resolve_device(device))
    n_reads = n_skipped = reads_done = kmers_done = 0
    for path in files:
        codes, lengths, total, skipped = parse_reads(str(path), min_len)
        n_reads += total
        n_skipped += skipped

        def _report(ls, path=path):
            nonlocal reads_done, kmers_done
            reads_done += len(ls)
            kmers_done += int(np.maximum(ls.astype(np.int64) - (k - 1),
                                         0).sum())
            progress(dict(path=path, reads=reads_done, kmers=kmers_done))

        count_codes(counter, codes, lengths,
                    _report if progress is not None else None)
    keys, counts = counter.finish_device()
    stats = dict(reads=n_reads, skipped=n_skipped,
                 kmers_seen=counter.total_kmers_seen, unique=len(keys))
    return keys, counts, stats
