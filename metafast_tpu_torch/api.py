"""Read-file counting (parse -> extraction -> device counter), k-mer file
loading and presence lookups.

Counterpart of metafast_tpu/api.py count_reads_files (:295-434).  Two
routes, per file:

  * FASTA / FASTQ (optionally .gz / .bz2): the native parser (the port's
    copy of the JAX package's); the concatenated codes are cut into slabs of at most
    SLAB_CODES codes, packed into the compact 3-stream layout on the host,
    uploaded through pinned memory and extracted by the hand kernel.
  * anything the native parser does not take (BINQ): the Python reader's
    padded read batches (io.reads.read_batches) into
    ``KmerCounter.add_batch``.

With a default mesh of more than one rank (``set_default_mesh``, set by
the CLI's ``--shards``), ``count_reads_files`` counts over the mesh
instead (``count_reads_files_sharded``): each rank parses its share of
every file and the key space is hash-sharded across the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from .io import binfmt, native_reads
from .io import reads as readsio
from .ops.count import SATURATE, KmerCounter, card_spill, device_table
from .ops.stream_extract import build_stream3, to_device
from .utils import trace
from .utils.device import resolve_device
from .utils.native import native_library

# Default mesh for counting and the graph stages: set by the CLI's
# --shards (or by callers); routes count_reads_files, build_contigs and
# split_components through the parallel/ twins when it spans > 1 rank.
_default_mesh = None

# codes per slab: bounds the [16, C, 256] int64 key planes of one slab to
# ~0.92 GB at 150 bp reads (2^27 codes -> ~115 M keys)
SLAB_CODES = 1 << 27


def set_default_mesh(mesh) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh():
    return _default_mesh


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
        with trace.span("count.layout"):
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
    with trace.span("count.parse"):
        parsed = native_reads.parse_file(path)
        return None if parsed is None else _apply_min_len(parsed, min_len)


def _apply_min_len(parsed, min_len: int):
    """A native parse (codes, lengths, skipped) as (codes, lengths,
    n_total, n_skipped), reads shorter than min_len skipped."""
    codes, lengths, skipped = parsed
    total = len(lengths) + skipped
    if min_len > 0 and len(lengths):
        keep = lengths >= min_len
        skipped += int((~keep).sum())
        codes, lengths = codes[np.repeat(keep, lengths)], lengths[keep]
    return codes, lengths, total, skipped


def _parse_whole(path: str, min_len: int):
    """(codes, lengths, n_total, n_skipped) of a whole file: the native
    parser, or for BINQ the Python reader's batches concatenated (whose
    totals, as on count_reads_files' batch route, come from the last
    batch)."""
    parsed = parse_reads(path, min_len)
    if parsed is not None:
        return parsed
    cs, ls, last = [], [], None
    for batch in read_batches(path, min_len=min_len):
        cs += [batch.codes[i, :n] for i, n in enumerate(batch.lengths)]
        ls.append(batch.lengths)
        last = batch
    codes = np.concatenate(cs) if cs else np.zeros(0, np.uint8)
    lengths = (np.concatenate(ls).astype(np.int32) if ls
               else np.zeros(0, np.int32))
    return (codes, lengths, last.n_total if last else 0,
            last.n_skipped if last else 0)


def _parse_process_share(path: str, min_len: int, mesh):
    """This rank's share of one input file: (codes, lengths, reads,
    skipped), whose accounting fields sum to the file's totals over the
    ranks (metafast_tpu/api.py :80-150).

    Uncompressed FASTA / FASTQ: a record-aligned byte range, ~1/P of the
    bytes per rank.  Every rank snaps every boundary, and one
    all_reduce(MIN) of "all snapped" decides for all ranks together, so
    byte-range and read-slice shares never mix.  Otherwise (gz, bz2,
    BINQ, or a boundary that did not snap) every rank parses the whole
    file and takes a contiguous slice of its reads; the whole-file
    totals are counted once, on rank 0.
    """
    import os

    from .parallel import distributed as D

    p, P = mesh.rank, mesh.size
    size = os.path.getsize(path)
    try:
        ok = all(native_reads.record_boundary(path, q * size // P)
                 is not None for q in range(P + 1))
    except OSError:         # a rank that cannot read takes the vote down
        ok = False
    if D.all_reduce(mesh, int(ok), "min"):
        native_library()
        res = native_reads.parse_file_range(path, p * size // P,
                                            (p + 1) * size // P)
        if res is None:
            raise IOError(
                f"record-aligned range parse failed on {path} after all "
                "ranks agreed the file is range-splittable; failing rather "
                "than double-counting")
        return _apply_min_len(res, min_len)
    codes, lengths, total, skipped = _parse_whole(path, min_len)
    n = len(lengths)
    offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    r0, r1 = n * p // P, n * (p + 1) // P
    return (codes[offs[r0]:offs[r1]], lengths[r0:r1],
            total if p == 0 else 0, skipped if p == 0 else 0)


def count_reads_files_sharded(files: list[str], k: int, mesh,
                              min_len: int = 0, progress=None,
                              spill: int | None = None):
    """count_reads_files over the ranks of ``mesh``
    (parallel.count.ShardedKmerCounter); a collective of every rank.

    Counterpart of metafast_tpu/api.py count_reads_files_sharded
    (:153-292).  Each rank parses its share of every file
    (``_parse_process_share``), cuts it into slabs of <= SLAB_CODES codes
    and counts them with K1; one all_reduce(MAX) per file gives every
    rank the longest slab count, and shorter plans are padded with empty
    turns so the ranks stay in lockstep.  ``spill`` (default: the card's
    ``card_spill``) bounds each rank's shard table.  Returns (keys int64
    ascending, counts int32) on the mesh's device, the same full table on
    every rank, and the stats dict summed over ranks (``spills`` as in
    count_reads_files).
    """
    from .parallel import distributed as D
    from .parallel.count import ShardedKmerCounter

    native_library()
    dev = mesh.device
    counter = ShardedKmerCounter(
        k, mesh, spill=spill if spill is not None else card_spill(dev))
    n_reads = n_skipped = reads_done = kmers_done = 0
    for path in map(str, files):
        codes, lengths, total, skipped = _parse_process_share(
            path, min_len, mesh)
        n_reads += total
        n_skipped += skipped
        slabs = list(_slabs(codes, lengths))
        turns = D.all_reduce(mesh, len(slabs), "max")
        for codes_s, lengths_s in slabs:
            w0, w1, w2, vm = to_device(build_stream3(codes_s, lengths_s, k),
                                       dev)
            counter.add_stream3(w0, w1, w2, vm, lengths_s)
            if progress is not None:
                reads_done += len(lengths_s)
                kmers_done += int(np.maximum(
                    lengths_s.astype(np.int64) - (k - 1), 0).sum())
                progress(dict(path=path, reads=reads_done,
                              kmers=kmers_done))
        for _ in range(turns - len(slabs)):
            counter.add_empty()
    keys, counts = counter.finish_device()
    stats = dict(reads=D.all_reduce(mesh, n_reads),
                 skipped=D.all_reduce(mesh, n_skipped),
                 kmers_seen=counter.total_kmers_seen, unique=keys.numel())
    spills = D.all_reduce(mesh, counter.spill_events)
    if spills:
        stats["spills"] = spills
    return keys, counts, stats


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
    on the host and uploaded once, and the stats then hold ``spills``,
    the number of times it moved to host RAM.

    With a default mesh of more than one rank this is
    ``count_reads_files_sharded`` on the mesh's device.
    """
    if _default_mesh is not None and _default_mesh.size > 1:
        return count_reads_files_sharded(files, k, _default_mesh,
                                         min_len=min_len, progress=progress)
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
    if counter.spill_events:
        stats["spills"] = counter.spill_events
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
        with trace.span("read.kmers_bin"):
            k, c = binfmt.read_kmers_bin(path)
        keep = c > threshold
        keys.append(torch.from_numpy(k[keep]))
        counts.append(torch.from_numpy(c[keep]))
    keys, counts = torch.cat(keys), torch.cat(counts)
    trace.h2d(device, keys, counts)
    keys, counts = keys.to(device), counts.to(device)
    keys, order = torch.sort(keys, stable=True)
    counts = counts[order].to(torch.int64)
    if len(files) > 1:
        keys, runs = torch.unique_consecutive(keys, return_counts=True)
        seg = torch.repeat_interleave(
            torch.arange(keys.numel(), device=device), runs)
        counts = torch.zeros(keys.numel(), dtype=torch.int64,
                             device=device).index_add_(0, seg, counts)
    return keys, counts.clamp_(max=SATURATE).to(torch.int32)


def presence_counts(component_keys, sample_keys, sample_counts):
    """Per key of ``component_keys``, its count in the sample table, else
    0: int64, on the component keys' device (one binary search).

    Counterpart of metafast_tpu/api.py presence_counts (:464-476); parity:
    IOUtils.calculatePresenceForKmers (src/io/IOUtils.java:577-597).
    Keys are int64, ``sample_keys`` ascending.
    """
    comp = torch.as_tensor(component_keys)
    skeys = torch.as_tensor(sample_keys).to(comp.device)
    if skeys.numel() == 0:
        return torch.zeros(comp.numel(), dtype=torch.int64,
                           device=comp.device)
    scounts = torch.as_tensor(sample_counts).to(comp.device)
    idx = torch.searchsorted(skeys, comp).clamp_(max=skeys.numel() - 1)
    return torch.where(skeys[idx] == comp, scounts[idx].to(torch.int64), 0)
