"""Host-side read ingestion: FASTA/FASTQ(.gz/.bz2) -> packed device batches.

Produces fixed-shape batches of 2-bit codes + lengths that feed the device
k-mer kernels.  Parsing semantics mirror the reference toolkit:

  - format by extension: fasta/fa/fn/fna, fastq/fq (+.gz/.bz2)
                                    (itmo ReadersUtils.java:27-55)
  - FASTA: lines between '>'/' ;' headers are concatenated into one read;
    reads containing N/n are skipped whole (itmo FastaReader.java:55-66)
  - FASTQ: 'N'/'n'/'.' become phred-0 positions; any phred-0 position
    drops the read (itmo FastqReader.java:74-85,
    FastaReaderFromXQSource.java:63-77); quality format auto-detected on
    the first 1000 reads, Illumina (+64) unless an out-of-range char
    forces Sanger (+33) (itmo ReadersUtils.java:58-78)
  - library name = file name minus format extension

Spec deviation (conscious): IUPAC ambiguity codes other than N are
*randomized* by the reference (itmo DnaTools.java:66-117); we drop such
reads like N-reads instead — determinism over bug-parity.
"""

from __future__ import annotations

import bz2
import gzip
import io as _io
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

FASTA_EXTS = (".fasta", ".fa", ".fn", ".fna")
FASTQ_EXTS = (".fastq", ".fq")

# ASCII -> 2-bit code LUT; 255 = invalid (N / IUPAC / garbage)
_LUT = np.full(256, 255, dtype=np.uint8)
for ch, code in (("A", 0), ("G", 1), ("C", 2), ("T", 3)):
    _LUT[ord(ch)] = code
    _LUT[ord(ch.lower())] = code


def detect_format(path: str) -> tuple[str, str]:
    """Return (format, compression): format in {fasta, fastq}, compression in {'', gz, bz2}."""
    name = os.path.basename(path).lower()
    comp = ""
    if name.endswith(".gz"):
        comp, name = "gz", name[:-3]
    elif name.endswith(".bz2"):
        comp, name = "bz2", name[:-4]
    if name.endswith(FASTQ_EXTS):
        return "fastq", comp
    if name.endswith(FASTA_EXTS):
        return "fasta", comp
    if name.endswith(".binq"):
        return "binq", comp
    raise ValueError(f"Can't detect file format for file '{os.path.basename(path)}'")


def library_name(path: str) -> str:
    """File name minus compression and format extensions (reader .name())."""
    name = os.path.basename(path)
    low = name.lower()
    if low.endswith(".gz"):
        name, low = name[:-3], low[:-3]
    elif low.endswith(".bz2"):
        name, low = name[:-4], low[:-4]
    for ext in FASTQ_EXTS + FASTA_EXTS + (".binq",):
        if low.endswith(ext):
            return name[: -len(ext)]
    return name


def _open_text(path: str):
    fmt, comp = detect_format(path)
    if comp == "gz":
        return fmt, _io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii", errors="replace")
    if comp == "bz2":
        return fmt, _io.TextIOWrapper(bz2.open(path, "rb"), encoding="ascii", errors="replace")
    return fmt, open(path, "rt", encoding="ascii", errors="replace", buffering=1 << 20)


def _iter_fasta(fh) -> Iterator[str]:
    parts: list[str] = []
    for line in fh:
        line = line.rstrip("\n").rstrip("\r")
        if line.startswith(">") or line.startswith(";"):
            if parts:
                yield "".join(parts)
                parts = []
        elif line:
            parts.append(line)
    if parts:
        yield "".join(parts)


def _iter_fastq(fh) -> Iterator[tuple[str, str]]:
    """Yield (seq, qual) records, skipping empty lines like the reference."""
    def next_data():
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if line:
                yield line

    lines = next_data()
    while True:
        try:
            header = next(lines)
        except StopIteration:
            return
        if not (header.startswith("@") or header.startswith("+")):
            raise ValueError(f"Unknown structure of fastq file! Found \"{header[:20]}\"")
        try:
            seq = next(lines)
            plus = next(lines)
            qual = next(lines)
        except StopIteration:
            raise ValueError("Unexpected end of file. File is corrupted/Format mismatch.")
        del plus
        if len(seq) != len(qual):
            raise ValueError("Bad DnaQ record: length of chars and quality is not the same.")
        yield seq, qual


def _detect_quality_format(path: str, head: int = 1000) -> int:
    """Return phred offset: 64 (Illumina) unless an illegal char forces 33 (Sanger)."""
    fmt, fh = _open_text(path)
    assert fmt == "fastq"
    try:
        for i, (_seq, qual) in enumerate(_iter_fastq(fh)):
            if i >= head:
                break
            for c in qual:
                o = ord(c)
                if o < 64 or o > 126:
                    return 33
    finally:
        fh.close()
    return 64


def _iter_binq(path: str) -> Iterator[str]:
    """BINQ: {int32 big-endian len, len x packed bytes (phred<<2 | nuc)};
    0xFF padding bytes between records are skipped; reads with any phred-0
    base are dropped (itmo io/readers/BinqReader.java:55-88,
    dna/DnaQ.java:124-133, FastaReaderFromXQSource.java:63-77)."""
    chars = "AGCT"
    with open(path, "rb") as fh:
        data = fh.read()
    i = 0
    n = len(data)
    while i < n:
        while i < n and data[i] == 255:
            i += 1
        if i + 4 > n:
            break
        ln = int.from_bytes(data[i:i + 4], "big")
        i += 4
        if i + ln > n:
            break
        rec = np.frombuffer(data, dtype=np.uint8, count=ln, offset=i)
        i += ln
        if (rec >> 2 == 0).any():
            continue
        yield "".join(chars[c] for c in (rec & 3))


def iter_reads(path: str) -> Iterator[str]:
    """Yield read sequences (strings) with reference skip semantics applied.

    FASTA: skip reads containing N/n (other invalid chars skipped too — see
    module docstring).  FASTQ: skip reads with any phred-0 position
    (N/n/. or minimum-quality char under the detected format).
    """
    fmt, fh = _open_text(path)
    if fmt == "binq":
        fh.close()
        yield from _iter_binq(path)
        return
    try:
        if fmt == "fasta":
            for seq in _iter_fasta(fh):
                yield seq
        else:
            offset = _detect_quality_format(path)
            zero_q = chr(offset)
            for seq, qual in _iter_fastq(fh):
                if zero_q in qual:
                    continue
                yield seq
    finally:
        fh.close()


@dataclass
class ReadBatch:
    codes: np.ndarray    # [B, L] uint8, 0..3, zero-padded
    lengths: np.ndarray  # [B] int32
    n_total: int         # reads scanned so far incl. skipped (for logging)
    n_skipped: int       # reads dropped because of N / phred-0


def encode_read(seq: str) -> np.ndarray | None:
    """2-bit codes, or None if the read contains an invalid character."""
    raw = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    codes = _LUT[raw]
    if (codes == 255).any():
        return None
    return codes


def read_batches(path: str, batch_reads: int = 8192, pad_to: int = 128,
                 min_len: int = 0) -> Iterator[ReadBatch]:
    """Stream reads of one file as fixed-ish-shape padded batches.

    Pad length is the max read length in the batch rounded up to a multiple
    of `pad_to` (buckets limit jit recompiles).  Reads shorter than
    `min_len` are dropped (IOUtils.loadReads minSeqLen), as are reads with
    invalid characters.
    """
    buf: list[np.ndarray] = []
    n_total = 0
    n_skipped = 0

    def flush():
        nonlocal buf
        B = len(buf)
        L = max(len(c) for c in buf)
        L = ((L + pad_to - 1) // pad_to) * pad_to
        codes = np.zeros((B, L), dtype=np.uint8)
        lengths = np.zeros((B,), dtype=np.int32)
        for i, c in enumerate(buf):
            codes[i, : len(c)] = c
            lengths[i] = len(c)
        buf = []
        return ReadBatch(codes, lengths, n_total, n_skipped)

    for seq in iter_reads(path):
        n_total += 1
        codes = encode_read(seq)
        if codes is None:
            n_skipped += 1
            continue
        if len(codes) < min_len:
            continue
        buf.append(codes)
        if len(buf) >= batch_reads:
            yield flush()
    if buf:
        yield flush()


def sort_and_pair(paths: list[str]) -> list[list[str]]:
    """Group input files into samples, pairing adjacent ``_R1``/``_R2`` libraries.

    Parity: files sorted, then adjacent libraries whose names end with
    _r1/_r2 or _R1/_R2 form one sample
    (src/tools/KmersCounterForManyFilesMain.java:80-108).
    """
    files = sorted(paths)
    names = [library_name(f) for f in files]
    groups: list[list[str]] = []
    i = 0
    while i < len(files):
        if i + 1 < len(files) and (
            (names[i].endswith("_r1") and names[i + 1].endswith("_r2"))
            or (names[i].endswith("_R1") and names[i + 1].endswith("_R2"))
        ):
            groups.append([files[i], files[i + 1]])
            i += 2
        else:
            groups.append([files[i]])
            i += 1
    return groups


def sample_name(paths: list[str]) -> str:
    """Output library name for a 1- or 2-file sample (KmersCounterMain.getName)."""
    names = [library_name(p) for p in paths]
    if len(paths) == 2:
        if (names[0].endswith("_r1") and names[1].endswith("_r2")) or (
            names[0].endswith("_R1") and names[1].endswith("_R2")
        ):
            return names[0][:-3]
        return names[0] + "+"
    return names[0] + ("+" if len(paths) > 1 else "")
