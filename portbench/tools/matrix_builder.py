"""The matrix-builder tool's jobs: their arguments, their outputs read back,
the plain reference's answer, and the comparison that decides ``correct``.

A cell's configuration names its tool; the harness (``harness/cells.py``)
imports ``portbench/tools/<tool>.py`` (``-`` written ``_``), which
provides ``argv``, ``expected``, ``read_job``, ``compare``, ``LIMITS``
and ``summary``.  Another tool is another module beside this one.

The output formats are the reference toolkit's (and so the program's),
read here with NumPy alone:

  kmer-counter-many/kmers/<sample>.kmers.bin   {>i8 key, >i2 count}
  seq-builder-many/sequences/<sample>.seq.fasta
      '><id> length=<L> av_weight=<a> min_weight=<m> max_weight=<M>'
  component-cutter/components.bin   >i4 n; per component >i4 size,
                                    >i8 weight, size x >i8 keys
  features-calculator/vectors/<sample>.vec / .breadth   one value a line
  matrices/dist_matrix_*_original_order.txt   '#\\tnames', rows
                                              'name\\tv...' (%.4f)

Each compared number counts what differs, so each limit is 0 (an exact
comparison); PERF.md gives the readings they were set from.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from ..reference import matrix as reference
from ..reference.matrix import Result

# name -> limit; a job is correct when every number is at most its limit
LIMITS = {
    "table_rows_off": 0,    # (key, count) records of the .kmers.bin files
    "contigs_off": 0,       # contig records (sequence, length, weights)
    "components_off": 0,    # components.bin entries, in order
    "features_off": 0,      # .vec and .breadth entries
    "matrix_gap": 0.0,      # largest gap of the %.4f matrix file
}


def argv(config: dict, files: list[str], workdir, device: str) -> list[str]:
    """One job's launcher arguments: every parameter as ``-<key> <value>``
    (the launcher strips the dashes of an option), every read file."""
    args = ["-t", config["tool"]]
    for key, val in config["params"].items():
        args += [f"-{key}", str(val)]
    return args + ["-i", *files, "-w", str(workdir), "--device", device,
                   "--finish", config["finish"]]


def expected(samples, params: dict, device, seconds: dict) -> Result:
    """The plain reference's answer for every job of the run."""
    return reference.run(samples, params, device, seconds)


def summary(want: Result) -> str:
    return (f"components={len(want.components)} contigs="
            f"{sum(len(c) for c in want.contigs)} table_keys="
            f"{sum(len(t[0]) for t in want.tables)}")


KMERS_BIN = np.dtype([("key", ">i8"), ("cnt", ">i2")])


def kmers_bin(path) -> tuple[np.ndarray, np.ndarray]:
    rec = np.fromfile(path, dtype=KMERS_BIN)
    return rec["key"].astype(np.int64), rec["cnt"].astype(np.int64)


def fasta(path) -> list[tuple]:
    """[(seq, length, av, min, max)] of a contig FASTA."""
    lines = Path(path).read_text().split("\n")
    out = []
    for head, seq in zip(lines[0::2], lines[1::2]):
        f = dict(kv.split("=") for kv in head.split()[1:])
        out.append((seq, int(f["length"]), int(f["av_weight"]),
                    int(f["min_weight"]), int(f["max_weight"])))
    return out


def components_bin(path) -> list[tuple[int, np.ndarray]]:
    raw = Path(path).read_bytes()
    n = int(np.frombuffer(raw, ">i4", 1, 0)[0])
    off, out = 4, []
    for _ in range(n):
        size = int(np.frombuffer(raw, ">i4", 1, off)[0])
        weight = int(np.frombuffer(raw, ">i8", 1, off + 4)[0])
        keys = np.frombuffer(raw, ">i8", size, off + 12).astype(np.int64)
        out.append((weight, keys))
        off += 12 + 8 * size
    if off != len(raw):
        raise ValueError(f"{path}: {len(raw) - off} trailing bytes")
    return out


def _column(path, dtype) -> np.ndarray:
    text = Path(path).read_text().split()
    return np.array([dtype(x) for x in text], dtype=dtype)


def matrix_file(path) -> tuple[list[str], np.ndarray]:
    lines = [ln for ln in Path(path).read_text().split("\n") if ln]
    names = lines[0].split("\t")[1:]
    rows = [ln.split("\t") for ln in lines[1:]]
    if [r[0] for r in rows] != names:
        raise ValueError(f"{path}: row names differ from the header")
    return names, np.array([[float(v) for v in r[1:]] for r in rows])


def read_job(workdir, names: list[str]) -> Result:
    """The outputs of one job for the samples ``names``; a missing file
    raises (the job then counts as failed)."""
    wd = Path(workdir)
    kmers = wd / "kmer-counter-many" / "kmers"
    seqs = wd / "seq-builder-many" / "sequences"
    vecs = wd / "features-calculator" / "vectors"
    (mat,) = sorted((wd / "matrices").glob("dist_matrix_*_original_order.txt"))
    mnames, matrix = matrix_file(mat)
    return Result(
        names=mnames,
        tables=[kmers_bin(kmers / f"{n}.kmers.bin") for n in names],
        contigs=[fasta(seqs / f"{n}.seq.fasta") for n in names],
        components=components_bin(wd / "component-cutter" / "components.bin"),
        vectors=np.stack([_column(vecs / f"{n}.vec", int) for n in names]),
        breadth=np.stack([_column(vecs / f"{n}.breadth", float)
                          for n in names]),
        matrix=matrix)


def _table_off(a, b) -> int:
    (ka, ca), (kb, cb) = a, b
    if np.array_equal(ka, kb) and np.array_equal(ca, cb):
        return 0
    common, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                    return_indices=True)
    return (len(ka) + len(kb) - 2 * len(common)
            + int((ca[ia] != cb[ib]).sum()))


def _contigs_off(a, b) -> int:
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def _components_off(a, b) -> int:
    off = abs(len(a) - len(b))
    for (wa, ka), (wb, kb) in zip(a, b):
        off += int(wa != wb or not np.array_equal(ka, kb))
    return off


def _cells_off(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a != b).sum())


def compare(got: Result, want: Result) -> dict[str, float]:
    """Each number of ``LIMITS`` for one job (``got`` holds the samples
    of ``want``, in its order: a missing file fails the job instead)."""
    same = got.names == want.names
    want4 = np.vectorize(lambda x: float("%.4f" % x))(want.matrix)
    return {
        "table_rows_off": sum(_table_off(a, b) for a, b in
                              zip(got.tables, want.tables)),
        "contigs_off": sum(_contigs_off(a, b) for a, b in
                           zip(got.contigs, want.contigs)),
        "components_off": _components_off(got.components, want.components),
        "features_off": _cells_off(got.vectors, want.vectors)
        + _cells_off(got.breadth, want.breadth),
        # distances lie in [0, 1]: a matrix of other samples gaps by 1
        "matrix_gap": (float(np.abs(got.matrix - want4).max())
                       if same and got.matrix.shape == want4.shape
                       else 1.0),
    }
