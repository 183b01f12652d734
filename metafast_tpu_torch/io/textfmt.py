"""Text on-disk formats matching the reference toolkit byte-for-byte.

  *.stat.txt    header '# k-mer frequency\\tnumber of such k-mers', then
                sorted 'freq\\tcount' lines, then a blank line
                (itmo QuickQuantitativeStatistics.java:57-72 — printToFile
                println's toString() which itself ends with \\n)
  distribution  lines 'i stat[i]' for i in 1..1023, zeros included
                (src/tools/SeqBuilderMain.java dumpStat, STAT_LEN=1024)
  *.vec         one integer per line (FeaturesCalculatorMain:169-230)
  *.breadth     one double per line
  dist matrix   optional '#\\tname...' header; rows 'name\\tv\\t...' with
                a configurable format, default %.4f
                (src/tools/DistanceMatrixCalculatorMain.java:91-140)
  contig FASTA  '><id> length=<L> av_weight=<w> min_weight=<m> max_weight=<M>'
                (src/structures/Sequence.java:26-37)
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace


def frequency_histogram(counts) -> tuple[list, list]:
    """(values, numbers) of a table of counts, a tensor or an array: each
    distinct value, ascending, and how many entries hold it.  The table is
    histogrammed where it lies and only the two short results are copied
    to the host."""
    values, numbers = torch.unique(torch.as_tensor(counts), sorted=True,
                                   return_counts=True)
    trace.d2h(values, numbers)
    return values.tolist(), numbers.tolist()


def write_histogram(path: str, values, numbers) -> None:
    """A ``*.stat.txt`` file from ``frequency_histogram``'s pairs."""
    with open(path, "w") as fh:
        fh.write("# k-mer frequency\tnumber of such k-mers\n")
        fh.writelines(f"{f}\t{n}\n" for f, n in zip(values, numbers))
        fh.write("\n")


def write_stat_txt(path: str, counts) -> None:
    """Frequency histogram of `counts` (a tensor or an array, all entries,
    sorted by frequency)."""
    write_histogram(path, *frequency_histogram(counts))


def write_distribution(path: str, counts: np.ndarray, stat_len: int = 1024) -> np.ndarray:
    """seq-builder 'distribution' file; returns the stat array (index=freq)."""
    stat = np.zeros(stat_len, dtype=np.int64)
    c = np.minimum(np.asarray(counts, dtype=np.int64), stat_len - 1)
    np.add.at(stat, c, 1)
    with open(path, "w") as fh:
        for i in range(1, stat_len):
            fh.write(f"{i} {stat[i]}\n")
    return stat


def _fmt_double(x: float) -> str:
    """Java Double.toString-alike for the common cases used here."""
    s = repr(float(x))
    return s


def write_vector(path: str, vec) -> None:
    with open(path, "w") as fh:
        for v in vec:
            fh.write(f"{int(v)}\n")


def write_breadth(path: str, vec) -> None:
    with open(path, "w") as fh:
        for v in vec:
            fh.write(_fmt_double(v) + "\n")


def read_vector(path: str) -> np.ndarray:
    vals = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                vals.append(float(line))
    return np.asarray(vals, dtype=np.float64)


def java_format(fmt: str, x: float) -> str:
    """Apply a Java-style format like %.4f (identical in python for floats)."""
    return fmt % x


def write_dist_matrix(path: str, matrix: np.ndarray, names: list[str] | None,
                      perm: list[int] | None = None, fmt: str = "%.4f") -> None:
    matrix = np.asarray(matrix)
    n = matrix.shape[0]
    with open(path, "w") as fh:
        if names is not None:
            fh.write("#")
            for i in range(n):
                fh.write("\t" + names[perm[i] if perm else i])
            fh.write("\n")
        for i in range(n):
            row = []
            if names is not None:
                prefix = names[perm[i] if perm else i] + "\t"
            else:
                prefix = ""
            for j in range(n):
                v = matrix[perm[i], perm[j]] if perm else matrix[i, j]
                row.append(java_format(fmt, v))
            fh.write(prefix + "\t".join(row) + "\n")


def read_dist_matrix(path: str) -> tuple[np.ndarray, list[str] | None]:
    """Parse a distance matrix file -> (matrix, names or None)."""
    names = None
    rows = []
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if lines and lines[0].startswith("#"):
        names = lines[0].split("\t")[1:]
        lines = lines[1:]
    for ln in lines:
        parts = ln.split("\t")
        if names is not None:
            parts = parts[1:]
        rows.append([float(p) for p in parts])
    return np.asarray(rows, dtype=np.float64), names


def write_contigs_fasta(path: str, contigs) -> None:
    """contigs: iterable of (seq, avg_weight, min_weight, max_weight)."""
    with open(path, "w") as fh:
        for i, (seq, avg, mn, mx) in enumerate(contigs, start=1):
            fh.write(f">{i} length={len(seq)} av_weight={avg} "
                     f"min_weight={mn} max_weight={mx}\n")
            fh.write(seq + "\n")
