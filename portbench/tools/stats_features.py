"""The stats-features tool's jobs (pipeline 5): their arguments, their
outputs read back, the plain reference's answer, and the comparison that
decides ``correct``.  The six names are those of ``matrix_builder.py``.

The configuration's ``params`` hold the tool's options (k, b, pchi2, pmw)
and ``groups``, the site whose samples are the positive group and the
site whose samples are the negative one; a read file belongs to site
``s`` when its name starts with ``s_``.

The output files read back, in the reference toolkit's formats (those of
``matrix_builder.py``):

  kmer-counter-posneg/{pos,neg}/kmers/<sample>.kmers.bin   the tables
  stats-kmers/kmers/filtered_chisquared.kmers.bin    chi2 survivors (1s)
  stats-kmers/kmers/filtered_group{A,B}.kmers.bin    {key, short mean}
  component-extractor/components.bin
  features-calculator/vectors/<positive sample>.vec / .breadth
  comp2seq/seq-builder-many/sequences/component.seq.fasta

Each compared number counts what differs, so each limit is 0 (an exact
comparison); PERF.md gives the readings they were set from.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..reference import stats_features as reference
from ..reference.stats_features import Result
from .matrix_builder import (_cells_off, _column, _components_off,
                             _contigs_off, _table_off, components_bin, fasta,
                             kmers_bin)

# name -> limit; a job is correct when every number is at most its limit
LIMITS = {
    "table_rows_off": 0,    # (key, count) records of the 8 .kmers.bin files
    "chi2_keys_off": 0,     # records of filtered_chisquared
    "selected_off": 0,      # (key, value) records of filtered_groupA and B
    "components_off": 0,    # components.bin entries, in order
    "features_off": 0,      # .vec and .breadth entries
    "sequences_off": 0,     # comp2seq's contig records
}

OPTIONS = ("k", "b", "pchi2", "pmw")


def _site_files(files: list[str], site: str) -> list[str]:
    return [f for f in files if Path(f).name.startswith(site + "_")]


def argv(config: dict, files: list[str], workdir, device: str) -> list[str]:
    """One job's launcher arguments: every option as ``-<key> <value>``,
    the files of each group after ``-pos`` and ``-neg``."""
    params = config["params"]
    args = ["-t", config["tool"]]
    for key in OPTIONS:
        args += [f"-{key}", str(params[key])]
    groups = params["groups"]
    return args + ["-pos", *_site_files(files, groups["pos"]),
                   "-neg", *_site_files(files, groups["neg"]),
                   "-w", str(workdir), "--device", device]


def expected(samples, params: dict, device, seconds: dict) -> Result:
    """The plain reference's answer for every job of the run."""
    return reference.run(samples, params, device, seconds)


def summary(want: Result) -> str:
    return (f"table_keys={sum(len(t[0]) for t in want.tables)} "
            f"chi2_keys={len(want.chi2)} group_a={len(want.group_a[0])} "
            f"group_b={len(want.group_b[0])} "
            f"components={len(want.components)} component_kmers="
            f"{sum(len(c[1]) for c in want.components)} "
            f"sequences={len(want.sequences)}")


def read_job(workdir, names: list[str]) -> Result:
    """The outputs of one job for the samples ``names``; a missing file
    raises (the job then counts as failed)."""
    wd = Path(workdir)
    posneg = wd / "kmer-counter-posneg"
    stats = wd / "stats-kmers" / "kmers"
    vecs = wd / "features-calculator" / "vectors"
    positive = sorted(p.name.removesuffix(".kmers.bin")
                      for p in (posneg / "pos" / "kmers").glob("*.kmers.bin"))
    tables = []
    for n in names:
        group = "pos" if n in positive else "neg"
        tables.append(kmers_bin(posneg / group / "kmers" / f"{n}.kmers.bin"))
    seqs = wd / "comp2seq" / "seq-builder-many" / "sequences"
    return Result(
        names=list(names), positive=positive, tables=tables,
        chi2=kmers_bin(stats / "filtered_chisquared.kmers.bin")[0],
        group_a=kmers_bin(stats / "filtered_groupA.kmers.bin"),
        group_b=kmers_bin(stats / "filtered_groupB.kmers.bin"),
        components=components_bin(wd / "component-extractor"
                                  / "components.bin"),
        vectors=np.stack([_column(vecs / f"{n}.vec", int)
                          for n in positive]),
        breadth=np.stack([_column(vecs / f"{n}.breadth", float)
                          for n in positive]),
        sequences=fasta(seqs / "component.seq.fasta"))


def _keys_off(a: np.ndarray, b: np.ndarray) -> int:
    return len(np.setxor1d(a, b))


def compare(got: Result, want: Result) -> dict[str, float]:
    """Each number of ``LIMITS`` for one job (``got`` holds the samples
    of ``want``, in its order: a missing file fails the job instead)."""
    same_groups = got.positive == want.positive
    return {
        "table_rows_off": sum(_table_off(a, b) for a, b in
                              zip(got.tables, want.tables)),
        "chi2_keys_off": _keys_off(got.chi2, want.chi2),
        "selected_off": _table_off(got.group_a, want.group_a)
        + _table_off(got.group_b, want.group_b),
        "components_off": _components_off(got.components, want.components),
        # features of other samples differ in every cell
        "features_off": (_cells_off(got.vectors, want.vectors)
                         + _cells_off(got.breadth, want.breadth)
                         if same_groups else
                         want.vectors.size + want.breadth.size + 1),
        "sequences_off": _contigs_off(got.sequences, want.sequences),
    }
