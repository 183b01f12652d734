"""Shared pieces of the tests of the PyTorch port (metafast_tpu_torch)."""

import json
import re

import numpy as np
import pytest
import torch


def check_kmer_counter_copies(directory, device):
    """Run kmer-counter on ``device`` under the profiler and check its
    counters: it copies back the good keys and counts and stat.txt's
    bins, not the whole counts table."""
    from torch.profiler import ProfilerActivity, profile

    from metafast_tpu_torch import api, cli
    from metafast_tpu_torch.io import binfmt
    from metafast_tpu_torch.utils import trace

    files = write_samples(directory, 1, 20_000, 0, 10, seed=5)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(["-t", "kmer-counter", "-k", "31", "-i", *files,
                         "--device", str(device),
                         "-w", str(directory / "wd")]) == 0
    got = trace.counters()
    trace.reset()
    _, counts, _ = api.count_reads_files(files, 31, device)
    (kmers,) = (directory / "wd").rglob("*.kmers.bin")
    (stat,) = (directory / "wd").rglob("*.stat.txt")
    good_keys, _ = binfmt.read_kmers_bin(str(kmers))
    n_bins = len(stat.read_text().splitlines()) - 2
    assert 0 < len(good_keys) < counts.numel() and n_bins > 1
    assert got["d2h_bytes"] == (
        len(good_keys) * (8 + counts.element_size())
        + n_bins * (counts.element_size() + 8))


def jax_neighbor_index(keys, k):
    """(left, right) [N, 4] int32 neighbour indices of a sorted key table
    (-1 = absent) from the JAX package's native hash
    (``build_neighbor_index``): a repeated key maps to the last index of
    its run.  The oracle of the port's ``pivot.depth1_index``."""
    import ctypes

    from metafast_tpu.native import load_library

    n = len(keys)
    log2 = max(10, int(np.ceil(np.log2(max(n, 2)))) + 1)
    left = np.empty((n, 4), dtype=np.int32)
    right = np.empty((n, 4), dtype=np.int32)
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    assert load_library().build_neighbor_index(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, k, log2,
        left.ctypes.data_as(p32), right.ctypes.data_as(p32)) == 0
    return left, right


@pytest.fixture
def cuda_device():
    """The GPU, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def write_samples(directory, n_samples, genome_len, shared_len, coverage,
                  read_len=150, seed=0):
    """FASTA read sets of genomes that share a backbone (the generator of
    bench.py stress()); returns the file paths."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = bases[rng.integers(0, 4, shared_len)]
    files = []
    for s in range(n_samples):
        genome = np.concatenate(
            [backbone, bases[rng.integers(0, 4, genome_len - shared_len)]])
        n_reads = genome_len * coverage // read_len
        starts = rng.integers(0, genome_len - read_len, n_reads)
        reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
        path = directory / f"sample_{s}.fa"
        with open(path, "wb") as fh:
            for i in range(n_reads):
                fh.write(b">r%d\n%s\n" % (i, reads[i].tobytes()))
        files.append(str(path))
    return files


def write_group_samples(directory, groups, genome_len, shared_len,
                        marker_len, coverage, read_len=150, seed=0):
    """FASTA read sets of genomes that share a backbone, with a marker
    region shared by the samples of each group: sample s, of group
    ``groups[s]``, reads backbone + its group's marker + a private rest.
    Returns (file paths, genomes as bytes)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = bases[rng.integers(0, 4, shared_len)]
    markers = {g: bases[rng.integers(0, 4, marker_len)]
               for g in sorted(set(groups))}
    files, genomes = [], []
    for s, g in enumerate(groups):
        private = genome_len - shared_len - marker_len
        genome = np.concatenate([backbone, markers[g],
                                 bases[rng.integers(0, 4, private)]])
        n_reads = genome_len * coverage // read_len
        starts = rng.integers(0, genome_len - read_len, n_reads)
        reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
        path = directory / f"{g}_{s}.fa"
        with open(path, "wb") as fh:
            for i in range(n_reads):
                fh.write(b">r%d\n%s\n" % (i, reads[i].tobytes()))
        files.append(str(path))
        genomes.append(genome.tobytes())
    return files, genomes


def counted_table(k, seed, genome_len=6000, cov=10, read_len=90,
                  palindromes=0, b=1):
    """(keys, counts) at count > b of reads drawn from a random genome,
    counted by the JAX package's counter, with read coverage varying
    along the genome so thresholds split it, a repeat longer than k
    (forks at both of its ends) and, for even k, ``palindromes``
    reverse-complement palindromes (a palindromic k-mer at each centre)."""
    from metafast_tpu.ops.count import KmerCounter

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    genome[genome_len // 2:genome_len // 2 + 2 * k] = genome[50:50 + 2 * k]
    half = k // 2
    for p in range(palindromes):
        left = rng.integers(0, 4, half + 3).astype(np.uint8)
        pal = np.concatenate([left, (3 - left)[::-1]])
        pos = 200 + p * (genome_len - 400) // max(palindromes, 1)
        genome[pos:pos + len(pal)] = pal
    weights = 1.0 + 3.0 * (np.sin(np.arange(genome_len - read_len) / 400) > 0)
    n_reads = genome_len * cov // read_len
    starts = rng.choice(genome_len - read_len, n_reads,
                        p=weights / weights.sum())
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    lengths = np.full(n_reads, read_len, np.int32)
    c = KmerCounter(k)
    c.add_stream3(reads.ravel(), lengths)
    keys, counts = c.finish()
    keep = counts > b
    return keys[keep], counts[keep]


def _path(n, count, **dips):
    """Counts along a path of n k-mers: ``count``, and at each position
    ``p<i>=c`` the count c."""
    out = np.full(n, count, np.int32)
    for pos, c in dips.items():
        out[int(pos[1:])] = c
    return out


# Tables of disjoint linear paths, each one component at threshold 1,
# for split_components: (b1, b2, the paths' counts).  A path's k-mers
# below a threshold cut it into pieces at the next level.
_CLIMB = [
    # 120 k-mers: 120 at thr 1 and 2, pieces 40 / 39 / 39 at thr 3,
    # 20 / 19 x 5 within [10, 30] at thr 4
    _path(120, 4, p40=2, p80=2, p20=3, p60=3, p100=3),
    # oversized at thr 1-3, then no k-mer of count 4: it empties
    _path(100, 3),
]
PATH_CASES = {
    # groups of exactly b1 and b2 keys, at thr 1 and (the pieces of
    # two paths of 51) at thr 2; sizes b1 - 1 and b2 + 1 next to them
    "window_edges": (20, 50, [_path(19, 1), _path(20, 1), _path(35, 2),
                              _path(50, 3), _path(51, 1),
                              _path(51, 2, p0=1), _path(51, 2, p20=1)]),
    # the climb beside 40 paths within the window: level 2 holds 220 of
    # 1220 rows and compacts
    "climb_compacts": (10, 30, _CLIMB + [_path(25, 1 + i % 3)
                                         for i in range(40)]),
    # the same climb beside 2 paths: no level compacts
    "climb_in_place": (10, 30, _CLIMB + [_path(25, 1), _path(15, 2)]),
    # equal thresholds, weights and sizes, ordered by the smallest key
    # alone (four paths of 25 x 2, two pieces of 35 x 2 at thr 2); equal
    # weights ordered by size (50 x 1, 10 x 5)
    "ties": (10, 60, [_path(25, 2) for _ in range(4)]
             + [_path(50, 1), _path(10, 5), _path(71, 2, p35=1)]),
}


def path_table(paths, k=31, seed=0):
    """(keys ascending, counts int32) of disjoint random paths with the
    given counts along each (a random sequence of len(c) + k - 1 bases a
    path: its k-mers are distinct and join no other path's)."""
    from metafast_tpu_torch.utils.kmers import sequence_kmers

    rng = np.random.default_rng(seed)
    keys = np.concatenate([sequence_kmers(
        "".join("ACGT"[b] for b in rng.integers(0, 4, len(c) + k - 1)), k)
        for c in paths])
    counts = np.concatenate(paths)
    order = np.argsort(keys)
    keys, counts = keys[order], counts[order]
    assert (np.diff(keys) > 0).all()
    return keys, counts


_TS = re.compile(rb"\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}")


def workdir_tree(wd):
    """A CLI working directory as {relative path: bytes}, without the
    logs, with run timestamps (in paths and contents) and the workdir's
    own path (in contents) masked."""
    out = {}
    for p in sorted(wd.rglob("*")):
        rel = p.relative_to(wd)
        if p.is_dir() or rel.parts[0] in ("log", "logs"):
            continue
        key = _TS.sub(b"<ts>", str(rel).encode()).decode()
        out[key] = _TS.sub(b"<ts>", p.read_bytes().replace(
            str(wd).encode(), b"<wd>"))
    return out


def assert_same_tree(jwd, pwd) -> dict:
    """Two CLI working directories hold the same files, byte for byte,
    apart from the heatmap images (only their names) and the manifests'
    outputs (only their names); returns the first as a tree."""
    want, got = workdir_tree(jwd), workdir_tree(pwd)
    assert sorted(got) == sorted(want)
    for rel, data in want.items():
        if rel.endswith((".png", ".svg")):
            continue
        if rel.endswith("manifest.json"):
            w, g = json.loads(data), json.loads(got[rel])
            assert (g["tool"], g["inputs"]) == (w["tool"], w["inputs"]), rel
            assert sorted(g["outputs"]) == sorted(w["outputs"]), rel
            continue
        assert got[rel] == data, rel
    return want
