"""The traffic generator: seeded, CAMI-shaped paired reads."""

import numpy as np

from portbench.gen import community as C

from .conftest import TINY


def _parse_fastq(path):
    lines = open(path, "rb").read().split(b"\n")
    return lines[0::4][:-1], lines[1::4], lines[3::4]


def test_same_seed_same_files(tmp_path):
    t = C.Traffic.load(TINY)
    a = C.generate(t, 2**31 + 7, tmp_path / "a")
    b = C.generate(t, 2**31 + 7, tmp_path / "b")
    c = C.generate(t, 2**31 + 8, tmp_path / "c")
    for sa, sb, sc in zip(a, b, c):
        for fa, fb, fc in zip(sa.files, sb.files, sc.files):
            ra, rb, rc = (open(f, "rb").read() for f in (fa, fb, fc))
            assert ra == rb
            assert ra != rc
            assert len(ra) == len(rc)       # the same sizes from any seed


def test_files_hold_the_returned_reads(tmp_path):
    t = C.Traffic.load(TINY)
    for smp in C.generate(t, 11, tmp_path):
        assert [f.rsplit("/", 1)[1] for f in smp.files] == [
            f"{smp.name}_R1.fastq", f"{smp.name}_R2.fastq"]
        for mate, (path, codes) in enumerate(zip(smp.files, smp.reads), 1):
            heads, seqs, quals = _parse_fastq(path)
            assert len(seqs) == len(codes) == t.bases_per_sample // (
                2 * t.read_len)
            assert all(len(s) == t.read_len for s in seqs)
            assert all(q == quals[0] and min(q) > 33 + 0 for q in quals)
            assert heads[0] == b"@%s_000000000/%d" % (smp.name.encode(), mate)
            got = C.LETTERS[codes].tobytes()
            assert got == b"".join(seqs)


def _rc(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def test_pairs_come_from_one_insert():
    t = C.Traffic.load(TINY)
    rng = np.random.default_rng(3)
    genome = C.LETTERS[rng.integers(0, 4, 20000, dtype=np.uint8)]
    g = genome.tobytes()
    r1, r2 = C._pairs(t, genome, 300, rng)
    L = t.read_len
    flips = 0
    for a, b in zip(r1, r2):
        a, b = a.tobytes(), b.tobytes()
        fw = g.find(a)
        if fw < 0:                      # fragment from the reverse strand
            flips += 1
            a, b = b, a
            fw = g.find(a)
        end = g.find(_rc(b)) + L
        assert fw >= 0 and end >= L
        assert L <= end - fw <= t.insert_mean + 6 * t.insert_sd
    assert 100 < flips < 200


def test_error_rate_within_binomial_range():
    rng = np.random.default_rng(5)
    n, rate = 2_000_000, 0.003
    reads = np.full((n // 100, 100), ord("A"), dtype=np.uint8)
    C._substitute(reads, rate, rng)
    changed = int((reads != ord("A")).sum())
    sd = (n * rate * (1 - rate)) ** 0.5
    assert abs(changed - n * rate) < 5 * sd
    assert set(np.unique(reads).tolist()) == {ord(c) for c in "ACGT"}


def test_profile_fixed_by_the_traffic_file():
    t = C.Traffic.load(TINY)
    p = C.profile(t)
    assert len(p.genome_len) == 3 + round(t.strain_fraction * 3)
    assert all(t.genome_len_min <= n <= t.genome_len_max
               for n in p.genome_len)
    for site in p.pairs:
        for pairs in site:
            assert pairs.sum() == t.bases_per_sample // (2 * t.read_len)
    assert [x.tolist() for s in C.profile(t).pairs for x in s] == [
        x.tolist() for s in p.pairs for x in s]
