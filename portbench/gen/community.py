"""Seeded CAMI-shaped paired-end shotgun samples, vectorised.

A traffic file (``portbench/traffic/<name>.json``) describes a community
of sites.  Every site holds a pool of species, one set of core species is
shared by every site, and a fraction of the species carry a second
strain at a fixed SNP divergence.  Each sample holds its site's pool plus
the core, at its own log-normal abundances, and is sequenced as 2 x
``read_len`` Illumina pairs with normally distributed inserts and uniform
substitution errors, written as ``<sample>_R1.fastq`` and
``<sample>_R2.fastq`` (Phred+33 qualities).

What is fixed and what the seed draws.  The community's shape (genome
lengths, which species carry strains, every sample's abundance profile
and so its number of pairs per genome) comes from the traffic file's
``profile_seed`` alone, so every run seed does the same amount of work.
The run seed draws the genome sequences, the strains' SNPs, which sample
of a site takes which abundance profile, every fragment's position,
strand and insert, and every error.

Reads are also returned as 2-bit code arrays (A=0, G=1, C=2, T=3, the
k-mer key order of the reference toolkit) for the plain reference, which
never parses the FASTQ files.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from pathlib import Path

import numpy as np

LETTERS = np.frombuffer(b"AGCT", dtype=np.uint8)   # code -> ASCII
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in (b"AT", b"TA", b"CG", b"GC"):
    _COMP[_a] = _b
_CODE = np.full(256, 255, dtype=np.uint8)
for _c, _v in zip(b"AGCT", range(4)):
    _CODE[_c] = _v

@dataclass
class Traffic:
    """The generator's parameters, as a traffic file states them."""
    n_sites: int
    species_per_site: int
    core_species: int
    samples_per_site: int
    bases_per_sample: int
    read_len: int
    insert_mean: float
    insert_sd: float
    substitution_rate: float
    abundance_mu: float
    abundance_sigma: float
    genome_len_min: int
    genome_len_max: int
    strain_fraction: float
    strain_snp_rate: float
    profile_seed: int

    @classmethod
    def load(cls, path) -> "Traffic":
        raw = json.loads(Path(path).read_text())
        keys = [f.name for f in fields(cls)]
        missing = [k for k in keys if k not in raw]
        if missing:
            raise ValueError(f"{path}: traffic file lacks {missing}")
        return cls(**{k: raw[k] for k in keys})


@dataclass
class Sample:
    name: str
    r1: np.ndarray      # [pairs, read_len] uint8 codes
    r2: np.ndarray
    files: list[str] = field(default_factory=list)

    @property
    def reads(self) -> tuple[np.ndarray, np.ndarray]:
        return self.r1, self.r2


@dataclass
class Profile:
    """The seed-independent shape of a community."""
    genome_len: np.ndarray          # [G] per genome (strains included)
    species_of: np.ndarray          # [G] species index of each genome
    strain_of: np.ndarray           # [G] -1, or the genome it derives from
    members: list[np.ndarray]       # per site: its genome indices
    pairs: list[list[np.ndarray]]   # per site, per sample: pairs per member


def profile(t: Traffic) -> Profile:
    """Genome lengths, strains and per-sample pair counts from
    ``t.profile_seed`` alone."""
    rng = np.random.default_rng([t.profile_seed, 0x5EED])
    n_species = t.n_sites * t.species_per_site + t.core_species
    # evenly spaced quantiles of U(min, max), in a profile-drawn order
    q = (np.arange(n_species) + 0.5) / n_species
    lens = t.genome_len_min + q * (t.genome_len_max - t.genome_len_min)
    lens = rng.permutation(np.round(lens).astype(np.int64))
    n_strained = int(round(t.strain_fraction * n_species))
    strained = np.sort(rng.choice(n_species, n_strained, replace=False))
    genome_len = np.concatenate([lens, lens[strained]])
    species_of = np.concatenate([np.arange(n_species), strained])
    strain_of = np.concatenate([np.full(n_species, -1), strained])
    core = np.arange(t.n_sites * t.species_per_site, n_species)
    members, pairs = [], []
    for s in range(t.n_sites):
        own = np.arange(s * t.species_per_site, (s + 1) * t.species_per_site)
        spec = np.concatenate([own, core])
        gen = np.nonzero(np.isin(species_of, spec))[0]
        members.append(gen)
        per_sample = []
        for _ in range(t.samples_per_site):
            ab = rng.lognormal(t.abundance_mu, t.abundance_sigma, len(gen))
            w = ab * genome_len[gen]
            total_pairs = t.bases_per_sample // (2 * t.read_len)
            per_sample.append(_apportion(total_pairs, w / w.sum()))
        pairs.append(per_sample)
    return Profile(genome_len, species_of, strain_of, members, pairs)


def _apportion(total: int, share: np.ndarray) -> np.ndarray:
    """Whole counts summing to ``total`` in proportion to ``share``
    (largest remainders)."""
    raw = share * total
    out = np.floor(raw).astype(np.int64)
    rest = total - int(out.sum())
    out[np.argsort(raw - out, kind="stable")[::-1][:rest]] += 1
    return out


def genomes(t: Traffic, prof: Profile, rng) -> list[np.ndarray]:
    """ASCII genomes: species drawn uniformly, strains as SNP copies."""
    out = []
    for g, n in enumerate(prof.genome_len):
        src = prof.strain_of[g]
        if src < 0:
            out.append(LETTERS[rng.integers(0, 4, int(n), dtype=np.uint8)])
            continue
        seq = out[src].copy()
        snp = np.nonzero(rng.random(len(seq)) < t.strain_snp_rate)[0]
        codes = _CODE[seq[snp]]
        seq[snp] = LETTERS[(codes + rng.integers(1, 4, len(snp),
                                                 dtype=np.uint8)) & 3]
        out.append(seq)
    return out


def _pairs(t: Traffic, genome: np.ndarray, n: int, rng):
    """``n`` read pairs of one genome: (R1, R2) ASCII [n, read_len]."""
    L = t.read_len
    ins = np.rint(rng.normal(t.insert_mean, t.insert_sd, n)).astype(np.int64)
    ins = np.clip(ins, L, len(genome))
    start = (rng.random(n) * (len(genome) - ins + 1)).astype(np.int32)
    cols = np.arange(L, dtype=np.int32)
    left = genome[start[:, None] + cols]
    right = _COMP[genome[(start + ins.astype(np.int32) - 1)[:, None] - cols]]
    flip = rng.random(n) < 0.5          # fragment from the reverse strand
    r1 = np.where(flip[:, None], right, left)
    r2 = np.where(flip[:, None], left, right)
    return r1, r2


def _substitute(reads: np.ndarray, rate: float, rng) -> None:
    """Uniform substitution errors in place: each base changes with
    probability ``rate`` to one of the other three."""
    flat = reads.reshape(-1)
    # positions drawn with replacement: at these rates a repeat (which
    # removes one error) is a ~rate/2 share of them
    at = np.unique(rng.integers(0, len(flat), rng.binomial(len(flat), rate)))
    codes = _CODE[flat[at]]
    flat[at] = LETTERS[(codes + rng.integers(1, 4, len(at),
                                             dtype=np.uint8)) & 3]


def _quality(read_len: int) -> np.ndarray:
    """One Phred+33 quality line: 37 falling to 20 along the read
    ('F' to '5'); all above Phred 0, so no read is dropped."""
    q = np.rint(np.linspace(37, 20, read_len)).astype(np.uint8)
    return q + 33


def write_fastq(path: Path, prefix: bytes, reads: np.ndarray, mate: int,
                chunk: int = 1 << 18) -> None:
    """ASCII reads [n, L] as fixed-width FASTQ records
    ``@<prefix>_<9-digit index>/<mate>``."""
    n, L = reads.shape
    head = b"@" + prefix + b"_"
    width = len(head) + 9 + 3 + L + 3 + L + 1
    qual = _quality(L)
    pow10 = 10 ** np.arange(8, -1, -1, dtype=np.int64)
    with open(path, "wb") as fh:
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            rec = np.empty((b - a, width), dtype=np.uint8)
            o = len(head)
            rec[:, :o] = np.frombuffer(head, dtype=np.uint8)
            idx = np.arange(a, b, dtype=np.int64)[:, None]
            rec[:, o:o + 9] = (idx // pow10 % 10 + 48).astype(np.uint8)
            o += 9
            rec[:, o:o + 3] = np.frombuffer(b"/%d\n" % mate, dtype=np.uint8)
            o += 3
            rec[:, o:o + L] = reads[a:b]
            o += L
            rec[:, o:o + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
            o += 3
            rec[:, o:o + L] = qual
            rec[:, -1] = 10
            rec.tofile(fh)


def generate(t: Traffic, seed: int, directory: Path | None = None
             ) -> list[Sample]:
    """Every sample of the community from ``seed``; with ``directory``,
    each also written as its R1/R2 FASTQ pair there.  Sample names are
    ``site<i>_s<j>``."""
    prof = profile(t)
    if directory is not None:
        Path(directory).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0xCA41])
    gens = genomes(t, prof, rng)
    out = []
    for s in range(t.n_sites):
        order = rng.permutation(t.samples_per_site)
        for j in range(t.samples_per_site):
            counts = prof.pairs[s][order[j]]
            parts = [_pairs(t, gens[g], int(c), rng)
                     for g, c in zip(prof.members[s], counts) if c > 0]
            r1 = np.concatenate([p[0] for p in parts])
            r2 = np.concatenate([p[1] for p in parts])
            shuffle = rng.permutation(len(r1))
            r1, r2 = r1[shuffle], r2[shuffle]
            _substitute(r1, t.substitution_rate, rng)
            _substitute(r2, t.substitution_rate, rng)
            name = f"site{s}_s{j}"
            smp = Sample(name, _CODE[r1], _CODE[r2])
            if directory is not None:
                for mate, reads in ((1, r1), (2, r2)):
                    p = Path(directory) / f"{name}_R{mate}.fastq"
                    write_fastq(p, name.encode(), reads, mate)
                    smp.files.append(str(p))
            out.append(smp)
    return out
