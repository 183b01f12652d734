"""The default distance-matrix pipeline, end to end.

Counterpart of metafast_tpu/pipeline/matrix.py (:48-269), the library
form of DistanceMatrixBuilderMain
(src/tools/DistanceMatrixBuilderMain.java:152-176):

  1. per sample: count canonical k-mers of all its read files
  2. keep only k-mers with count > b
  3. per sample: contigs = simple paths over the filtered table, >= l
  4. all samples' contigs >= l are recounted into ONE graph
  5. split into components with size window [b1, b2]
  6. per sample: vector[i] = sum of the sample's filtered counts over
     component i's k-mers where count > threshold (= 0)
  7. Bray-Curtis on the raw vectors
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import api
from ..graph import components as comp_mod
from ..graph import contigs as contigs_mod
from ..io.reads import sample_name
from ..ops.count import KmerCounter, card_spill, device_table
from ..state import HostComponent, components_to_numpy
from ..utils.device import resolve_device

_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in (("A", 0), ("G", 1), ("C", 2), ("T", 3)):
    _LUT[ord(_ch)] = _code
    _LUT[ord(_ch.lower())] = _code


@dataclass
class MatrixResult:
    """The pipeline's result on the host, field for field as the JAX
    package's MatrixResult."""
    names: list[str]
    matrix: np.ndarray                      # [S, S] float64 Bray-Curtis
    vectors: np.ndarray                     # [S, C] int64 feature vectors
    breadth: np.ndarray                     # [S, C] float64 fraction present
    components: list[HostComponent]
    contigs_per_sample: list[list[tuple]]   # (seq, av_w, min_w, max_w)
    sample_tables: list[tuple[np.ndarray, np.ndarray]]  # filtered (keys, counts)


def count_contig_kmers(contig_seqs: list[str], k: int,
                       device: str | torch.device = "cuda",
                       min_len: int = 0):
    """Canonical k-mer counts of sequence strings >= min_len (one graph):
    (int64 keys ascending, int32 counts) on ``device``.

    Parity: IOUtils.loadReads over contig FASTA with a minLen filter
    (src/tools/ComponentCutterMain.java:84).  The contigs go through the
    same 3-stream layout and kernel as reads.
    """
    device = resolve_device(device)
    counter = KmerCounter(k, device, spill=card_spill(device))
    kept = [s for s in contig_seqs if len(s) >= min_len]
    if kept:
        lengths = np.array([len(s) for s in kept], dtype=np.int32)
        codes = _LUT[np.frombuffer("".join(kept).encode(), dtype=np.uint8)]
        api.count_codes(counter, _as_packed(codes, lengths), lengths)
    return device_table(counter)


def _as_packed(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``codes`` as the JAX package's 2-bit packer leaves them.

    A sequence read back from a FASTA may hold a character outside ACGT
    (code 255, e.g. N).  The JAX package counts such sequences through its
    packed batches (native pack_batch, fastparse.cpp:284-307), whose
    unmasked OR of the code makes that base and the rest of its aligned
    group of 4 read as T.  The stream builder masks each code to 2 bits,
    so the codes are brought to the packer's reading first.
    """
    bad = codes > 3
    if not bad.any():
        return codes
    n = len(codes)
    read_start = np.repeat(np.cumsum(lengths, dtype=np.int64) - lengths,
                           lengths)
    at = np.arange(n, dtype=np.int64)
    group_start = at - (at - read_start) % 4
    n_bad = np.concatenate([[0], np.cumsum(bad)])
    hit = n_bad[at + 1] > n_bad[group_start]
    return np.where(hit, np.uint8(3), codes)


def feature_vectors(components: list[comp_mod.Component],
                    keys: torch.Tensor, counts: torch.Tensor,
                    threshold: int = 0):
    """(vector int64 [C], breadth float64 [C]) of one sample's table.

    Parity: FeaturesCalculatorMain.buildAndPrintVector
    (src/tools/FeaturesCalculatorMain.java:169-230): value > threshold.
    One binary search of all component keys in the sample table, then a
    segment sum over the component boundaries, on the table's device.
    """
    dev = keys.device
    C = len(components)
    vec = torch.zeros(C, dtype=torch.int64, device=dev)
    brd = torch.zeros(C, dtype=torch.float64, device=dev)
    if C == 0 or keys.numel() == 0:
        return vec, brd
    sizes = torch.tensor([c.size for c in components], dtype=torch.int64,
                         device=dev)
    allk = torch.cat([c.kmers for c in components])
    idx = torch.searchsorted(keys, allk).clamp_(max=keys.numel() - 1)
    pres = torch.where(keys[idx] == allk, counts[idx].to(torch.int64), 0)
    hit = pres > threshold
    seg = torch.repeat_interleave(torch.arange(C, device=dev), sizes)
    vec.index_add_(0, seg, torch.where(hit, pres, 0))
    hits = torch.zeros(C, dtype=torch.int64, device=dev)
    hits.index_add_(0, seg, hit.to(torch.int64))
    nonempty = sizes > 0
    brd[nonempty] = hits[nonempty].double() / sizes[nonempty].double()
    return vec, brd


def bray_curtis_matrix(vectors: torch.Tensor) -> torch.Tensor:
    """Pairwise Bray-Curtis (DistanceMatrixCalculatorMain.java:140-153),
    in float64: the sums are of integers below 2**53, so exact in any
    order."""
    v = vectors.to(torch.float64)
    num = (v[:, None, :] - v[None, :, :]).abs().sum(-1)
    tot = v.abs().sum(-1)
    den = tot[:, None] + tot[None, :]
    d = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    d.fill_diagonal_(0.0)
    return d


def matrix_pipeline(sample_files: list[list[str]] | list[str],
                    k: int = 31, b: int = 1, l: int = 100,
                    b1: int = 1000, b2: int = 10000,
                    feature_threshold: int = 0,
                    device: str | torch.device = "cuda",
                    progress=None) -> MatrixResult:
    """Run the full default pipeline on S samples on ``device``.

    sample_files: either a flat list of paths (one file per sample) or a
    list of per-sample file groups (paired-end reads).  ``progress``, if
    given, is called as progress(stage, sample_name, info) at the end of
    each stage.
    """
    dev = resolve_device(device)
    groups = [[f] if isinstance(f, (str, os.PathLike)) else list(f)
              for f in sample_files]
    names = [sample_name([str(p) for p in g]) for g in groups]

    tables = []
    contigs_per_sample = []
    all_seqs: list[str] = []
    for name, g in zip(names, groups):
        keys, counts, stats = api.count_reads_files([str(p) for p in g], k,
                                                    dev)
        keep = counts > b
        keys, counts = keys[keep], counts[keep]
        tables.append((keys, counts))
        if progress is not None:
            progress("count", name, stats)
        seqs = contigs_mod.build_contigs(keys, counts, k, l)
        contigs_per_sample.append(seqs)
        all_seqs.extend(s[0] for s in seqs)
        if progress is not None:
            progress("contigs", name, {"n": len(seqs)})

    gkeys, gcounts = count_contig_kmers(all_seqs, k, dev, min_len=l)
    components = comp_mod.split_components(gkeys, gcounts, k, b1, b2)
    if progress is not None:
        progress("components", "", {"n": len(components)})

    feats = [feature_vectors(components, keys, counts, feature_threshold)
             for keys, counts in tables]
    C = len(components)
    vectors = torch.stack([f[0] for f in feats]) if feats else \
        torch.zeros((0, C), dtype=torch.int64, device=dev)
    breadth = torch.stack([f[1] for f in feats]) if feats else \
        torch.zeros((0, C), dtype=torch.float64, device=dev)
    matrix = bray_curtis_matrix(vectors)
    if progress is not None:
        progress("matrix", "", {"components": C})
    return MatrixResult(
        names=names, matrix=matrix.cpu().numpy(),
        vectors=vectors.cpu().numpy(), breadth=breadth.cpu().numpy(),
        components=components_to_numpy(components),
        contigs_per_sample=contigs_per_sample,
        sample_tables=[(kk.cpu().numpy(), cc.cpu().numpy())
                       for kk, cc in tables])
