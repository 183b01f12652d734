#!/usr/bin/env python3
"""Smoke run of the PyTorch port (metafast_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. CUDA check, the card's name and power limit, kernel build.
  2. The stream-extraction kernel against its plain PyTorch version on
     the card, both layouts: one full 2^27-code slab of 150 bp reads at
     k=31, and 2^22 codes at k=11 and k=16.  Exact equality.
  3. The default matrix-builder pipeline at CAMI scale (the bench.py
     stress() data: 8 samples of 2.5 Mbp genomes sharing a 1 Mbp
     backbone, 12x coverage of 150 bp reads, seed 0; k=31, b=1, l=100,
     b1=1000, b2=10000), with per-stage seconds and peak device memory.
     Sample 0's raw table must equal the native single-thread counter's
     and the level-1 component count (walk_connected_labels, the route
     of a full-live level) the native BFS's.
  labels. On phase 3's data: (a) the splitter-walk list ranking
     (graph/rank.chain_rank) against pointer doubling (_doubling) on
     sample 0's successor forest and on the level-1 recount graph's,
     term / dist / reached equal, both timed in turns, with the walks
     and segments; (b) walk_connected_labels, star_connected_labels and
     hooking_connected_labels on the recount graph, equal labels, each
     timed three times; (c) split_components on that graph: per level
     the labeller its route took, its time and the level's active size,
     beside the other labellers on the same level (equal labels), and
     its components equal phase 3's; (d) walk against star labels on
     the full-live tables of the union of samples 0..j-1, j = 1-4 (2.5-7
     M keys), which place the walk route's size threshold.
  cli. The same eight files through the port's launcher, ``-t
     matrix-builder --device cuda --finish dist-matrix-calculator``
     in-process, with its wall and per-step seconds, peak device memory
     and the extraction kernel's launches counted from 0.  Its matrix and
     components.bin equal phase 3's written by the same writers, and
     sample 0's .kmers.bin the native table at count > 1.  A rerun with
     ``-c`` must skip every step and launch nothing.
  shards. The multi-device path at world size 1 (one card), over NCCL in
     this process, on phase 3's data: (a) count_reads_files_sharded of
     every sample equals count_reads_files and phase 3's table (timed
     per sample against both, K1 launches counted from 0); (b)
     sharded_doubling on sample 0's successor forest equals _doubling;
     (c) the star contraction (sharded_connected_labels) on the level-1
     recount graph equals the hooking labels and the single-device star
     contraction, all three timed; (d) the
     --shards launcher: one rank more than the GPUs exits 1 with the JAX
     message, and 2 CPU ranks (gloo) write the files of the unsharded
     run on the card (2 samples of 200 kbp).
  groups. Pipelines 5 and 2 (``-t stats-features`` and ``-t
     unique-features --min-samples 4 --max-samples 4``) through the
     launcher on 8 such samples (seed 0) where samples 0-3, the positive
     group, also share a 0.5 Mbp marker region: wall and per-step
     seconds, peak device memory, the extraction kernel's launches
     counted from 0 (at least one a sample), the pivots, the components
     and whether a traversal overflowed to the Python spec.  Positive
     sample 0's .kmers.bin equals the native table at count > 1; every
     pivot in the graph lies in a component; the pivot graph's neighbour
     index built on the card equals the CPU's and the native one (more
     than 2^21 keys).  Then both pipelines and ``component-extractor
     --depth 2`` at 3+3 samples of 200 kbp write the same files on the
     card and on the CPU.
  psort. The blocked bitonic sort kernel against its plain PyTorch
     version, each run with its launches counted from 0: through the
     public sort_arrays (a) the raw k-mer keys of stress sample 0 (its
     stream3 extraction, padded with SENTINEL to 2^25) and (b) 2^27 keys,
     45% random below 2^62, 45% from 1024 values, 10% SENTINEL, the run
     the JSON line reports; (c) through sort_arrays_blocked, 2^22 such
     keys at log_block 12, inside the kernel's tile.  Keys and the int32
     index payload equal, keys equal torch.sort's; kernel, plain and
     torch.sort + gather milliseconds beside the bound.  Then the pass
     plan, nvcc's register report, every tile size / register group
     width of the sweep at 2^27 (equal results, times) and the default's
     device time split by pass kind (torch.profiler).
  batch route. Stress sample 0 written as BINQ, counted (a) by
     count_reads_files (the Python reader's route), (b) through
     read_batches into add_batch with a forced host spill, (c) through
     the packed batches into add_packed_batch: each equals the native
     counter's table.
  4. The pipeline on the GPU against the same pipeline on the CPU (plain
     PyTorch versions) at 3 samples of 200 kbp: every field equal.

Prints one JSON line of kernel results (each with its bound: the bytes
it must move over the H100's 3.35 TB/s; the extraction kernel's
launches summed over phases 3 and shards, with each path's count under
``launches_by_path``), the card's name and power
limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

K = 31
READ_LEN = 150
PSORT_N = 1 << 27       # keys of the psort phase's part (b)
SPILL = 1 << 20         # spill threshold of the batch route's part (b)
# phase groups' positive graph must be larger: the size from which the
# JAX package built the pivot index on its device (pivot.py _DEVICE_MIN)
PIVOT_GRAPH_MIN = 1 << 21


def log(msg: str) -> None:
    print(msg, flush=True)


def write_samples(directory: Path, n_samples: int, genome_len: int,
                  shared_len: int, coverage: int, seed: int = 0,
                  marker: tuple[int, int] | None = None):
    """The bench.py stress() read sets: genomes sharing a backbone.  With
    ``marker`` = (length, n), the first n samples also share a marker
    region of that length after the backbone (a positive group)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = bases[rng.integers(0, 4, shared_len)]
    marker_len, n_marked = marker or (0, 0)
    mark = bases[rng.integers(0, 4, marker_len)] if marker else backbone[:0]
    files = []
    for s in range(n_samples):
        head = [backbone, mark] if s < n_marked else [backbone]
        private = genome_len - sum(len(h) for h in head)
        genome = np.concatenate(
            [*head, bases[rng.integers(0, 4, private)]])
        n_reads = genome_len * coverage // READ_LEN
        starts = rng.integers(0, genome_len - READ_LEN, n_reads)
        reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
        path = directory / f"stress_{s}.fa"
        with open(path, "wb") as fh:
            fh.write(b"".join(b">r%d\n%s\n" % (i, reads[i].tobytes())
                              for i in range(n_reads)))
        files.append(str(path))
    return files


def log_clocks(label: str) -> None:
    """The card's clocks, power draw and temperature, beside a phase."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"clocks before {label}: sm, mem, power, temperature = {out}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)


def bound_ms(n_bytes: int) -> float:
    """Least milliseconds to move n_bytes at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def phase_kernel(dev):
    """Phase 2: kernel == plain version on the card."""
    import torch

    from metafast_tpu_torch.api import SLAB_CODES
    from metafast_tpu_torch.ops import stream_extract as SE

    rng = np.random.default_rng(1)
    result = dict(max_abs_err=0, ms=None, plain_ms=None, bound_ms=None)
    for n_codes, k in ((SLAB_CODES, 31), (1 << 22, 11), (1 << 22, 16)):
        n_reads = n_codes // READ_LEN
        lengths = np.full(n_reads, READ_LEN, np.int32)
        codes = rng.integers(0, 4, n_reads * READ_LEN, dtype=np.uint8)
        inputs = {
            "stream3": SE.to_device(SE.build_stream3(codes, lengths, k), dev),
            "columns": SE.to_device(SE.build_stream(codes, lengths, k), dev),
        }
        for layout, arrs in inputs.items():
            w0, w1, w2, vm = (arrs if layout == "stream3"
                              else (arrs[0], None, None, arrs[1]))
            before = SE.stream_extract.launches
            got = SE.stream_extract(w0, w1, w2, vm, k, layout=layout)
            torch.cuda.synchronize()
            if SE.stream_extract.launches != before + 1:
                raise RuntimeError("launch counter did not move")
            want = SE.stream_extract_torch(w0, w1, w2, vm, k, layout=layout)
            err = int((got - want).abs().max())
            if not torch.equal(got, want):
                raise RuntimeError(f"kernel != plain: k={k} {layout} "
                                   f"max_abs_err={err}")
            del got, want
            ms = cuda_ms(lambda: SE.stream_extract(w0, w1, w2, vm, k,
                                                   layout=layout), 20)
            plain_ms = cuda_ms(lambda: SE.stream_extract_torch(
                w0, w1, w2, vm, k, layout=layout), 3)
            n_keys = 16 * w0.numel()
            # each input word read once, 16 int64 keys per word written once
            bound = bound_ms(n_keys * 8 + sum(
                a.numel() * a.element_size() for a in (w0, w1, w2, vm)
                if a is not None))
            log(f"kernel k={k} layout={layout} codes={n_codes} "
                f"words={w0.numel()} equal=True max_abs_err={err} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bound:.4f} "
                f"written_GB_per_s={n_keys * 8 / ms / 1e6:.1f}")
            if (n_codes, k, layout) == (SLAB_CODES, K, "stream3"):
                result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound)
            result["max_abs_err"] = max(result["max_abs_err"], err)
        del inputs
    return result


def native_counts(lib, codes, lengths):
    """Sample table from the native single-thread counter (keys + 1
    stored, 0 = empty slot)."""
    total = int(np.maximum(lengths.astype(np.int64) - K + 1, 0).sum())
    log2 = max(int(np.ceil(np.log2(2 * max(total, 1)))), 4)
    table = np.zeros(1 << log2, np.uint64)
    counts = np.zeros(1 << log2, np.uint16)
    uniq = ctypes.c_int64(0)
    lib.count_kmers_baseline(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(lengths), K,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        log2, ctypes.byref(uniq))
    nz = table != 0
    keys = (table[nz] - np.uint64(1)).astype(np.int64)
    order = np.argsort(keys)
    return keys[order], counts[nz][order].astype(np.int32)


def native_components(lib, keys, counts) -> int:
    """Connected components of the whole table by native BFS."""
    n = len(keys)
    log2 = max(int(np.ceil(np.log2(2 * max(n, 1)))), 4)
    ku = np.ascontiguousarray(keys.astype(np.uint64))
    kc = np.ascontiguousarray(counts.astype(np.int32))
    ncomp = ctypes.c_int64(0)
    lib.bfs_components_baseline(
        ku.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        kc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, K, log2,
        ctypes.byref(ncomp))
    return int(ncomp.value)


def phase_pipeline(dev, workdir: Path):
    """Phase 3: the full pipeline at CAMI scale; returns the kernel's
    launches, sample 0's parsed (codes, lengths) and its native table."""
    import torch

    from metafast_tpu_torch import api
    from metafast_tpu_torch.graph import components as comp
    from metafast_tpu_torch.ops import stream_extract as SE
    from metafast_tpu_torch.pipeline.matrix import (count_contig_kmers,
                                                    matrix_pipeline)
    from metafast_tpu_torch.utils.device import synchronize
    from metafast_tpu_torch.utils.native import native_library

    n_samples, genome, shared, cov = 8, 2_500_000, 1_000_000, 12
    t0 = time.perf_counter()
    files = write_samples(workdir, n_samples, genome, shared, cov, seed=0)
    log(f"pipeline data: S={n_samples} (not cut) genome={genome} "
        f"shared={shared} coverage={cov} read_len={READ_LEN} seed=0 "
        f"setup_s={time.perf_counter() - t0:.2f}")

    marks = []
    uniques = []

    def progress(stage, name, info):
        synchronize(dev)
        marks.append((stage, time.perf_counter()))
        if stage == "count":
            uniques.append(info["unique"])

    synchronize(dev)
    torch.cuda.reset_peak_memory_stats()
    SE.stream_extract.launches = 0
    t0 = time.perf_counter()
    res = matrix_pipeline(files, k=K, b=1, l=100, b1=1000, b2=10000,
                          device=dev, progress=progress)
    synchronize(dev)
    wall = time.perf_counter() - t0
    launches = SE.stream_extract.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    stages: dict[str, float] = {}
    prev = t0
    for stage, t in marks:
        stages[stage] = stages.get(stage, 0.0) + t - prev
        prev = t
    mat = res.matrix
    S = len(files)
    off = mat[~np.eye(S, dtype=bool)]
    log(f"pipeline wall_s={wall:.3f} stage_s="
        + json.dumps({s: round(v, 3) for s, v in stages.items()})
        + f" peak_device_GB={peak_gb:.3f} launches={launches}")
    log(f"pipeline uniques_per_sample={uniques} filtered_per_sample="
        f"{[len(t[0]) for t in res.sample_tables]} contigs_per_sample="
        f"{[len(c) for c in res.contigs_per_sample]} "
        f"components={len(res.components)} "
        f"offdiag_min={off.min():.6f} offdiag_max={off.max():.6f}")
    if launches < 1:
        raise RuntimeError("the pipeline did not launch the kernel")
    if not (mat.shape == (S, S) and np.isfinite(mat).all()
            and np.allclose(mat, mat.T) and (np.diag(mat) == 0).all()
            and (off > 0).all() and (off <= 1).all()):
        raise RuntimeError(f"implausible distance matrix:\n{mat}")
    if not res.components or (res.vectors < 0).any():
        raise RuntimeError("no components or negative feature values")

    # sample 0's raw table against the native counter
    lib = native_library()
    keys, counts, _ = api.count_reads_files([files[0]], K, dev)
    codes, lengths, _, _ = api.parse_reads(files[0])
    nkeys, ncounts = native_counts(lib, codes, lengths)
    if not (np.array_equal(keys.cpu().numpy(), nkeys)
            and np.array_equal(counts.cpu().numpy(), ncounts)):
        raise RuntimeError("sample 0 table != native count_kmers_baseline")
    log(f"check sample0 table == native count_kmers_baseline: "
        f"{len(nkeys)} keys")

    # level-1 components of the contig graph against the native BFS
    seqs = [s[0] for c in res.contigs_per_sample for s in c]
    gkeys, gcounts = count_contig_kmers(seqs, K, dev, min_len=100)
    # by the labeller split_components takes on this full-live level
    if gkeys.numel() < comp._WALK_MIN:
        raise RuntimeError(f"the recount graph ({gkeys.numel()} keys) is "
                           "below the walk route's size")
    labels = comp.walk_connected_labels(gkeys, K)
    n_level1 = int(torch.unique(labels).numel())
    n_native = native_components(lib, gkeys.cpu().numpy(),
                                 gcounts.cpu().numpy())
    if n_level1 != n_native:
        raise RuntimeError(f"level-1 components {n_level1} != native "
                           f"BFS {n_native}")
    log(f"check level-1 components == native bfs_components_baseline: "
        f"{n_level1} over {gkeys.numel()} keys")
    return launches, files, res, (codes, lengths), (nkeys, ncounts), stages


LABEL_REPS = 3     # repeats of each timed labeller in phase labels


def phase_labels(dev, res) -> None:
    """Phase labels, on phase 3's data: (a) chain_rank against _doubling
    on sample 0's successor forest and on the level-1 recount graph's;
    (b) walk, star and hooking labels on the recount graph, each timed
    LABEL_REPS times; (c) split_components on that graph, every level's
    labeller timed beside the alternatives on the same level, and its
    components against phase 3's; (d) walk against star on the unions
    of 1-4 sample tables."""
    import torch

    from metafast_tpu_torch.graph import components as comp
    from metafast_tpu_torch.graph import contigs, dbg, rank
    from metafast_tpu_torch.pipeline.matrix import count_contig_kmers
    from metafast_tpu_torch.state import components_to_numpy

    t_phase = time.perf_counter()
    seqs = [s[0] for c in res.contigs_per_sample for s in c]
    gkeys, gcounts = count_contig_kmers(seqs, K, dev, min_len=100)
    keys0 = torch.from_numpy(res.sample_tables[0][0]).to(dev)

    # (a) list ranking: splitter walks against pointer doubling, in turns
    for name, keys in (("sample0", keys0), ("recount", gkeys)):
        t = dbg.neighbor_tables(keys, K)
        succ, _, _ = contigs._succ_from_tables(keys, t["left"], t["right"], K)
        del t
        valid = torch.ones(succ.numel(), dtype=torch.bool, device=dev)
        dbl_s, walk_s = [], []
        for _ in range(LABEL_REPS):
            (term, dist, reached), sec = timed(
                dev, lambda: contigs._doubling(succ))
            dbl_s.append(sec)
            r, sec = timed(dev, lambda: rank.chain_rank(succ, valid))
            walk_s.append(sec)
        if not (torch.equal(r["reached"], reached)
                and torch.equal(r["term"][reached], term[reached])
                and torch.equal(r["dist"][reached], dist[reached])):
            raise RuntimeError(f"labels (a): chain_rank != _doubling on "
                               f"the {name} forest")
        log(f"labels (a) chain_rank == _doubling on the {name} forest: "
            f"{succ.numel()} nodes, {int(reached.sum())} reached, "
            f"{r['n_walks']} walks, {r['segments']} segments of "
            f"{rank._SEG_ROUNDS} rounds: "
            f"chain_rank_s={[round(x, 4) for x in walk_s]} "
            f"doubling_s={[round(x, 4) for x in dbl_s]}")
        del succ, valid, term, dist, reached, r

    # (b) the three labellers on the recount graph
    tables, tables_s = timed(dev, lambda: dbg.neighbor_tables(gkeys, K))
    nbr, adj_s = timed(dev, lambda: comp._adjacency(tables))
    active = torch.ones(gkeys.numel(), dtype=torch.bool, device=dev)
    times = {"walk": [], "star": [], "hooking": []}
    for _ in range(LABEL_REPS):
        walk, sec = timed(dev, lambda: comp.walk_connected_labels(
            gkeys, K, tables))
        times["walk"].append(sec)
        star, sec = timed(dev, lambda: comp.star_connected_labels(
            nbr, active))
        times["star"].append(sec)
        hook, sec = timed(dev, lambda: comp.hooking_connected_labels(
            nbr, active))
        times["hooking"].append(sec)
        if not (torch.equal(walk, star) and torch.equal(walk, hook)):
            raise RuntimeError("labels (b): walk, star and hooking labels "
                               "differ")
    log(f"labels (b) walk == star == hooking labels over {gkeys.numel()} "
        f"keys, {int(torch.unique(walk).numel())} components: "
        + " ".join(f"{n}_s={[round(x, 4) for x in v]}"
                   for n, v in times.items())
        + f" (from the tables: neighbor_tables_s={tables_s:.4f}, "
        f"adjacency_s={adj_s:.4f})")
    del tables, nbr, active, walk, star, hook

    # (c) split_components: each level's labeller beside the others
    orig = {n: getattr(comp, f"{n}_connected_labels")
            for n in ("walk", "star", "hooking")}
    levels = []

    def on_level(route, args, alts):
        out, sec = timed(dev, lambda: orig[route](*args))
        row = {"labeller": route, "s": round(sec, 4)}
        for alt, fn in alts.items():
            got, sec = timed(dev, fn)
            if not torch.equal(got, out):
                raise RuntimeError(f"labels (c): level {len(levels) + 1} "
                                   f"{alt} != {route}")
            row[f"{alt}_s"] = round(sec, 4)
        levels.append(row)
        return out

    def walk_level(keys, k, tables=None):
        tables = dbg.neighbor_tables(keys, k) if tables is None else tables
        nbr = comp._adjacency(tables)
        active = torch.ones(keys.numel(), dtype=torch.bool, device=dev)
        out = on_level("walk", (keys, k, tables), {
            "star": lambda: orig["star"](nbr, active),
            "hooking": lambda: orig["hooking"](nbr, active)})
        levels[-1].update(M=keys.numel(), active=keys.numel())
        return out

    def edge_level(route, other):
        def level(nbr, active):
            out = on_level(route, (nbr, active), {
                other: lambda: orig[other](nbr, active)})
            levels[-1].update(M=nbr.shape[1], active=int(active.sum()))
            return out
        return level

    try:
        comp.walk_connected_labels = walk_level
        comp.star_connected_labels = edge_level("star", "hooking")
        comp.hooking_connected_labels = edge_level("hooking", "star")
        found, split_s = timed(dev, lambda: comp.split_components(
            gkeys, gcounts, K, 1000, 10000))
    finally:
        for n, fn in orig.items():
            setattr(comp, f"{n}_connected_labels", fn)
    found = components_to_numpy(found)
    if len(found) != len(res.components) or not all(
            np.array_equal(a.kmers, b.kmers) and a.weight == b.weight
            and a.used_freq_threshold == b.used_freq_threshold
            for a, b in zip(found, res.components)):
        raise RuntimeError("labels (c): split_components != phase 3")
    for i, row in enumerate(levels):
        log(f"labels (c) level {i + 1}: " + json.dumps(row))
    log(f"labels (c) split_components == phase 3 ({len(found)} "
        f"components), {len(levels)} levels; split_s={split_s:.3f} with "
        f"the alternatives timed inside")

    # (d) where the walk route starts: walk against star on full-live
    # tables between the levels of (c), the unions of the first j
    # samples' tables
    for j in (1, 2, 3, 4):
        keys = torch.unique(torch.cat([torch.from_numpy(t[0]).to(dev)
                                       for t in res.sample_tables[:j]]))
        tables = dbg.neighbor_tables(keys, K)
        nbr = comp._adjacency(tables)
        active = torch.ones(keys.numel(), dtype=torch.bool, device=dev)
        walk_s, star_s = [], []
        for _ in range(LABEL_REPS):
            walk, sec = timed(dev, lambda: comp.walk_connected_labels(
                keys, K, tables))
            walk_s.append(sec)
            star, sec = timed(dev, lambda: comp.star_connected_labels(
                nbr, active))
            star_s.append(sec)
            if not torch.equal(walk, star):
                raise RuntimeError(f"labels (d): walk != star labels over "
                                   f"{j} samples")
        log(f"labels (d) walk == star labels over the union of {j} "
            f"sample tables, {keys.numel()} keys (walk route from "
            f"{comp._WALK_MIN}): walk_s={[round(x, 4) for x in walk_s]} "
            f"star_s={[round(x, 4) for x in star_s]}")
        del keys, tables, nbr, active, walk, star
    log(f"labels phase_s={time.perf_counter() - t_phase:.3f}")


CLI_STEPS = ["kmer-counter-many", "seq-builder-many", "component-cutter",
             "features-calculator", "dist-matrix-calculator"]


def phase_cli(dev, files, res, native, workdir: Path) -> None:
    """Phase cli: matrix-builder through the port's launcher on the phase 3
    files, up to dist-matrix-calculator; its files against phase 3's
    result and the native table; then a --continue rerun that must skip
    every step and launch nothing."""
    import torch

    from metafast_tpu_torch import cli
    from metafast_tpu_torch.io import binfmt, textfmt
    from metafast_tpu_torch.ops import stream_extract as SE
    from metafast_tpu_torch.utils.device import synchronize

    wd = workdir / "cli"
    args = ["-t", "matrix-builder", "-k", str(K), "-i", *files,
            "-b", "1", "-l", "100", "-b1", "1000", "-b2", "10000",
            "-w", str(wd), "--device", "cuda",
            "--finish", "dist-matrix-calculator"]

    def run(extra):
        logged = (wd / "log").read_text() if (wd / "log").exists() else ""
        synchronize(dev)
        torch.cuda.reset_peak_memory_stats()
        SE.stream_extract.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(args + extra)
        synchronize(dev)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli {' '.join(extra)} exited {rc}")
        return (wall, SE.stream_extract.launches,
                torch.cuda.max_memory_allocated() / 1e9,
                (wd / "log").read_text()[len(logged):])

    wall, launches, peak_gb, text = run([])
    step_s: dict[str, float] = {}
    for name, s in re.findall(r"\[([\w-]+)\] done in ([\d.]+)s", text):
        step_s[name] = round(step_s.get(name, 0.0) + float(s), 3)
    log(f"cli wall_s={wall:.3f} step_s={json.dumps(step_s)} "
        f"peak_device_GB={peak_gb:.3f} launches={launches}")
    if launches < 1:
        raise RuntimeError("the CLI did not launch the extraction kernel")

    with tempfile.TemporaryDirectory() as td:
        want_mat = Path(td) / "matrix.txt"
        textfmt.write_dist_matrix(str(want_mat), res.matrix, res.names)
        want_comps = Path(td) / "components.bin"
        binfmt.write_components_bin(
            str(want_comps), [(c.kmers, c.weight) for c in res.components])
        (got_mat,) = (wd / "matrices").glob("dist_matrix_*_original_order.txt")
        if got_mat.read_bytes() != want_mat.read_bytes():
            raise RuntimeError("cli matrix != phase 3 matrix")
        if ((wd / "component-cutter" / "components.bin").read_bytes()
                != want_comps.read_bytes()):
            raise RuntimeError("cli components.bin != phase 3 components")
    nkeys, ncounts = native
    good = ncounts > 1
    keys, counts = binfmt.read_kmers_bin(
        str(wd / "kmer-counter-many" / "kmers" / "stress_0.kmers.bin"))
    if not (np.array_equal(keys, nkeys[good])
            and np.array_equal(counts, ncounts[good])):
        raise RuntimeError("cli stress_0.kmers.bin != native table, count > 1")
    log(f"check cli matrix and components.bin == phase 3 "
        f"({len(res.components)} components), stress_0.kmers.bin == native "
        f"count > 1 ({len(keys)} keys)")

    wall_c, launches_c, _, text = run(["-c"])
    skipped = re.findall(r"\[([\w-]+)\] up to date, skipped", text)
    ran = re.findall(r"\[([\w-]+)\] started", text)
    log(f"cli -c wall_s={wall_c:.3f} skipped={skipped} launches={launches_c}")
    if skipped != CLI_STEPS or ran != ["matrix-builder"] or launches_c:
        raise RuntimeError(f"cli -c: skipped {skipped}, started {ran}, "
                           f"{launches_c} launches")


def timed(dev, fn):
    """(fn's result, seconds on the host clock, device synchronised)."""
    from metafast_tpu_torch.utils.device import synchronize

    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def phase_shards(dev, files, res, native, count_s: float,
                 workdir: Path) -> int:
    """Phase shards: the multi-device path at world size 1 (one card),
    over NCCL in this process: (a) count_reads_files_sharded on every
    stress sample against phase 3's tables, timed against the
    single-device count; (b) sharded_doubling on sample 0's successor
    forest against _doubling; (c) the star contraction on the level-1
    recount graph against the hooking labels; (d) the --shards launcher:
    2 ranks exceed the one card, and 2 CPU ranks write the work dir of
    the unsharded run on the card.  Returns K1's launches in (a)."""
    import contextlib
    import io

    import torch

    from metafast_tpu_torch import api, cli
    from metafast_tpu_torch.graph import components as comp
    from metafast_tpu_torch.graph import contigs, dbg
    from metafast_tpu_torch.ops import stream_extract as SE
    from metafast_tpu_torch.parallel import distributed as D
    from metafast_tpu_torch.parallel.components import (
        sharded_connected_labels)
    from metafast_tpu_torch.parallel.contigs import sharded_doubling
    from metafast_tpu_torch.pipeline.matrix import count_contig_kmers

    t_phase = time.perf_counter()
    mesh, init_s = timed(dev, lambda: D.initialize(
        1, 0, f"file://{workdir / 'store'}", dev.type))
    # the communicator is made at the first collective: time it apart
    _, first_s = timed(dev, lambda: D.all_reduce(mesh, 0))
    log(f"shards: world size {mesh.size}, backend "
        f"{torch.distributed.get_backend()}, device {mesh.device}: "
        f"init_s={init_s:.4f} first_collective_s={first_s:.4f}")

    # (a) every sample through the sharded route, against phase 3
    single_s, sharded_s = [], []
    launches = 0
    for i, path in enumerate(files):
        SE.stream_extract.launches = 0
        (keys, counts, stats), sec = timed(dev, lambda: (
            api.count_reads_files_sharded([path], K, mesh)))
        launches += SE.stream_extract.launches
        sharded_s.append(sec)
        (skeys, scounts, sstats), sec = timed(dev, lambda: (
            api.count_reads_files([path], K, dev)))
        single_s.append(sec)
        keep = counts > 1
        fk, fc = res.sample_tables[i]
        if not (torch.equal(keys, skeys) and torch.equal(counts, scounts)
                and stats == sstats
                and np.array_equal(keys[keep].cpu().numpy(), fk)
                and np.array_equal(counts[keep].cpu().numpy(), fc)):
            raise RuntimeError(f"shards (a): sample {i} sharded table != "
                               "single-device / phase 3 table")
        if i == 0 and not (np.array_equal(keys.cpu().numpy(), native[0])
                           and np.array_equal(counts.cpu().numpy(),
                                              native[1])):
            raise RuntimeError("shards (a): sample 0 != native table")
    if launches < len(files):
        raise RuntimeError(f"shards (a): {launches} K1 launches for "
                           f"{len(files)} samples")
    log(f"shards (a) count_reads_files_sharded == count_reads_files == "
        f"phase 3 tables, {len(files)} samples: sharded_s_per_sample="
        f"{np.mean(sharded_s):.4f} (max {max(sharded_s):.4f}) "
        f"single_s_per_sample={np.mean(single_s):.4f} (max "
        f"{max(single_s):.4f}) phase3_count_s_per_sample="
        f"{count_s / len(files):.4f} launches={launches}")

    # (b) sample 0's successor forest
    keys, counts = (torch.from_numpy(a).to(dev) for a in res.sample_tables[0])
    t = dbg.neighbor_tables(keys, K)
    succ, _, _ = contigs._succ_from_tables(keys, t["left"], t["right"], K)
    want, single = timed(dev, lambda: contigs._doubling(succ))
    got, sharded = timed(dev, lambda: sharded_doubling(succ, mesh))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("shards (b): sharded_doubling != _doubling")
    log(f"shards (b) sharded_doubling == _doubling over {succ.numel()} "
        f"nodes: sharded_s={sharded:.4f} single_s={single:.4f}")

    # (c) the level-1 recount graph: star contraction against hooking
    seqs = [s[0] for c in res.contigs_per_sample for s in c]
    gkeys, _ = count_contig_kmers(seqs, K, dev, min_len=100)
    nbr = comp.adjacency(gkeys, K)
    active = torch.ones(gkeys.numel(), dtype=torch.bool, device=dev)
    want, hooking = timed(dev, lambda: comp.hooking_connected_labels(
        nbr, active))
    single, star1 = timed(dev, lambda: comp.star_connected_labels(
        nbr, active))
    got, star = timed(dev, lambda: sharded_connected_labels(nbr, active,
                                                            mesh))
    if not (torch.equal(got, want) and torch.equal(got, single)):
        raise RuntimeError("shards (c): sharded star contraction != "
                           "hooking / single-device star labels")
    log(f"shards (c) sharded_connected_labels == hooking_connected_labels "
        f"== star_connected_labels over {gkeys.numel()} keys, "
        f"{int(torch.unique(got).numel())} components: star_s={star:.4f} "
        f"hooking_s={hooking:.4f} single_star_s={star1:.4f}")
    D.shutdown()
    del nbr, active, got, want, single

    # (d) the launcher
    small = workdir / "shards_small"
    small.mkdir()
    sfiles = write_samples(small, 2, 200_000, 80_000, 12, seed=4)
    args = ["-k", str(K), "-i", *sfiles, "-b", "1", "-l", "100", "-b1",
            "1000", "-b2", "10000", "--finish", "dist-matrix-calculator"]
    gpus = torch.cuda.device_count()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*args, "-w", str(small / "over"), "--shards",
                       str(gpus + 1), "--device", "cuda"])
    want_msg = f"ERROR: --shards {gpus + 1} exceeds available devices ({gpus})"
    if rc != 1 or want_msg not in out.getvalue() or (small / "over").exists():
        raise RuntimeError(f"shards (d): --shards {gpus + 1} --device cuda "
                           f"exited {rc}: {out.getvalue()!r}")
    rc_sharded, sharded = timed(dev, lambda: cli.main(
        [*args, "-w", str(small / "cpu2"), "--shards", "2",
         "--device", "cpu"]))
    rc_single, single = timed(dev, lambda: cli.main(
        [*args, "-w", str(small / "cuda1"), "--device", "cuda"]))
    got = workdir_tree(small / "cpu2")
    want = workdir_tree(small / "cuda1")
    if rc_sharded or rc_single or got != want or not got:
        differ = sorted(set(got) ^ set(want)) or [
            r for r in want if got.get(r) != want[r]]
        raise RuntimeError(f"shards (d): --shards 2 --device cpu != "
                           f"unsharded cuda in {differ[:5]}")
    log(f"shards (d) --shards {gpus + 1} --device cuda exits 1 on {gpus} "
        f"GPU(s); --shards 2 --device cpu "
        f"(2 x 200 kbp) == unsharded --device cuda, {len(got)} files: "
        f"shards_cpu_s={sharded:.3f} single_cuda_s={single:.3f}")
    log(f"shards phase_s={time.perf_counter() - t_phase:.3f}")
    return launches


GROUP_RUNS = {
    # run: (extra arguments, pivot file under the work dir)
    "stats-features": ([], "stats-kmers/kmers/filtered_groupA.kmers.bin"),
    "unique-features": (["--min-samples", "4", "--max-samples", "4"],
                        "unique-kmers-multi/kmers/filtered_4.kmers.bin"),
}
_TS = re.compile(rb"\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}")


def workdir_tree(wd: Path) -> dict:
    """A CLI work dir as {relative path: bytes}, without its logs, with
    run timestamps and the work dir's own path masked."""
    out = {}
    for p in sorted(wd.rglob("*")):
        rel = p.relative_to(wd)
        if p.is_dir() or rel.parts[0] in ("log", "logs"):
            continue
        out[_TS.sub(b"<ts>", str(rel).encode())] = _TS.sub(
            b"<ts>", p.read_bytes().replace(str(wd).encode(), b"<wd>"))
    return out


def group_run(dev, name: str, files, wd: Path, device: str, extra=()):
    """One group tool through the port's launcher: (wall s, extraction
    kernel launches counted from 0, peak device GB, the run's log)."""
    import torch

    from metafast_tpu_torch import cli
    from metafast_tpu_torch.ops import stream_extract as SE
    from metafast_tpu_torch.utils.device import synchronize

    args = ["-t", name, "-k", str(K), *files, *extra, "-w", str(wd),
            "--device", device]
    synchronize(dev)
    torch.cuda.reset_peak_memory_stats()
    SE.stream_extract.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(args)
    synchronize(dev)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name} on {device} exited {rc}")
    return (wall, SE.stream_extract.launches,
            torch.cuda.max_memory_allocated() / 1e9, (wd / "log").read_text())


def phase_groups(dev, workdir: Path) -> None:
    """Phase groups: pipelines 5 and 2 through the launcher on 8 samples
    (positive = the 4 that share a marker region), checked against the
    native counter, their own pivots and the CPU; then both pipelines and
    a depth-2 component-extractor at 3+3 samples of 200 kbp, equal on
    the card and on the CPU, file for file."""
    import torch

    from metafast_tpu_torch import api
    from metafast_tpu_torch.graph import pivot
    from metafast_tpu_torch.io import binfmt
    from metafast_tpu_torch.utils.native import native_library

    gdir = workdir / "groups"
    gdir.mkdir()
    n_samples, genome, shared, marker, cov = 8, 2_500_000, 1_000_000, 500_000, 12
    t0 = time.perf_counter()
    files = write_samples(gdir, n_samples, genome, shared, cov, seed=0,
                          marker=(marker, 4))
    groups = ["-pos", *files[:4], "-neg", *files[4:]]
    log(f"groups data: S={n_samples} (positive 0-3 with a {marker} bp "
        f"marker) genome={genome} shared={shared} coverage={cov} seed=0 "
        f"setup_s={time.perf_counter() - t0:.2f}")

    for name, (extra, pivot_file) in GROUP_RUNS.items():
        wd = gdir / name
        wall, launches, peak_gb, text = group_run(dev, name, groups, wd,
                                                  "cuda", extra)
        step_s: dict[str, float] = {}
        for step, sec in re.findall(r"\[([\w-]+)\] done in ([\d.]+)s", text):
            step_s[step] = round(step_s.get(step, 0.0) + float(sec), 3)
        pivots, _ = binfmt.read_kmers_bin(str(wd / pivot_file))
        comps = binfmt.read_components_bin(
            str(wd / "component-extractor" / "components.bin"))
        overflow = "members buffer overflow" in text
        log(f"groups {name} wall_s={wall:.3f} step_s={json.dumps(step_s)} "
            f"peak_device_GB={peak_gb:.3f} launches={launches} "
            f"pivots={len(pivots)} components={len(comps)} "
            f"component_kmers={sum(len(c[0]) for c in comps)} "
            f"overflow_branch_taken={overflow}")
        if launches < n_samples:
            raise RuntimeError(f"groups {name}: {launches} extraction "
                               f"launches, fewer than {n_samples} samples")
        if not comps:
            raise RuntimeError(f"groups {name}: no components")
        pos = [str(wd / "kmer-counter-posneg" / "pos" / "kmers" /
                   f"stress_{i}.kmers.bin") for i in range(4)]
        graph = np.unique(np.concatenate(
            [binfmt.read_kmers_bin(f)[0] for f in pos]))
        members = np.concatenate([c[0] for c in comps])
        lost = ~np.isin(pivots[np.isin(pivots, graph)], members)
        if lost.any():
            raise RuntimeError(f"groups {name}: {int(lost.sum())} pivots of "
                               "the graph lie in no component")
    log(f"check groups: every pivot in the graph lies in a component "
        f"(graph of {len(graph)} keys)")

    # positive sample 0 against the native counter, at count > 1
    codes, lengths, _, _ = api.parse_reads(files[0])
    nkeys, ncounts = native_counts(native_library(), codes, lengths)
    keys, counts = binfmt.read_kmers_bin(pos[0])
    good = ncounts > 1
    if not (np.array_equal(keys, nkeys[good])
            and np.array_equal(counts, ncounts[good])):
        raise RuntimeError("groups stress_0.kmers.bin != native table, "
                           "count > 1")
    log(f"check groups stress_0.kmers.bin == native count > 1 "
        f"({len(keys)} keys)")

    # the pivot graph's neighbour index on the card against the CPU's and
    # the depth-1 route's int32 tables built on the CPU
    if len(graph) <= PIVOT_GRAPH_MIN:
        raise RuntimeError(f"groups: the positive graph has {len(graph)} "
                           f"keys, not more than {PIVOT_GRAPH_MIN}")
    tables, secs = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        tables[device] = [t.cpu() for t in pivot.neighbor_index(
            torch.from_numpy(graph).to(device), K)]
        secs[device] = time.perf_counter() - t0
    left, right = pivot.depth1_index(torch.from_numpy(graph), K)
    if not (all(torch.equal(a, b)
                for a, b in zip(tables["cuda"], tables["cpu"]))
            and np.array_equal(tables["cuda"][0].numpy(), right)
            and np.array_equal(tables["cuda"][1].numpy(), left)):
        raise RuntimeError("groups: neighbour index on cuda != cpu / "
                           "depth-1 tables")
    log(f"check groups neighbour index cuda == cpu == depth-1 tables over "
        f"{len(graph)} keys: cuda_s={secs['cuda']:.3f} "
        f"cpu_s={secs['cpu']:.3f}")

    # small scale: the card against the CPU, work dir for work dir
    small = workdir / "groups_small"
    small.mkdir()
    files = write_samples(small, 6, 200_000, 80_000, 12, seed=2,
                          marker=(40_000, 3))
    groups = ["-pos", *files[:3], "-neg", *files[3:]]
    runs = {name: (groups, extra) for name, (extra, _) in GROUP_RUNS.items()}
    runs["unique-features"] = (groups, ["--min-samples", "3",
                                        "--max-samples", "3"])
    sf = small / "cuda_stats-features"
    runs["component-extractor"] = (
        ["-i", *[str(sf / "kmer-counter-posneg" / "pos" / "kmers" /
                     f"stress_{i}.kmers.bin") for i in range(3)],
         "--pivot", str(sf / GROUP_RUNS["stats-features"][1])],
        ["--depth", "2"])
    for name, (inputs, extra) in runs.items():
        walls = {}
        for device in ("cuda", "cpu"):
            walls[device] = group_run(dev, name, inputs,
                                      small / f"{device}_{name}", device,
                                      extra)[0]
        got = workdir_tree(small / f"cuda_{name}")
        want = workdir_tree(small / f"cpu_{name}")
        if got != want:
            differ = sorted(set(got) ^ set(want)) or [
                r for r in want if got[r] != want[r]]
            raise RuntimeError(f"groups small {name}: cuda != cpu in "
                               f"{differ[:5]}")
        comps = binfmt.read_components_bin(
            str(small / f"cuda_{name}" / ("component-extractor/components.bin"
                                          if name != "component-extractor"
                                          else "components.bin")))
        if not comps:
            raise RuntimeError(f"groups small {name}: no components")
        log(f"check groups small (3+3, 200 kbp) {name} {' '.join(extra)}: "
            f"cuda == cpu, {len(got)} files, {len(comps)} components, "
            f"cuda_s={walls['cuda']:.3f} cpu_s={walls['cpu']:.3f}")


def psort_check(label: str, arrs, log_block: int, got) -> dict:
    """The kernel's result ``got`` against the plain version and
    torch.sort, then the three timed; raises on any difference."""
    import torch

    from metafast_tpu_torch.ops import psort

    keys, idx = arrs
    want = psort.sort_arrays_blocked_torch(arrs, log_block)
    err = float((got[0].double() - want[0].double()).abs().max())
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"psort {label}: kernel != plain "
                           f"(max_abs_err={err})")
    if not torch.equal(got[0], torch.sort(keys).values):
        raise RuntimeError(f"psort {label}: keys != torch.sort")
    del got, want

    def sort_and_gather():
        s = torch.sort(keys, stable=True)
        return s.values, idx[s.indices]

    ms = cuda_ms(lambda: psort.sort_arrays_blocked(arrs, log_block), 5)
    plain_ms = cuda_ms(lambda: psort.sort_arrays_blocked_torch(arrs,
                                                               log_block), 1)
    sort_ms = cuda_ms(sort_and_gather, 5)
    n = keys.numel()
    # keys and payload each read once and written once
    bound = bound_ms(2 * sum(a.numel() * a.element_size() for a in arrs))
    log(f"psort {label} n={n} log_block={log_block} equal=True "
        f"max_abs_err={err} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"torch_sort_ms={sort_ms:.4f} bound_ms={bound:.4f} "
        f"kernel_keys_per_s={n / ms * 1e3:.4e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=sort_ms)


def psort_schedules(keys, log_block: int) -> None:
    """The kernel at every tile size and register group width chosen
    from (T = 2^13, 2^14; r = 3, 4, 5), each equal to the default's
    result, timed in one call; then the default's device time split by
    pass kind from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from metafast_tpu_torch.ops import psort

    log_n = keys.numel().bit_length() - 1
    want = psort._sort_kernel(keys, log_block)
    configs = [(lt, r) for lt in (13, 14) for r in (3, 4, 5)]
    for lt, r in configs + [(psort.LOG_TILE, psort.FUSE)]:
        got = psort._sort_kernel(keys, log_block, lt, r)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"psort T=2^{lt} r={r} != default schedule")
        del got
        plan = psort._plan(log_n, lt, r)
        n_glob = sum(p[0] == "global" for p in plan)
        ms = cuda_ms(lambda: psort._sort_kernel(keys, log_block, lt, r), 3)
        log(f"psort schedule n=2^{log_n} T=2^{lt} r={r} passes: "
            f"global={n_glob} tile={len(plan) - n_glob} kernel_ms={ms:.4f}")
    del want
    # device time of each pass of the default schedule, from CUDA events
    marks = [torch.cuda.Event(enable_timing=True)]

    def mark(p):
        marks.append((p, torch.cuda.Event(enable_timing=True)))
        marks[-1][1].record()

    torch.cuda.synchronize()
    marks[0].record()
    psort._sort_kernel(keys, log_block, after_pass=mark)
    torch.cuda.synchronize()
    prev, split = marks[0], {"first tile": [], "tile": [], "global": []}
    for i, (p, ev) in enumerate(marks[1:]):
        split["first tile" if i == 0 else p[0]].append(prev.elapsed_time(ev))
        prev = ev
    log("psort passes (default schedule, CUDA events): " + ", ".join(
        f"{k} n={len(v)} mean_ms={np.mean(v):.4f} sum_ms={np.sum(v):.3f}"
        for k, v in split.items() if v))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        psort._sort_kernel(keys, log_block)
        torch.cuda.synchronize()
    split: dict[str, list] = {}
    for e in prof.key_averages():
        kind = ("tile_pass" if "tile_pass" in e.key else
                "global_pass" if "global_pass" in e.key else None)
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if kind and dev_us:
            acc = split.setdefault(kind, [0, 0.0])
            acc[0] += e.count
            acc[1] += dev_us / 1e3
    log("psort profile (default schedule, one call): " + (", ".join(
        f"{k} launches={c} device_ms={t:.3f}" for k, (c, t) in
        sorted(split.items())) or "no device time recorded: not measured"))


def phase_psort(dev, sample0) -> dict:
    """Phase psort: the kernel through the public sort_arrays on the raw
    keys of stress sample 0 and on 2^27 heavy-tie keys, and through
    sort_arrays_blocked at log_block 12 (inside the tile) on 2^22 keys,
    each run counted from 0; the JSON line reports the 2^27 run."""
    import torch

    from metafast_tpu_torch.core.bitpack import SENTINEL
    from metafast_tpu_torch.kernels.build import build_log
    from metafast_tpu_torch.ops import psort
    from metafast_tpu_torch.ops import stream_extract as SE

    plan = psort._plan(PSORT_N.bit_length() - 1)
    n_glob = sum(p[0] == "global" for p in plan)
    log(f"psort plan n=2^{PSORT_N.bit_length() - 1} T=2^{psort.LOG_TILE} "
        f"r={psort.FUSE}: global_passes={n_glob} "
        f"tile_passes={len(plan) - n_glob}")
    for line in build_log("psort").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("psort ptxas: " + line.strip())

    def counted_sort(sort, arrs):
        torch.cuda.synchronize()
        psort.sort_arrays_blocked.launches = 0
        got = sort(arrs)
        torch.cuda.synchronize()
        launches = psort.sort_arrays_blocked.launches
        if launches < 1:
            raise RuntimeError("the psort kernel was not launched")
        return got, launches

    codes, lengths = sample0
    raw = SE.stream_extract(*SE.to_device(SE.build_stream3(codes, lengths, K),
                                          dev), K).reshape(-1)
    n = 1 << (raw.numel() - 1).bit_length()
    keys = torch.cat([raw, torch.full((n - raw.numel(),), SENTINEL,
                                      dtype=torch.int64, device=dev)])
    arrs = (keys, torch.arange(n, dtype=torch.int32, device=dev))
    del raw
    got, _ = counted_sort(psort.sort_arrays, arrs)
    psort_check(f"(a) sample0 raw keys ({int((keys != SENTINEL).sum())} "
                "live)", arrs, psort.LOG_BLOCK, got)
    del arrs, keys, got

    def heavy_ties(n, seed):
        rng = np.random.default_rng(seed)
        pool = rng.integers(0, 1 << 62, 1 << 10)
        r = rng.random(n, dtype=np.float32)
        keys = np.where(r < 0.45, rng.integers(0, 1 << 62, n),
                        pool[rng.integers(0, 1 << 10, n)])
        keys[r >= 0.9] = SENTINEL
        return (torch.from_numpy(keys).to(dev),
                torch.arange(n, dtype=torch.int32, device=dev))

    t0 = time.perf_counter()
    arrs = heavy_ties(PSORT_N, 3)
    log(f"psort (b) data n={PSORT_N} setup_s={time.perf_counter() - t0:.2f}")
    got, launches = counted_sort(psort.sort_arrays, arrs)
    result = psort_check("(b) 2^27 heavy ties", arrs, psort.LOG_BLOCK, got)
    result["launches"] = launches
    del got

    small = heavy_ties(1 << 22, 4)
    got, _ = counted_sort(lambda a: psort.sort_arrays_blocked(a, 12), small)
    psort_check("(c) 2^22 heavy ties, log_block 12", small, 12, got)
    del small, got

    psort_schedules(arrs[0], psort.LOG_BLOCK)
    return result


def phase_batch_route(dev, sample0, native, workdir: Path) -> None:
    """Phase batch route: the BINQ sample through the Python reader's
    route, with a forced spill, and the packed batch route."""
    from metafast_tpu_torch import api
    from metafast_tpu_torch.ops.count import KmerCounter, SpilledError
    from metafast_tpu_torch.utils.device import synchronize

    nkeys, ncounts = native
    codes, lengths = sample0
    binq = api.write_binq(workdir / "stress_0.binq", codes, lengths)

    def same(label, keys, counts):
        if not (np.array_equal(keys, nkeys)
                and np.array_equal(counts, ncounts)):
            raise RuntimeError(f"batch route {label}: table != native "
                               "count_kmers_baseline")

    t0 = time.perf_counter()
    keys, counts, stats = api.count_reads_files([binq], K, dev)
    synchronize(dev)
    ta = time.perf_counter() - t0
    same("(a) count_reads_files", keys.cpu().numpy(), counts.cpu().numpy())
    if (stats["reads"], stats["skipped"]) != (len(lengths), 0):
        raise RuntimeError(f"batch route (a): stats {stats}")

    t0 = time.perf_counter()
    counter = KmerCounter(K, dev, chunk=1 << 24, spill=SPILL)
    for batch in api.read_batches(binq, batch_reads=1 << 16):
        counter.add_batch(batch.codes, batch.lengths)
    try:
        counter.finish_device()
    except SpilledError:
        pass
    else:
        raise RuntimeError("batch route (b): finish_device did not raise "
                           "SpilledError")
    same("(b) add_batch with spill", *counter.finish())
    tb = time.perf_counter() - t0
    spills = counter.spill_events
    if spills < 1:
        raise RuntimeError("batch route (b): no spill event")

    t0 = time.perf_counter()
    counter = KmerCounter(K, dev)
    for packed, ls, L in api.packed_batches(codes, lengths):
        counter.add_packed_batch(packed, ls, L)
    same("(c) add_packed_batch", *counter.finish())
    tc = time.perf_counter() - t0
    log(f"batch route sample0 BINQ reads={stats['reads']} keys={len(nkeys)} "
        f"equal native: (a) count_reads_files_s={ta:.3f} "
        f"(b) add_batch_spill_s={tb:.3f} spill_events={spills} "
        f"(c) add_packed_batch_s={tc:.3f}")


def phase_gpu_vs_cpu(workdir: Path) -> None:
    """Phase 4: the GPU pipeline equals the CPU (plain versions) one."""
    from metafast_tpu_torch.pipeline.matrix import matrix_pipeline

    files = write_samples(workdir, 3, 200_000, 80_000, 12, seed=2)
    kw = dict(k=K, b=1, l=100, b1=1000, b2=10000)
    t0 = time.perf_counter()
    gpu = matrix_pipeline(files, device="cuda", **kw)
    t1 = time.perf_counter()
    cpu = matrix_pipeline(files, device="cpu", **kw)
    t2 = time.perf_counter()
    same = (gpu.names == cpu.names
            and np.array_equal(gpu.matrix, cpu.matrix)
            and np.array_equal(gpu.vectors, cpu.vectors)
            and np.array_equal(gpu.breadth, cpu.breadth)
            and gpu.contigs_per_sample == cpu.contigs_per_sample
            and len(gpu.components) == len(cpu.components)
            and all(np.array_equal(a.kmers, b.kmers)
                    and (a.weight, a.used_freq_threshold)
                    == (b.weight, b.used_freq_threshold)
                    for a, b in zip(gpu.components, cpu.components))
            and all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    for a, b in zip(gpu.sample_tables, cpu.sample_tables)))
    if not same or not gpu.components:
        raise RuntimeError("GPU pipeline != CPU pipeline at S=3, 200 kbp")
    log(f"check gpu == cpu pipeline (S=3, 200 kbp): components="
        f"{len(gpu.components)} gpu_s={t1 - t0:.3f} cpu_s={t2 - t1:.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 1
    from metafast_tpu_torch.kernels.build import load
    from metafast_tpu_torch.utils.device import resolve_device
    from metafast_tpu_torch.utils.native import native_library

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # one nvcc per kernel source, all started together, beside the g++
    # build of the native library
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(load, "stream_extract"),
                pool.submit(load, "psort"), pool.submit(native_library)]
        for f in futs:
            f.result()
    log(f"build: stream_extract.cu + psort.cu (nvcc, build/kernels/) + "
        f"native/fastparse.cpp (g++, build/native/) "
        f"build_s={time.perf_counter() - t0:.2f}")

    log_clocks("phase 2")
    kern = phase_kernel(dev)
    with tempfile.TemporaryDirectory() as td:
        launches, files, res, sample0, native, stages = phase_pipeline(
            dev, Path(td))
        log_clocks("phase labels")
        phase_labels(dev, res)
        phase_cli(dev, files, res, native, Path(td))
        log_clocks("phase shards")
        shard_launches = phase_shards(dev, files, res, native,
                                      stages["count"], Path(td))
        del res
        phase_groups(dev, Path(td))
        log_clocks("phase psort")
        sort = phase_psort(dev, sample0)
        phase_batch_route(dev, sample0, native, Path(td))
    with tempfile.TemporaryDirectory() as td:
        phase_gpu_vs_cpu(Path(td))

    print(json.dumps({"kernels": [{
        "name": "stream_extract",
        "route": "cuda",
        "source": "metafast_tpu_torch/csrc/stream_extract.cu",
        "replaces": "metafast_tpu/ops/stream_extract.py:389 (_kernel3); "
                    "metafast_tpu/ops/stream_extract.py:122 (_kernel)",
        "launches": launches + shard_launches,
        "launches_by_path": {"pipeline": launches, "shards": shard_launches},
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "psort",
        "route": "cuda",
        "source": "metafast_tpu_torch/csrc/psort.cu",
        "replaces": "metafast_tpu/ops/psort.py:99 (_tile_kernel)",
        "launches": sort["launches"],
        "max_abs_err": sort["max_abs_err"],
        "ms": sort["ms"],
        "plain_ms": sort["plain_ms"],
        "bound_ms": sort["bound_ms"],
        "bound_by": "bytes",
        "library_ms": sort["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
