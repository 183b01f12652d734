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
     and the level-1 component count the native BFS's.
  cli. The same eight files through the port's launcher, ``-t
     matrix-builder --device cuda --finish dist-matrix-calculator``
     in-process, with its wall and per-step seconds, peak device memory
     and the extraction kernel's launches counted from 0.  Its matrix and
     components.bin equal phase 3's written by the same writers, and
     sample 0's .kmers.bin the native table at count > 1.  A rerun with
     ``-c`` must skip every step and launch nothing.
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
it must move over the H100's 3.35 TB/s), the card's name and power
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


def log(msg: str) -> None:
    print(msg, flush=True)


def write_samples(directory: Path, n_samples: int, genome_len: int,
                  shared_len: int, coverage: int, seed: int = 0):
    """The bench.py stress() read sets: genomes sharing a backbone."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = bases[rng.integers(0, 4, shared_len)]
    files = []
    for s in range(n_samples):
        genome = np.concatenate(
            [backbone, bases[rng.integers(0, 4, genome_len - shared_len)]])
        n_reads = genome_len * coverage // READ_LEN
        starts = rng.integers(0, genome_len - READ_LEN, n_reads)
        reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
        path = directory / f"stress_{s}.fa"
        with open(path, "wb") as fh:
            fh.write(b"".join(b">r%d\n%s\n" % (i, reads[i].tobytes())
                              for i in range(n_reads)))
        files.append(str(path))
    return files


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
    labels = comp.connected_labels(
        comp.adjacency(gkeys, K),
        torch.ones(gkeys.numel(), dtype=torch.bool, device=dev))
    n_level1 = int(torch.unique(labels).numel())
    n_native = native_components(lib, gkeys.cpu().numpy(),
                                 gcounts.cpu().numpy())
    if n_level1 != n_native:
        raise RuntimeError(f"level-1 components {n_level1} != native "
                           f"BFS {n_native}")
    log(f"check level-1 components == native bfs_components_baseline: "
        f"{n_level1} over {gkeys.numel()} keys")
    return launches, files, res, (codes, lengths), (nkeys, ncounts)


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

    kern = phase_kernel(dev)
    with tempfile.TemporaryDirectory() as td:
        launches, files, res, sample0, native = phase_pipeline(dev, Path(td))
        phase_cli(dev, files, res, native, Path(td))
        del res
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
        "launches": launches,
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
