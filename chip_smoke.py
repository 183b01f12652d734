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
  4. The pipeline on the GPU against the same pipeline on the CPU (plain
     PyTorch versions) at 3 samples of 200 kbp: every field equal.

Prints one JSON line of kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

K = 31
READ_LEN = 150


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


def phase_kernel(dev):
    """Phase 2: kernel == plain version on the card."""
    import torch

    from metafast_tpu_torch.api import SLAB_CODES
    from metafast_tpu_torch.ops import stream_extract as SE

    rng = np.random.default_rng(1)
    result = dict(max_abs_err=0, ms=None, plain_ms=None)
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
            log(f"kernel k={k} layout={layout} codes={n_codes} "
                f"words={w0.numel()} equal=True max_abs_err={err} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"written_GB_per_s={n_keys * 8 / ms / 1e6:.1f}")
            if (n_codes, k, layout) == (SLAB_CODES, K, "stream3"):
                result.update(ms=ms, plain_ms=plain_ms)
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
    """Phase 3: the full pipeline at CAMI scale; returns launches."""
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
    return launches


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
    t0 = time.perf_counter()
    load("stream_extract")
    t1 = time.perf_counter()
    native_library()
    log(f"build: stream_extract.cu nvcc_s={t1 - t0:.2f} "
        f"native_lib_s={time.perf_counter() - t1:.2f}")

    kern = phase_kernel(dev)
    with tempfile.TemporaryDirectory() as td:
        launches = phase_pipeline(dev, Path(td))
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
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
