"""Tests of the PyTorch port that need a CUDA GPU (marked ``cuda``).

They skip where there is no GPU.  This file imports no JAX, so it runs
on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX.)
"""

from collections import Counter

import numpy as np
import pytest
import torch

from metafast_tpu_torch import cli
from metafast_tpu_torch.graph import pivot
from metafast_tpu_torch.core.bitpack import SENTINEL
from metafast_tpu_torch.io import textfmt
from metafast_tpu_torch.io.native_reads import pack_2bit
from metafast_tpu_torch.ops import psort
from metafast_tpu_torch.ops import stream_extract as TSE
from metafast_tpu_torch.ops.count import (MERGE_CHUNK_BYTES,
                                          MERGE_TABLE_BYTES, KmerCounter,
                                          card_spill)
from metafast_tpu_torch.pipeline import matrix_pipeline
from metafast_tpu_torch.utils.kmers import sequence_kmers
from torch_helpers import check_kmer_counter_copies, cuda_device  # noqa: F401
from torch_helpers import workdir_tree
from torch_helpers import PATH_CASES, path_table
from torch_helpers import write_group_samples, write_samples

pytestmark = pytest.mark.cuda
KS = [1, 11, 16, 17, 31]


def _reads(k, n_reads=4000, seed=0):
    rng = np.random.default_rng(seed + k)
    lengths = rng.integers(max(1, k - 3), 170, n_reads).astype(np.int32)
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    return codes, lengths


def _inputs(codes, lengths, k, layout, device):
    if layout == "stream3":
        return TSE.to_device(TSE.build_stream3(codes, lengths, k), device)
    w, vm = TSE.to_device(TSE.build_stream(codes, lengths, k), device)
    return w, None, None, vm


@pytest.mark.parametrize("layout", ["stream3", "columns"])
@pytest.mark.parametrize("k", KS)
def test_kernel_matches_plain(k, layout, cuda_device):
    codes, lengths = _reads(k)
    w0, w1, w2, vm = _inputs(codes, lengths, k, layout, cuda_device)
    before = TSE.stream_extract.launches
    got = TSE.stream_extract(w0, w1, w2, vm, k, layout=layout)
    torch.cuda.synchronize()
    assert TSE.stream_extract.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    want = TSE.stream_extract_torch(w0, w1, w2, vm, k, layout=layout)
    assert torch.equal(got, want)
    cpu = TSE.stream_extract_torch(*(None if a is None else a.cpu()
                                     for a in (w0, w1, w2, vm)), k,
                                   layout=layout)
    assert torch.equal(got.cpu(), cpu)


def test_kernel_rejects_strided_input(cuda_device):
    w = torch.zeros((4, 2 * TSE.ROWS), dtype=torch.int32,
                    device=cuda_device)[:, ::2]
    with pytest.raises(ValueError):
        TSE.stream_extract(w, w, w, w, 31)


@pytest.mark.parametrize("k", [16, 31])
def test_counter_gpu_matches_cpu(k, cuda_device):
    codes, lengths = _reads(k, seed=7)
    tables = []
    for dev in (cuda_device, torch.device("cpu")):
        c = KmerCounter(k, dev, chunk=50_000)
        for r0 in range(0, len(lengths), 1000):
            ls = lengths[r0:r0 + 1000]
            off = int(lengths[:r0].sum())
            cs = codes[off:off + int(ls.sum())]
            c.add_stream3_device(*_inputs(cs, ls, k, "stream3", dev), ls)
        c.add_keys(np.array([5, 9], np.int64), np.array([32000, 900]))
        tables.append(c.finish())
    assert np.array_equal(tables[0][0], tables[1][0])
    assert np.array_equal(tables[0][1], tables[1][1])


def _psort_inputs(logn, log_block, device):
    """Duplicates, sentinels, an int32 index and a float payload."""
    rng = np.random.default_rng(logn + log_block)
    n = 1 << logn
    keys = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 62, n),
                    rng.integers(0, 1 << 10, n))
    keys[rng.random(n) < 0.1] = SENTINEL
    return (torch.from_numpy(keys.astype(np.int64)).to(device),
            torch.arange(n, dtype=torch.int32, device=device),
            torch.from_numpy(rng.random(n)).to(device))


# n below, at and twice the 2**14 tile and 2**22; log_block 10 and 13
# inside the tile's distances (13 splits its top register group), 17
# above the tile (at 2**22 it splits a global group of every span from
# 2**18 up)
PSORT_CASES = ([(logn, lb) for logn in (17, 18, 20) for lb in (17, 12)]
               + [(logn, lb) for logn in (13, 14, 15, 22)
                  for lb in (10, 13, 17) if lb <= logn])


@pytest.mark.parametrize("logn,log_block", PSORT_CASES)
def test_psort_kernel_matches_plain(logn, log_block, cuda_device):
    """Keys, payload order and the tie order equal the plain version's,
    on the card and on the CPU."""
    arrs = _psort_inputs(logn, log_block, cuda_device)
    before = psort.sort_arrays_blocked.launches
    got = psort.sort_arrays_blocked(arrs, log_block=log_block)
    torch.cuda.synchronize()
    assert psort.sort_arrays_blocked.launches == before + 1
    want = psort.sort_arrays_blocked_torch(arrs, log_block=log_block)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)
    assert torch.equal(got[0], torch.sort(arrs[0]).values)
    if logn == 17:
        cpu = psort.sort_arrays_blocked_torch([a.cpu() for a in arrs],
                                              log_block=log_block)
        for g, c in zip(got, cpu):
            assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("fuse", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("log_tile", [12, 13, 14])
def test_psort_schedules_match_plain(log_tile, fuse, cuda_device):
    """Every tile size and register group width of the kernel sorts as
    the plain version does, at 2**16 keys with log_block 13."""
    keys = _psort_inputs(16, 13, cuda_device)[0]
    got_keys, got_idx = psort._sort_kernel(keys, 13, log_tile, fuse)
    want_keys, want_perm = psort._network_torch(keys, 13)
    assert torch.equal(got_keys, want_keys)
    assert torch.equal(got_idx.long(), want_perm)


def test_psort_small_n(cuda_device):
    """n = 2 .. 2**12, below the tile, at log_block 1 and log_n."""
    for logn in range(1, 13):
        for log_block in sorted({1, logn}):
            arrs = _psort_inputs(logn, log_block, cuda_device)
            got = psort.sort_arrays_blocked(arrs, log_block=log_block)
            want = psort.sort_arrays_blocked_torch(arrs, log_block)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (logn, log_block)


def test_psort_sort_arrays_takes_the_kernel(cuda_device):
    keys = torch.randint(0, 1 << 40, (1 << 17,), device=cuda_device)
    before = psort.sort_arrays_blocked.launches
    got, = psort.sort_arrays((keys,))
    assert psort.sort_arrays_blocked.launches == before + 1
    assert torch.equal(got, torch.sort(keys).values)


def test_psort_rejects_strided_input(cuda_device):
    keys = torch.zeros(1 << 18, dtype=torch.int64, device=cuda_device)[::2]
    with pytest.raises(ValueError):
        psort.sort_arrays_blocked((keys,))


@pytest.mark.parametrize("k", [11, 31])
def test_batch_routes_gpu_match_cpu(k, cuda_device):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (500, 256), dtype=np.uint8)
    lengths = rng.integers(k - 1, 257, 500).astype(np.int32)
    packed = pack_2bit(codes)
    tables = []
    for dev in (cuda_device, torch.device("cpu")):
        counter = KmerCounter(k, dev, chunk=50_000)
        for _ in range(2):
            counter.add_batch(codes, lengths)
            counter.add_packed_batch(packed, lengths, 256)
        tables.append(counter.finish())
    assert np.array_equal(tables[0][0], tables[1][0])
    assert np.array_equal(tables[0][1], tables[1][1])
    assert tables[0][1].min() >= 4      # each window seen in all 4 adds


def test_spill_on_gpu_equals_no_spill(cuda_device):
    codes, lengths = _reads(17, seed=3)
    results = []
    for spill in (None, 2000):
        c = KmerCounter(17, cuda_device, chunk=30_000, spill=spill)
        for r0 in range(0, len(lengths), 500):
            ls = lengths[r0:r0 + 500]
            off = int(lengths[:r0].sum())
            cs = codes[off:off + int(ls.sum())]
            c.add_stream3_device(*_inputs(cs, ls, 17, "stream3",
                                          cuda_device), ls)
        results.append((c.spill_events, c.finish()))
    assert results[0][0] == 0 and results[1][0] >= 2
    assert np.array_equal(results[0][1][0], results[1][1][0])
    assert np.array_equal(results[0][1][1], results[1][1][1])


def test_card_spill_on_the_card(cuda_device):
    """The main path's threshold on this card: at least one chunk, and
    unless it is that floor, a merge at it peaks within half the card."""
    spill = card_spill(cuda_device)
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    peak = MERGE_TABLE_BYTES * spill + MERGE_CHUNK_BYTES * (1 << 27)
    assert spill == 1 << 27 or (spill > 1 << 27 and peak <= total // 2)


def test_cli_gpu_matches_cpu(tmp_path, cuda_device):
    """matrix-builder through the CLI on the card and on the CPU: the same
    files, byte for byte; the card's run launches the extraction kernel."""
    files = write_samples(tmp_path, 3, 30_000, 12_000, 12, seed=11)
    trees = {}
    for dev in ("cuda", "cpu"):
        wd = tmp_path / dev
        before = TSE.stream_extract.launches
        assert cli.main(["-t", "matrix-builder", "-k", "31", "-i", *files,
                         "-b1", "100", "-b2", "3000", "-w", str(wd),
                         "--device", dev,
                         "--finish", "dist-matrix-calculator"]) == 0
        launched = TSE.stream_extract.launches - before
        assert launched > 0 if dev == "cuda" else launched == 0
        trees[dev] = workdir_tree(wd)
    assert sorted(trees["cuda"]) == sorted(trees["cpu"])
    assert "component-cutter/components.bin" in trees["cpu"]
    assert "matrices/dist_matrix_<ts>_original_order.txt" in trees["cpu"]
    for rel, data in trees["cpu"].items():
        assert trees["cuda"][rel] == data, rel


def test_pipeline_gpu_matches_cpu(tmp_path, cuda_device):
    files = write_samples(tmp_path, 3, 30_000, 12_000, 12, seed=11)
    kw = dict(k=31, b=1, l=100, b1=100, b2=3000)
    gpu = matrix_pipeline(files, device=cuda_device, **kw)
    cpu = matrix_pipeline(files, device="cpu", **kw)
    assert len(gpu.components) >= 3
    assert np.array_equal(gpu.matrix, cpu.matrix)
    assert np.array_equal(gpu.vectors, cpu.vectors)
    assert np.array_equal(gpu.breadth, cpu.breadth)
    assert gpu.contigs_per_sample == cpu.contigs_per_sample
    for g, c in zip(gpu.components, cpu.components):
        assert np.array_equal(g.kmers, c.kmers)
        assert (g.weight, g.used_freq_threshold) == (
            c.weight, c.used_freq_threshold)


@pytest.mark.parametrize("tool", ["stats-features", "unique-features"])
def test_group_pipelines_gpu_match_cpu(tool, tmp_path, cuda_device):
    """Pipelines 5 and 2 on the card and on the CPU: the same files; the
    card's run launches the extraction kernel once a sample at least."""
    files, _ = write_group_samples(tmp_path, ["pos"] * 3 + ["neg"] * 3,
                                   16_000, 5_000, 3_000, 12, seed=14)
    extra = {"stats-features": [],
             "unique-features": ["--min-samples", "2", "--max-samples", "3"]}
    trees = {}
    for dev in ("cuda", "cpu"):
        before = TSE.stream_extract.launches
        assert cli.main(["-t", tool, "-k", "31", "-pos", *files[:3],
                         "-neg", *files[3:], *extra[tool],
                         "-w", str(tmp_path / dev), "--device", dev]) == 0
        launched = TSE.stream_extract.launches - before
        assert launched >= 6 if dev == "cuda" else launched == 0
        trees[dev] = workdir_tree(tmp_path / dev)
    assert "component-extractor/components.bin" in trees["cpu"]
    assert trees["cuda"] == trees["cpu"]


@pytest.mark.parametrize("depth", [1, 2])
def test_pivot_on_gpu_matches_cpu(depth, cuda_device):
    """The pivot graph's neighbour index on the card equals the CPU's, and
    so do the components the Python traversal finds over it."""
    rng = np.random.default_rng(depth)
    shared = "".join(rng.choice(list("ACGT"), 2_000))
    keys = np.unique(np.concatenate([
        sequence_kmers("".join(rng.choice(list("ACGT"), 3_000)) + shared
                       + "".join(rng.choice(list("ACGT"), 3_000)), 31)
        for _ in range(3)]))
    counts = rng.integers(2, 9, len(keys))
    pivots = rng.choice(keys, 300, replace=False)
    got = pivot.neighbor_index(torch.from_numpy(keys).to(cuda_device), 31)
    want = pivot.neighbor_index(torch.from_numpy(keys), 31)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    gc = pivot.split_around_pivot(keys, counts, 31, pivots, depth,
                                  device=cuda_device, force_python=True)
    cc = pivot.split_around_pivot(keys, counts, 31, pivots, depth,
                                  device="cpu", force_python=True)
    assert len(gc) == len(cc) > 0
    for g, c in zip(gc, cc):
        assert np.array_equal(g.kmers, c.kmers)
        assert (g.weight, g.n_pivot) == (c.weight, c.n_pivot)


@pytest.mark.parametrize("repeated", [False, True])
def test_depth1_index_on_gpu_matches_cpu(repeated, cuda_device, monkeypatch):
    """The depth-1 route's int32 tables built on the card, over several
    row blocks, equal the CPU's (which tests/test_torch_pivot.py holds
    against the JAX package's native hash), and so do the components the
    native traversal finds over them; ``repeated`` keys (one .kmers.bin,
    sorted but not deduplicated) map to the last index of their run."""
    rng = np.random.default_rng(7)
    shared = "".join(rng.choice(list("ACGT"), 2_000))
    keys = np.unique(np.concatenate([
        sequence_kmers("".join(rng.choice(list("ACGT"), 3_000)) + shared
                       + "".join(rng.choice(list("ACGT"), 3_000)), 31)
        for _ in range(3)]))
    if repeated:
        keys = np.sort(np.repeat(keys, rng.integers(1, 4, len(keys))))
    counts = rng.integers(2, 9, len(keys))
    pivots = rng.choice(np.unique(keys), 300, replace=False)
    monkeypatch.setattr(pivot, "_INDEX_BLOCK", 1 << 12)
    assert len(keys) > 3 * pivot._INDEX_BLOCK
    got = pivot.depth1_index(torch.from_numpy(keys).to(cuda_device), 31)
    want = pivot.depth1_index(torch.from_numpy(keys), 31)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        assert np.array_equal(g, w)
    gc = pivot.split_around_pivot(keys, counts, 31, pivots,
                                  device=cuda_device)
    cc = pivot.split_around_pivot(keys, counts, 31, pivots, device="cpu")
    assert len(gc) == len(cc) > 0
    for g, c in zip(gc, cc):
        assert np.array_equal(g.kmers, c.kmers)
        assert (g.weight, g.n_pivot) == (c.weight, c.n_pivot)


def test_world1_nccl_group_matches_single_device(tmp_path, cuda_device):
    """The multi-device path in a one-rank NCCL group on the card: the
    sharded count, doubling and star contraction equal the single-device
    functions, and the counting route launches K1."""
    from metafast_tpu_torch import api
    from metafast_tpu_torch.graph import components as comp
    from metafast_tpu_torch.graph import contigs, dbg
    from metafast_tpu_torch.parallel import distributed as D
    from metafast_tpu_torch.parallel.components import (
        sharded_connected_labels)
    from metafast_tpu_torch.parallel.contigs import sharded_doubling

    files = write_samples(tmp_path, 2, 30_000, 10_000, 12, seed=3)
    mesh = D.initialize(1, 0, f"file://{tmp_path / 'store'}", "cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        assert mesh.device.type == "cuda" and mesh.size == 1
        before = TSE.stream_extract.launches
        keys, counts, stats = api.count_reads_files_sharded(files, 31, mesh)
        assert TSE.stream_extract.launches > before
        wk, wc, wstats = api.count_reads_files(files, 31, cuda_device)
        assert torch.equal(keys, wk) and torch.equal(counts, wc)
        assert stats == wstats
        keys = keys[counts > 1]
        t = dbg.neighbor_tables(keys, 31)
        succ, _, _ = contigs._succ_from_tables(keys, t["left"], t["right"],
                                               31)
        for g, w in zip(sharded_doubling(succ, mesh),
                        contigs._doubling(succ)):
            assert torch.equal(g, w)
        nbr = comp.adjacency(keys, 31)
        active = torch.ones(keys.numel(), dtype=torch.bool,
                            device=cuda_device)
        assert torch.equal(sharded_connected_labels(nbr, active, mesh),
                           comp.connected_labels(nbr, active))
    finally:
        D.shutdown()


def _graph_keys(tmp_path, device):
    """A de Bruijn table of about 3 x 10^5 keys: two 200 kbp samples'
    k-mers (k = 31) at count > 1, on the CPU."""
    from metafast_tpu_torch import api

    files = write_samples(tmp_path, 2, 200_000, 80_000, 12, seed=8)
    keys, counts, _ = api.count_reads_files(files, 31, device)
    return keys[counts > 1].cpu()


def test_chain_rank_on_gpu_matches_cpu(tmp_path, cuda_device):
    from metafast_tpu_torch.graph import contigs, dbg
    from metafast_tpu_torch.graph.rank import chain_rank

    keys = _graph_keys(tmp_path, cuda_device)
    assert keys.numel() > 200_000
    t = dbg.neighbor_tables(keys, 31)
    succ, _, _ = contigs._succ_from_tables(keys, t["left"], t["right"], 31)
    valid = torch.ones(succ.numel(), dtype=torch.bool)
    cpu = chain_rank(succ, valid)
    gpu = chain_rank(succ.to(cuda_device), valid.to(cuda_device))
    for name, want in cpu.items():
        got = gpu[name]
        if isinstance(want, torch.Tensor):
            assert torch.equal(got.cpu(), want), name
        else:
            assert got == want, name
    term, dist, reached = contigs._doubling(succ.to(cuda_device))
    assert torch.equal(gpu["reached"], reached)
    assert torch.equal(gpu["term"][reached], term[reached])
    assert torch.equal(gpu["dist"][reached], dist[reached])


def test_labels_on_gpu_match_cpu(tmp_path, cuda_device):
    from metafast_tpu_torch.graph import components as comp

    keys = _graph_keys(tmp_path, cuda_device)
    active = torch.ones(keys.numel(), dtype=torch.bool)
    nbr = comp.adjacency(keys, 31)
    star = comp.star_connected_labels(nbr, active)
    walk = comp.walk_connected_labels(keys, 31)
    assert torch.equal(star, walk)
    assert torch.equal(star, comp.hooking_connected_labels(nbr, active))
    gkeys = keys.to(cuda_device)
    assert torch.equal(comp.star_connected_labels(
        nbr.to(cuda_device), active.to(cuda_device)).cpu(), star)
    assert torch.equal(comp.walk_connected_labels(gkeys, 31).cpu(), walk)


@pytest.mark.parametrize("walk_min", [0, None])
def test_split_components_on_gpu_match_cpu(walk_min, tmp_path, cuda_device,
                                           monkeypatch):
    """split_components on the card gives the CPU's components, weights
    and thresholds in the CPU's order: on two 200 kbp samples' recount
    graph (~3 x 10^5 keys, components at thresholds 1-14) and on every
    path table of torch_helpers.PATH_CASES; with ``walk_min`` 0 the
    full-live levels take the walk labeller."""
    from metafast_tpu_torch import api
    from metafast_tpu_torch.graph import components as comp

    if walk_min is not None:
        monkeypatch.setattr(comp, "_WALK_MIN", walk_min)
    files = write_samples(tmp_path, 2, 200_000, 80_000, 12, seed=8)
    keys, counts, _ = api.count_reads_files(files, 31, torch.device("cpu"))
    keep = counts > 1
    tables = [(keys[keep], counts[keep], 100, 3000)] + [
        (*map(torch.from_numpy, path_table(paths)), b1, b2)
        for b1, b2, paths in PATH_CASES.values()]
    for keys, counts, b1, b2 in tables:
        cpu = comp.split_components(keys, counts, 31, b1, b2)
        gpu = comp.split_components(keys.to(cuda_device),
                                    counts.to(cuda_device), 31, b1, b2)
        assert len(gpu) == len(cpu) >= 3
        assert [(c.weight, c.used_freq_threshold) for c in gpu] == [
            (c.weight, c.used_freq_threshold) for c in cpu]
        assert all(c.kmers.device.type == cuda_device.type for c in gpu)
        for g, c in zip(comp.members_to_host(gpu), cpu):
            assert np.array_equal(g, c.kmers.numpy())


@pytest.mark.parametrize("n", [0, 200_000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_stat_txt_from_a_cuda_tensor(n, dtype, tmp_path, cuda_device):
    """stat.txt of a table on the card: the bytes of a plain Counter's
    histogram of the same table."""
    counts = np.minimum(np.random.default_rng(14).zipf(1.3, n), 32767)
    counts[:3] = 32767
    textfmt.write_stat_txt(str(tmp_path / "stat.txt"),
                           torch.from_numpy(counts).to(cuda_device, dtype))
    freq = Counter(counts.tolist())
    want = ("# k-mer frequency\tnumber of such k-mers\n"
            + "".join(f"{f}\t{freq[f]}\n" for f in sorted(freq)) + "\n")
    assert (tmp_path / "stat.txt").read_text() == want


def test_traced_kmer_counter_copies_back_the_histogram(tmp_path, cuda_device):
    check_kmer_counter_copies(tmp_path, cuda_device)
