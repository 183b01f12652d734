"""The port's multi-device path (metafast_tpu_torch/parallel/) on the CPU.

Worlds of 2 and 4 gloo ranks run as subprocesses of this file
(``python tests/test_torch_parallel.py <rank> <world> <store> <dir>``):
each rank runs every check's port side and saves its results as .npz,
and the tests hold them, exactly, against the JAX package's sharded
functions on the 8-device CPU mesh of tests/conftest.py (``make_mesh(n)``
for the same n) and against the port's single-device functions.  The
``--shards`` launcher is tested in tests/test_torch_shards.py.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
K_SLAB = 21
SLAB_CODES = 3000       # the counting route's slab, cut to force many


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded): the same in the ranks and in the test process
# ---------------------------------------------------------------------------

def _batch(seed, B, L, k):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    return codes, lengths


def count_batches():
    """sharded_count inputs: (name, codes [B, L], lengths, k)."""
    skew = np.zeros((64, 40), np.uint8)          # every k-mer one key
    return [("b0", *_batch(0, 64, 40, 21), 21),
            ("b1", *_batch(1, 128, 90, 31), 31),
            ("skew", skew, np.full(64, 40, np.int32), 21)]


def counter_slabs(case):
    """ShardedKmerCounter inputs: (k, chunk, spill, [(codes, lengths)])
    of each case; slab i goes to rank i % n."""
    rng = np.random.default_rng(17)
    if case == "saturate":
        # one 4-phase pattern: far more than 32767 windows of each key
        L, n_reads = 70, 840
        codes = np.tile(np.tile(np.arange(4, dtype=np.uint8), 18)[:L],
                        n_reads)
        slab = (codes, np.full(n_reads, L, np.int32))
        return 21, 1 << 14, 1 << 27, [slab] * 5

    def slab(k, n_reads):
        lengths = rng.integers(max(1, k - 3), 170, n_reads).astype(np.int32)
        return rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8), lengths

    k, spill = {"k11": (11, 1 << 27), "k31": (31, 1 << 27),
                "spill": (21, 16)}[case]
    return k, 1 << 12, spill, [slab(k, 60 + 40 * i) for i in range(5)]


COUNTER_CASES = ("k11", "k31", "spill", "saturate")


def forests():
    """sharded_doubling inputs: successor forests with chains and cycles
    whose sizes leave the last row block short at 2 and 4 ranks."""
    out = []
    rng = np.random.default_rng(5)
    for n in (1001, 2003, 3001):
        perm = rng.permutation(n)
        succ = np.full(n, -1, dtype=np.int64)
        i = 0
        while i < n:
            L = int(rng.integers(1, 300))
            seg = perm[i:i + L]
            succ[seg[:-1]] = seg[1:]
            if rng.random() < 0.25 and len(seg) > 2:
                succ[seg[-1]] = seg[0]
            i += L
        out.append((f"n{n}", succ))
    return out


def _symmetric_nbr(M, edges):
    """[8, M] int32 neighbour table of an undirected edge list."""
    nbr = np.full((8, M), -1, np.int32)
    fill = np.zeros(M, np.int64)
    for a, b in edges:
        for u, v in ((a, b), (b, a)):
            assert fill[u] < 8
            nbr[fill[u], u] = v
            fill[u] += 1
    return nbr


def graphs():
    """sharded_connected_labels inputs: (name, nbr [8, M], active [M])."""
    rng = np.random.default_rng(23)
    out = []
    # a path through a random vertex order: the longest diameter
    M = 700
    order = rng.permutation(M)
    out.append(("path", _symmetric_nbr(M, zip(order[:-1], order[1:])),
                np.ones(M, bool)))
    # a tree of fan-out 7 under one hub, plus a second small tree: the
    # whole component contracts onto the hub's rank
    M = 2000
    edges = [(c, (c - 1) // 7) for c in range(1, 1800)]
    edges += [(c, 1800 + (c - 1801) // 7) for c in range(1801, M)]
    perm = rng.permutation(M)
    out.append(("star", _symmetric_nbr(M, [(perm[a], perm[b])
                                           for a, b in edges]),
                np.ones(M, bool)))
    # random sparse components with a tenth of the rows inactive
    M = 3000
    edges = set()
    while len(edges) < 2200:
        a, b = (int(x) for x in rng.integers(0, M, 2))
        if a != b and (b, a) not in edges:
            edges.add((a, b))
    deg = np.zeros(M, np.int64)
    kept = []
    for a, b in sorted(edges):
        if deg[a] < 8 and deg[b] < 8:
            kept.append((a, b))
            deg[a] += 1
            deg[b] += 1
    active = np.ones(M, bool)
    active[rng.integers(0, M, M // 10)] = False
    out.append(("inactive", _symmetric_nbr(M, kept), active))
    return out


def dbg_table(k=15, seed=5):
    """(keys, counts) of several random sequences (a de Bruijn table)."""
    from metafast_tpu_torch.utils.kmers import sequence_kmers

    rng = np.random.default_rng(seed)
    seqs = ["".join("AGCT"[i] for i in rng.integers(0, 4, n))
            for n in (400, 900, 2200, 150)]
    keys = np.unique(np.concatenate([sequence_kmers(s, k) for s in seqs]))
    return keys, rng.integers(1, 5, len(keys)).astype(np.int32)


def write_read_files(d: Path):
    """FASTQ / FASTA read files of the counting route's checks."""
    import gzip

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 20_000)

    def reads(n, nfrac=0.0):
        out = []
        for _ in range(n):
            L = int(rng.integers(30, 151))
            s = int(rng.integers(0, len(genome) - L))
            r = np.frombuffer(b"ACGT", np.uint8)[genome[s:s + L]].copy()
            if rng.random() < nfrac:
                r[rng.integers(0, L)] = ord("N")
            out.append(r.tobytes())
        return out

    def fastq(rs):
        return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
                        for i, r in enumerate(rs))

    files = {}
    files["fq"] = d / "a.fastq"
    files["fq"].write_bytes(fastq(reads(900)))
    files["fq_n"] = d / "n.fastq"
    files["fq_n"].write_bytes(fastq(reads(700, nfrac=0.3)))
    files["gz"] = d / "c.fastq.gz"
    with gzip.open(files["gz"], "wb") as fh:
        fh.write(fastq(reads(600)))
    files["fa"] = d / "b.fa"
    files["fa"].write_bytes(b"".join(b">r%d\n%s\n" % (i, r)
                                     for i, r in enumerate(reads(800))))
    from metafast_tpu_torch.api import write_binq

    code = np.zeros(256, np.uint8)
    code[np.frombuffer(b"AGCT", np.uint8)] = np.arange(4)
    rs = [np.frombuffer(r, np.uint8) for r in reads(500)]
    files["binq"] = write_binq(d / "e.binq", code[np.concatenate(rs)],
                               np.array([len(r) for r in rs]))
    return {name: str(p) for name, p in files.items()}


# runs of count_reads_files_sharded: (name, file keys, k, min_len)
COUNT_RUNS = [("plain", ["fq"], 21, 0), ("gz_fa", ["gz", "fa"], 31, 0),
              ("min_len", ["fq", "fq_n"], 15, 40), ("ns", ["fq_n"], 11, 0),
              ("binq", ["binq", "fq"], 21, 0)]


# ---------------------------------------------------------------------------
# One rank of a world
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, store: str, out: Path) -> None:
    torch.set_num_threads(1)
    from metafast_tpu_torch import api
    from metafast_tpu_torch.graph import components as comp_mod
    from metafast_tpu_torch.graph import contigs as contigs_mod
    from metafast_tpu_torch.io import native_reads
    from metafast_tpu_torch.ops import stream_extract as SE
    from metafast_tpu_torch.parallel import distributed as D
    from metafast_tpu_torch.parallel.components import (
        sharded_connected_labels)
    from metafast_tpu_torch.parallel.contigs import sharded_doubling
    from metafast_tpu_torch.parallel.count import (ShardedKmerCounter,
                                                   gather_counts,
                                                   sharded_count)

    mesh = D.initialize(world, rank, store, "cpu")
    res = {}
    layouts = []
    extract = SE.stream_extract

    def recording(*a, **kw):
        layouts.append(kw.get("layout", "stream3"))
        return extract(*a, **kw)

    SE.stream_extract = recording

    for name, codes, lengths, k in count_batches():
        keys, counts, n_unique, dropped = sharded_count(
            codes, lengths, k=k, mesh=mesh, cap_per_shard=2)
        res[f"count/{name}/shard"] = keys.numpy()
        res[f"count/{name}/shard_counts"] = counts.numpy()
        res[f"count/{name}/meta"] = np.array([n_unique, dropped])
        gk, gc = gather_counts(keys, counts, mesh)
        res[f"count/{name}/keys"], res[f"count/{name}/counts"] = gk, gc

    for case in COUNTER_CASES:
        k, chunk, spill, slabs = counter_slabs(case)
        counter = ShardedKmerCounter(k, mesh, chunk=chunk, spill=spill)
        mine = slabs[rank::world]
        for codes, lengths in mine:
            counter.add_stream3(*SE.to_device(
                SE.build_stream3(codes, lengths, k), mesh.device), lengths)
        for _ in range(-(-len(slabs) // world) - len(mine)):
            counter.add_empty()
        keys, counts = counter.finish()
        res[f"counter/{case}/keys"], res[f"counter/{case}/counts"] = (
            keys, counts)
        res[f"counter/{case}/meta"] = np.array(
            [counter.total_kmers_seen, counter.exchanges,
             counter.spill_events, len(mine)])

    files = json.loads((out / "reads.json").read_text())
    api.SLAB_CODES = SLAB_CODES
    for name, keys_of, k, min_len in COUNT_RUNS:
        keys, counts, stats = api.count_reads_files_sharded(
            [files[f] for f in keys_of], k, mesh, min_len=min_len)
        res[f"route/{name}/keys"] = keys.numpy()
        res[f"route/{name}/counts"] = counts.numpy()
        res[f"route/{name}/stats"] = np.array(
            [stats[s] for s in ("reads", "skipped", "kmers_seen", "unique")])
    # one rank's boundary snap fails: every rank takes the read-slice
    # share (each parses the whole file) and the table stays the same
    snap = native_reads.record_boundary
    if rank == world - 1:
        native_reads.record_boundary = lambda path, pos: None
    before = native_reads.PARSED_BYTES
    keys, counts, stats = api.count_reads_files_sharded([files["fq"]], 21,
                                                        mesh)
    native_reads.record_boundary = snap
    res["route/snap_fail/keys"] = keys.numpy()
    res["route/snap_fail/counts"] = counts.numpy()
    res["route/snap_fail/stats"] = np.array(
        [stats[s] for s in ("reads", "skipped", "kmers_seen", "unique")])
    res["route/snap_fail/parsed"] = np.array(
        [native_reads.PARSED_BYTES - before, os.path.getsize(files["fq"])])
    res["layouts"] = np.array(sorted(set(layouts)))
    res["layout_calls"] = np.array([len(layouts)])

    for name, succ in forests():
        for field, t in zip(("term", "dist", "reached"),
                            sharded_doubling(torch.from_numpy(succ), mesh)):
            res[f"doubling/{name}/{field}"] = t.numpy()

    for name, nbr, active in graphs():
        res[f"labels/{name}"] = sharded_connected_labels(
            torch.from_numpy(nbr), torch.from_numpy(active), mesh).numpy()

    keys, counts = dbg_table()
    api.set_default_mesh(mesh)
    comps = comp_mod.split_components(torch.from_numpy(keys),
                                      torch.from_numpy(counts), 15, 30, 800)
    contigs = contigs_mod.build_contigs(torch.from_numpy(keys),
                                        torch.from_numpy(counts), 15, 0)
    api.set_default_mesh(None)
    res["split/kmers"] = np.concatenate([c.kmers.numpy() for c in comps])
    res["split/meta"] = np.array([[c.size, c.weight, c.used_freq_threshold]
                                  for c in comps])
    res["contigs"] = np.array(json.dumps(contigs))
    np.savez(out / f"rank_{rank}.npz", **res)
    D.shutdown()


# ---------------------------------------------------------------------------
# The test process
# ---------------------------------------------------------------------------

def run_worlds(out: Path, timeout: float = 240) -> dict[int, list[dict]]:
    """Start the ranks of every world of WORLDS together, wait, and load
    their results: {n: [rank 0's, rank 1's, ...]}."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    (out / "reads").mkdir()
    reads = json.dumps(write_read_files(out / "reads"))
    procs = []
    for n in WORLDS:
        wd = out / f"world{n}"
        wd.mkdir()
        (wd / "reads.json").write_text(reads)
        procs += [(n, r, subprocess.Popen(
            [sys.executable, __file__, str(r), str(n),
             f"file://{wd / 'store'}", str(wd)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        logs = [p.communicate(timeout=max(1, deadline - time.monotonic()))[0]
                for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (n, r, p), log in zip(procs, logs):
        assert p.returncode == 0, (f"world {n} rank {r}:\n"
                                   f"{log.decode()[-4000:]}")
    return {n: [dict(np.load(out / f"world{n}" / f"rank_{r}.npz"))
                for r in range(n)] for n in WORLDS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("worlds"))


@pytest.fixture(params=WORLDS, ids=lambda n: f"world{n}")
def world(request, worlds):
    """(n, every rank's results) of the world of n gloo ranks."""
    return request.param, worlds[request.param]


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key]), key
    return ranks[0][key]


def _jax_table(hi, lo, cnt):
    """A JAX device's (hi, lo, counts) shard as sorted (keys, counts)."""
    hi, lo, cnt = (np.asarray(a).reshape(-1) for a in (hi, lo, cnt))
    keys = ((hi.astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint64)).astype(np.int64)
    keys, cnt = keys[cnt > 0], cnt[cnt > 0]
    order = np.argsort(keys)
    return keys[order], cnt[order].astype(np.int32)


@pytest.mark.parametrize("case", [c[0] for c in count_batches()])
def test_sharded_count_matches_jax_per_shard(world, case):
    from metafast_tpu.parallel.count import gather_counts as jax_gather
    from metafast_tpu.parallel.count import make_mesh, sharded_count
    from metafast_tpu_torch.ops.count import KmerCounter

    n, ranks = world
    _, codes, lengths, k = next(c for c in count_batches() if c[0] == case)
    hi, lo, cnt, _, drop = sharded_count(codes, lengths, k=k,
                                         mesh=make_mesh(n))
    assert int(np.asarray(drop).sum()) == 0
    for s, r in enumerate(ranks):
        want = _jax_table(hi[s], lo[s], cnt[s])
        assert np.array_equal(r[f"count/{case}/shard"], want[0])
        assert np.array_equal(r[f"count/{case}/shard_counts"], want[1])
        # cap_per_shard=2 was asked for: the exchange is exact anyway
        assert r[f"count/{case}/meta"].tolist() == [len(want[0]), 0]
    keys = _same_on_every_rank(ranks, f"count/{case}/keys")
    counts = _same_on_every_rank(ranks, f"count/{case}/counts")
    jk, jc = jax_gather(hi, lo, cnt)
    assert np.array_equal(keys, jk) and np.array_equal(counts, jc)
    single = KmerCounter(k, "cpu")
    single.add_batch(codes, lengths)
    sk, sc = single.finish()
    assert np.array_equal(keys, sk) and np.array_equal(counts, sc)


@pytest.mark.parametrize("case", COUNTER_CASES)
def test_sharded_counter_matches_jax_and_single(world, case):
    from metafast_tpu.ops.stream_extract import build_stream3 as jax_build
    from metafast_tpu.parallel.count import ShardedKmerCounter, make_mesh
    from metafast_tpu_torch.ops import stream_extract as SE
    from metafast_tpu_torch.ops.count import KmerCounter

    n, ranks = world
    k, chunk, spill, slabs = counter_slabs(case)
    keys = _same_on_every_rank(ranks, f"counter/{case}/keys")
    counts = _same_on_every_rank(ranks, f"counter/{case}/counts")
    meta = np.array([r[f"counter/{case}/meta"] for r in ranks])
    # ranks fed different numbers of slabs, several exchanges
    assert len(set(meta[:, 3])) > 1 and (meta[:, 1] > 1).all()
    if case == "spill":
        assert (meta[:, 2] > 0).all()
    if case == "saturate":
        assert counts.max() == 32767
    # the JAX counter consolidates once (fewer shapes to compile); its
    # result does not depend on when it consolidates
    jc = ShardedKmerCounter(k, make_mesh(n), chunk=1 << 22, spill=spill)
    single = KmerCounter(k, "cpu")
    # one slab shape for JAX: one compile
    cols = max(SE.stream3_cols(lengths, k) for _, lengths in slabs)
    for codes, lengths in slabs:
        jc.add_stream3(*jax_build(codes, lengths, k, lane_multiple=8 * n,
                                  min_cols=cols)[:4], lengths)
        single.add_stream3_device(*SE.to_device(
            SE.build_stream3(codes, lengths, k), torch.device("cpu")),
            lengths)
    jk, jcnt = jc.finish()
    sk, scnt = single.finish()
    assert np.array_equal(keys, jk) and np.array_equal(counts, jcnt)
    assert np.array_equal(keys, sk) and np.array_equal(counts, scnt)
    assert (meta[:, 0] == jc.total_kmers_seen).all()
    assert (meta[:, 0] == single.total_kmers_seen).all()


STATS = ("reads", "skipped", "kmers_seen", "unique")


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    return write_read_files(d)


@pytest.mark.parametrize("run", [r[0] for r in COUNT_RUNS])
def test_count_route_matches_jax_and_unsharded(world, read_files, run):
    from metafast_tpu import api as jax_api
    from metafast_tpu.parallel.count import make_mesh
    from metafast_tpu_torch import api

    n, ranks = world
    _, names, k, min_len = next(r for r in COUNT_RUNS if r[0] == run)
    files = [read_files[f] for f in names]
    keys = _same_on_every_rank(ranks, f"route/{run}/keys")
    counts = _same_on_every_rank(ranks, f"route/{run}/counts")
    stats = _same_on_every_rank(ranks, f"route/{run}/stats").tolist()
    jk, jcnt, jstats = jax_api.count_reads_files_sharded(
        files, k, make_mesh(n), min_len=min_len)
    assert np.array_equal(keys, jk) and np.array_equal(counts, jcnt)
    assert stats == [jstats[s] for s in STATS]
    pk, pcnt, pstats = api.count_reads_files(files, k, "cpu",
                                             min_len=min_len)
    assert np.array_equal(keys, pk.numpy())
    assert np.array_equal(counts, pcnt.numpy())
    assert stats == [pstats[s] for s in STATS]
    if run == "ns":
        assert stats[1] > 0         # reads with N were skipped


def test_failed_boundary_snap_takes_read_slice_share(world):
    n, ranks = world
    for r in ranks:
        parsed, size = r["route/snap_fail/parsed"]
        assert parsed == size       # every rank parsed the whole file
    for field in ("keys", "counts", "stats"):
        got = _same_on_every_rank(ranks, f"route/snap_fail/{field}")
        assert np.array_equal(got, ranks[0][f"route/plain/{field}"])


def test_every_rank_takes_stream3(world):
    _, ranks = world
    for r in ranks:
        assert r["layouts"].tolist() == ["stream3"]
        assert r["layout_calls"][0] > 0


@pytest.mark.parametrize("forest", [f[0] for f in forests()])
def test_sharded_doubling_matches_jax_and_single(world, forest):
    import jax.numpy as jnp

    from metafast_tpu.parallel.contigs import sharded_doubling
    from metafast_tpu.parallel.count import make_mesh
    from metafast_tpu_torch.graph.contigs import _doubling

    n, ranks = world
    succ = dict(forests())[forest]
    got = [_same_on_every_rank(ranks, f"doubling/{forest}/{f}")
           for f in ("term", "dist", "reached")]
    want = sharded_doubling(jnp.asarray(succ.astype(np.int32)),
                            make_mesh(n))
    single = _doubling(torch.from_numpy(succ))
    for g, w, s in zip(got, want, single):
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, s.numpy())
    assert not got[2].all()         # cycles end unreached


@pytest.mark.parametrize("graph", [g[0] for g in graphs()])
def test_sharded_labels_match_jax_and_hooking(world, graph):
    from metafast_tpu.parallel.components import (
        sharded_connected_labels)
    from metafast_tpu.parallel.count import make_mesh
    from metafast_tpu_torch.graph.components import connected_labels

    n, ranks = world
    _, nbr, active = next(g for g in graphs() if g[0] == graph)
    got = _same_on_every_rank(ranks, f"labels/{graph}")
    want = sharded_connected_labels(nbr, active, make_mesh(n))
    hooking = connected_labels(torch.from_numpy(nbr).long(),
                               torch.from_numpy(active))
    assert np.array_equal(got, want)
    assert np.array_equal(got, hooking.numpy())


def test_split_components_and_contigs_with_a_mesh(world):
    from metafast_tpu_torch.graph.components import split_components
    from metafast_tpu_torch.graph.contigs import build_contigs

    n, ranks = world
    keys, counts = dbg_table()
    comps = split_components(torch.from_numpy(keys),
                             torch.from_numpy(counts), 15, 30, 800)
    assert comps
    kmers = _same_on_every_rank(ranks, "split/kmers")
    meta = _same_on_every_rank(ranks, "split/meta")
    assert np.array_equal(kmers, np.concatenate([c.kmers.numpy()
                                                 for c in comps]))
    assert meta.tolist() == [[c.size, c.weight, c.used_freq_threshold]
                             for c in comps]
    contigs = json.loads(json.dumps(build_contigs(
        torch.from_numpy(keys), torch.from_numpy(counts), 15, 0)))
    assert contigs
    for r in ranks:
        assert json.loads(str(r["contigs"])) == contigs


@pytest.mark.parametrize("case", ["hits", "misses", "empty_sample"])
def test_presence_counts_matches_jax(case):
    from metafast_tpu import api as jax_api
    from metafast_tpu_torch import api

    rng = np.random.default_rng(3)
    sample = np.unique(rng.integers(0, 1 << 40, 500))
    counts = rng.integers(1, 32767, len(sample)).astype(np.int32)
    if case == "empty_sample":
        sample, counts = sample[:0], counts[:0]
    comp = np.concatenate([rng.choice(sample, 100) if len(sample) else
                           np.zeros(0, np.int64),
                           rng.integers(0, 1 << 40, 60)])
    if case == "misses":
        comp = comp[~np.isin(comp, sample)]
    want = jax_api.presence_counts(comp, sample, counts)
    got = api.presence_counts(torch.from_numpy(comp),
                              torch.from_numpy(sample),
                              torch.from_numpy(counts))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("pid,n", [(0, 1), (0, 3), (2, 3), (1, 4)])
def test_per_host_files_matches_jax(pid, n):
    from metafast_tpu.parallel import distributed as jax_dist
    from metafast_tpu_torch.parallel import distributed as D

    files = [f"s{i}.fa" for i in range(10)]
    assert D.per_host_files(files, pid, n) == jax_dist.per_host_files(
        files, pid, n)


@pytest.mark.parametrize("missing", ["cuda", "nccl"])
def test_a_cuda_group_without_cuda_or_nccl_raises(missing, tmp_path,
                                                  monkeypatch):
    import torch.distributed as dist

    from metafast_tpu_torch.parallel import distributed as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: missing != "cuda")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match=missing.upper()):
        D.initialize(1, 0, f"file://{tmp_path / 'store'}", "cuda")
    assert not dist.is_initialized()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
               Path(sys.argv[4]))
