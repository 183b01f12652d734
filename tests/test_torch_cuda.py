"""Tests of the PyTorch port that need a CUDA GPU (marked ``cuda``).

They skip where there is no GPU.  This file imports no JAX, so it runs
on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from metafast_tpu_torch.ops import stream_extract as TSE
from metafast_tpu_torch.ops.count import KmerCounter
from metafast_tpu_torch.pipeline import matrix_pipeline
from torch_helpers import cuda_device, write_samples  # noqa: F401

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
