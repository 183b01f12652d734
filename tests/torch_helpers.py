"""Shared pieces of the tests of the PyTorch port (metafast_tpu_torch)."""

import numpy as np
import pytest
import torch


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
