"""The port's ``stat.txt`` writer against the JAX package's, byte for byte:
a table given as a (CPU) tensor or as a NumPy array, of int32 or int64,
empty, of one value, at the counter's saturation, or Zipf-distributed."""

import numpy as np
import pytest
import torch

from metafast_tpu.io import textfmt as jax_textfmt
from metafast_tpu_torch.io import textfmt

SATURATE = 32767


def _table(kind: str) -> np.ndarray:
    rng = np.random.default_rng(14)
    if kind == "empty":
        return np.zeros(0, np.int64)
    if kind == "single":
        return np.full(1, 7, np.int64)
    if kind == "saturated":
        return np.concatenate([np.full(40, SATURATE), [1, 2, 2, SATURATE - 1]])
    return np.minimum(rng.zipf(1.3, 50_000), SATURATE)


@pytest.mark.parametrize("as_tensor", [True, False], ids=["tensor", "numpy"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["empty", "single", "saturated", "zipf"])
def test_stat_txt_matches_jax(kind, dtype, as_tensor, tmp_path):
    counts = _table(kind).astype(dtype)
    jax_textfmt.write_stat_txt(str(tmp_path / "jax.stat.txt"), counts)
    table = torch.from_numpy(counts) if as_tensor else counts
    textfmt.write_stat_txt(str(tmp_path / "port.stat.txt"), table)
    want = (tmp_path / "jax.stat.txt").read_bytes()
    assert (tmp_path / "port.stat.txt").read_bytes() == want
    assert want.count(b"\n") == 2 + len(np.unique(counts))
