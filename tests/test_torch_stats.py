"""The port's statistical tests (stats/tests.py) against the JAX package's.

Seeded integer tables go through each function of both packages; every
result must be equal, NaN for NaN (0/0 rows of the chi-squared
statistics).  Both are host NumPy with float32 chi-squared arithmetic.
"""

import numpy as np
import pytest
import torch

from metafast_tpu.stats import tests as jax_st
from metafast_tpu_torch.stats import tests as st

N = 2000


def _groups(n_groups: int, sizes=(4, 5, 3)):
    """Per-group (absent, present) sample counts of N k-mers, with empty
    groups' rows (0, 0) and all-present rows among them."""
    rng = np.random.default_rng(30 + n_groups)
    args = []
    for size in sizes[:n_groups]:
        present = rng.integers(0, size + 1, N)
        absent = size - present
        absent[:7] = present[:7] = 0
        args += [absent, present]
    return args


def _ranked_rows():
    """Rows with many ties: small integers, a constant row and a row of
    halves."""
    rng = np.random.default_rng(41)
    a = rng.integers(0, 4, (300, 5)).astype(np.float64)
    b = rng.integers(0, 4, (300, 6)).astype(np.float64)
    a[0], b[0] = 2.0, 2.0
    a[1] = np.arange(5) / 2
    return a, b


CASES = {
    **{f"chi2_invcdf_df1[p={p}]": ("chi2_invcdf_df1", (1.0 - p,))
       for p in (0.01, 0.05, 0.2)},
    **{f"chi2_invcdf_df2[p={p}]": ("chi2_invcdf_df2", (1.0 - p,))
       for p in (0.01, 0.05, 0.2)},
    "chisq_statistic2": ("chisq_statistic2", _groups(2)),
    "chisq_reference": ("chisq_reference",
                        (*_groups(2), jax_st.chi2_invcdf_df1(0.95))),
    "chisq_statistic3": ("chisq_statistic3", _groups(3)),
    "chisq3_reference": ("chisq3_reference",
                         (*_groups(3), jax_st.chi2_invcdf_df2(0.95))),
    "_rankdata_rows": ("_rankdata_rows",
                       (np.concatenate(_ranked_rows(), axis=1),)),
    "mannwhitney_p_rows": ("mannwhitney_p_rows", _ranked_rows()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_function_matches_jax(case):
    name, args = CASES[case]
    want = getattr(jax_st, name)(*args)
    got = getattr(st, name)(*args)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    if name.startswith("chisq_ref") or name.startswith("chisq3_ref"):
        assert 0 < got.sum() < len(got)       # some pass, some fail
    if name == "_rankdata_rows":
        assert (got[0] == 6.0).all()          # one tie run over the row


def _lazy_pair(tmp_path, threshold: int):
    """The same five seeded sample files as two LazyTables: host NumPy,
    and tensors on the CPU device (the device twins' input)."""
    from metafast_tpu_torch.io import binfmt
    from metafast_tpu_torch.stats import presence as pres

    rng = np.random.default_rng(52)
    files = []
    for s in range(5):
        keys = rng.choice(4000, 900 + 50 * s, replace=False) - 2000
        counts = rng.integers(1, 6, len(keys)).astype(np.int16)
        files.append(str(tmp_path / f"s{s}.kmers.bin"))
        binfmt.write_kmers_bin(files[-1], keys.astype(np.int64), counts)
    return (pres.LazyTables(files, threshold),
            pres.LazyTables(files, threshold, torch.device("cpu")))


def _device_case(name, tmp_path, monkeypatch):
    """(NumPy result, device twin's result) of one builder."""
    from metafast_tpu_torch.stats import presence as pres

    if name.startswith("mannwhitney"):
        if name.endswith("chunked"):            # 7 rows a chunk
            monkeypatch.setattr(st, "_MW_CELLS", 7 * 11 * 5)
        a, b = _ranked_rows()
        u2 = st.mannwhitney_umin2_rows_device(torch.from_numpy(a),
                                              torch.from_numpy(b))
        return (st.mannwhitney_p_rows(a, b),
                st.mannwhitney_p_umin(u2.numpy() / 2.0, 5, 6))
    host, dev = _lazy_pair(tmp_path, 2 if name.endswith("b2") else 0)
    keys = pres.union_keys(host)
    if name.startswith("union_keys"):
        return keys, pres.union_keys_device(dev).numpy()
    if name == "group_presence_counts":
        return (np.stack(pres.group_presence_counts(host, keys, [2, 3])),
                torch.stack(pres.group_presence_counts_device(
                    dev, torch.from_numpy(keys), [2, 3])).numpy())
    if name == "sample_totals":
        return pres.sample_totals(host), pres.sample_totals(dev)
    # count_matrix over every other key and keys absent everywhere
    sub = np.concatenate([keys[::2], [-5000, 5000]])
    return (pres.count_matrix(host, sub),
            pres.count_matrix_device(dev, torch.from_numpy(sub)).numpy())


@pytest.mark.parametrize("name", ["union_keys", "union_keys_b2",
                                  "group_presence_counts", "sample_totals",
                                  "count_matrix", "mannwhitney",
                                  "mannwhitney_chunked"])
def test_device_twin_matches_numpy(name, tmp_path, monkeypatch):
    """stats-kmers' device builders give the NumPy builders' results,
    dtype and all; Mann-Whitney's p from twice U_min equals the ranked
    p-values, ties and halves included."""
    want, got = _device_case(name, tmp_path, monkeypatch)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(want) > 0
