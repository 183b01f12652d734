"""The port's statistical tests and presence builders (stats/) against the
JAX package's.

Seeded integer tables go through each host function of both packages;
every result must be equal, NaN for NaN (0/0 rows of the chi-squared
statistics).  Both are host NumPy with float32 chi-squared arithmetic.
The port's device builders and its Mann-Whitney (on the CPU here) must
give what the JAX package's host NumPy builders give over the same
sample files, and what its ranking gives over the same rows, NaN rows
(an empty sample's normalised column) included.
"""

import numpy as np
import pytest
import torch

from metafast_tpu.stats import presence as jax_pres
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


def _nan_rows():
    """Rows of 4 against 4 with NaNs in a, in b and in both, all-NaN rows,
    and the row of an empty first sample: (NaN, 3, 5, 2) against
    (1, 1, 1, 1), which the JAX package ranks to p = 0.0209."""
    rng = np.random.default_rng(43)
    a = rng.integers(0, 4, (200, 4)).astype(np.float64)
    b = rng.integers(0, 4, (200, 4)).astype(np.float64)
    a[rng.random(a.shape) < 0.2] = np.nan
    b[rng.random(b.shape) < 0.2] = np.nan
    a[0], b[0] = [np.nan, 3, 5, 2], 1.0
    a[1], b[1] = np.nan, np.nan
    a[2], b[2] = np.nan, [2, np.nan, 0, 2]
    return a, b


def _sample_files(tmp_path, repeats: bool):
    """Five seeded sample files and, with ``repeats``, first of them a
    small sorted one that repeats keys of theirs with different counts (a
    .kmers.bin that is not deduplicated); returns the paths and the
    repeated keys' (key, first count, last count)."""
    from metafast_tpu_torch.io import binfmt

    rng = np.random.default_rng(52)
    files = []
    for s in range(5):
        keys = rng.choice(4000, 900 + 50 * s, replace=False) - 2000
        counts = rng.integers(1, 6, len(keys)).astype(np.int16)
        files.append(str(tmp_path / f"s{s}.kmers.bin"))
        binfmt.write_kmers_bin(files[-1], keys.astype(np.int64), counts)
    if not repeats:
        return files, []
    shared = np.sort(binfmt.read_kmers_bin(files[0])[0][:4])
    keys = np.repeat(shared, [1, 3, 2, 4])
    counts = np.arange(7, 7 + len(keys), dtype=np.int16)
    files.insert(0, str(tmp_path / "repeats.kmers.bin"))
    binfmt.write_kmers_bin(files[0], keys, counts)
    runs = [(int(x), int(counts[keys == x][0]), int(counts[keys == x][-1]))
            for x in shared[1:]]
    return files, runs


def _device_case(name, tmp_path, monkeypatch):
    """(the JAX package's host result, the port's on the CPU device) of
    one builder or of Mann-Whitney."""
    from metafast_tpu_torch.stats import presence as pres

    if name.startswith("mannwhitney"):
        if name.endswith("chunked"):            # 7 rows a chunk
            monkeypatch.setattr(st, "_MW_CELLS", 7 * 11 * 5)
        a, b = _nan_rows() if "nan" in name else _ranked_rows()
        got = st.mannwhitney_p(torch.from_numpy(a), torch.from_numpy(b))
        return jax_st.mannwhitney_p_rows(a, b), got.numpy()
    files, runs = _sample_files(tmp_path, name == "first_present_value")
    threshold = 2 if name.endswith("b2") else 0
    host = jax_pres.LazyTables(files, threshold)
    dev = pres.LazyTables(files, threshold, torch.device("cpu"))
    keys = jax_pres.union_keys(host)
    if name.startswith("union_keys"):
        return keys, pres.union_keys(dev).numpy()
    if name == "group_presence_counts":
        return (np.stack(jax_pres.group_presence_counts(host, keys,
                                                        [2, 3])),
                torch.stack(pres.group_presence_counts(
                    dev, torch.from_numpy(keys), [2, 3])).numpy())
    if name == "sample_totals":
        return jax_pres.sample_totals(host), pres.sample_totals(dev)
    if name == "first_present_value":
        want = jax_pres.first_present_value(host, keys)
        rows = np.searchsorted(keys, [x for x, _, _ in runs])
        # the last of each repeated run, not the first
        assert list(want[rows]) == [last for _, _, last in runs]
        assert all(first != last for _, first, last in runs)
        return want, pres.first_present_value(
            dev, torch.from_numpy(keys)).numpy()
    # count_matrix over every other key and keys absent everywhere
    sub = np.concatenate([keys[::2], [-5000, 5000]])
    return (jax_pres.count_matrix(host, sub),
            pres.count_matrix(dev, torch.from_numpy(sub)).numpy())


@pytest.mark.parametrize("name", ["union_keys", "union_keys_b2",
                                  "group_presence_counts", "sample_totals",
                                  "count_matrix", "first_present_value",
                                  "mannwhitney", "mannwhitney_chunked",
                                  "mannwhitney_nan",
                                  "mannwhitney_nan_chunked"])
def test_device_builder_matches_jax(name, tmp_path, monkeypatch):
    """The port's builders on the device give the JAX package's NumPy
    builders' results, dtype and all; its Mann-Whitney p from twice U_min
    equals the JAX package's ranked p-values, ties, halves and NaNs
    included."""
    want, got = _device_case(name, tmp_path, monkeypatch)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(want) > 0
    if name.startswith("mannwhitney_nan"):
        assert want[0] == pytest.approx(0.02092, abs=1e-5)
