"""The port's statistical tests (stats/tests.py) against the JAX package's.

Seeded integer tables go through each function of both packages; every
result must be equal, NaN for NaN (0/0 rows of the chi-squared
statistics).  Both are host NumPy with float32 chi-squared arithmetic.
"""

import numpy as np
import pytest

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
