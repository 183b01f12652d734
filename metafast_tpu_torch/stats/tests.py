"""Vectorized statistical tests matching the reference's exact formulas.

- chi-squared: the reference's percent-normalized Yates-corrected 2x2
  statistic, computed in float32 like the Java original
  (StatsKmersFinder.chisq, src/tools/StatsKmersFinder.java:297-315)
- Mann-Whitney U: commons-math3 MannWhitneyUTest semantics — average
  ranks for ties, U_min against the normal approximation with
  sigma^2 = n1 n2 (n1+n2+1)/12, p = 2 * Phi(z), no tie or continuity
  correction (used at src/tools/StatsKmersFinder.java:222-247)
- chi2 critical value: inverse CDF of ChiSquared(df=1) at 1 - p

The port's copy of metafast_tpu/stats/tests.py.  The chi-squared
statistic stays host NumPy as there: its float32 rounding is the
reference's semantics, so it is not re-derived in torch.  Mann-Whitney
ranks rows on the device in exact integers (``mannwhitney_umin2_rows``),
NaN where the JAX package's stable argsort puts it; the p-values are
host NumPy, one a distinct U_min.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import trace


def chi2_invcdf_df1(p: float) -> float:
    """Inverse CDF of the chi-squared distribution with 1 dof.

    For df=1: F(x) = erf(sqrt(x/2)), so F^-1(p) = 2 * erfinv(p)^2.
    Matches commons-math ChiSquaredDistributionImpl.inverseCumulativeProbability.
    """
    if not 0.0 <= p < 1.0:
        raise ValueError(f"p must be in [0, 1): {p}")
    return 2.0 * _erfinv(p) ** 2


def _erfinv(y: float) -> float:
    """Inverse error function (scalar), Newton-refined rational estimate."""
    if y <= -1.0 or y >= 1.0:
        raise ValueError("erfinv domain")
    # initial guess (Giles 2010 style rational approximation)
    w = -math.log((1.0 - y) * (1.0 + y))
    if w < 6.25:
        w -= 3.125
        p = -3.6444120640178196996e-21
        for c in (-1.685059138182016589e-19, 1.2858480715256400167e-18,
                  1.115787767802518096e-17, -1.333171662854620906e-16,
                  2.0972767875968561637e-17, 6.6376381343583238325e-15,
                  -4.0545662729752068639e-14, -8.1519341976054721522e-14,
                  2.6335093153082322977e-12, -1.2975133253453532498e-11,
                  -5.4154120542946279317e-11, 1.051212273321532285e-09,
                  -4.1126339803469836976e-09, -2.9070369957882005086e-08,
                  4.2347877827932403518e-07, -1.3654692000834678645e-06,
                  -1.3882523362786468719e-05, 0.0001867342080340571352,
                  -0.00074070253416626697512, -0.0060336708714301490533,
                  0.24015818242558961693, 1.6536545626831027356):
            p = p * w + c
    elif w < 16.0:
        w = math.sqrt(w) - 3.25
        p = 2.2137376921775787049e-09
        for c in (9.0756561938885390979e-08, -2.7517406297064545428e-07,
                  1.8239629214389227755e-08, 1.5027403968909827627e-06,
                  -4.013867526981545969e-06, 2.9234449089955446044e-06,
                  1.2475304481671778723e-05, -4.7318229009055733981e-05,
                  6.8284851459573175448e-05, 2.4031110387097893999e-05,
                  -0.0003550375203628474796, 0.00095328937973738049703,
                  -0.0016882755560235047313, 0.0024914420961078508066,
                  -0.0037512085075692412107, 0.005370914553590063617,
                  1.0052589676941592334, 3.0838856104922207635):
            p = p * w + c
    else:
        w = math.sqrt(w) - 5.0
        p = -2.7109920616438573243e-11
        for c in (-2.5556418169965252055e-10, 1.5076572693500548083e-09,
                  -3.7894654401267369937e-09, 7.6157012080783393804e-09,
                  -1.4960026627149240478e-08, 2.9147953450901080826e-08,
                  -6.7711997758452339498e-08, 2.2900482228026654717e-07,
                  -9.9298272942317002539e-07, 4.5260625972231537039e-06,
                  -1.9681778105531670567e-05, 7.5995277030017761139e-05,
                  -0.00021503011930044477347, -0.00013871931833623122026,
                  1.0103004648645343977, 4.8499064014085844221):
            p = p * w + c
    x = p * y
    # two Newton iterations: f(x) = erf(x) - y
    for _ in range(2):
        err = math.erf(x) - y
        x -= err / (2.0 / math.sqrt(math.pi) * math.exp(-x * x))
    return x


def chi2_invcdf_df2(p: float) -> float:
    """Inverse CDF of chi-squared with 2 dof: F(x) = 1 - exp(-x/2)."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"p must be in [0, 1): {p}")
    return -2.0 * math.log(1.0 - p)


def chisq3_reference(n0A, n1A, n0B, n1B, n0C, n1C,
                     critical: float) -> np.ndarray:
    """True where the 3-group statistic exceeds the critical value."""
    return critical < chisq_statistic3(n0A, n1A, n0B, n1B, n0C, n1C)


def chisq_statistic3(n0A, n1A, n0B, n1B, n0C, n1C) -> np.ndarray:
    """Vectorized StatsKmers3GroupsFinder.chisq statistic (float32,
    verbatim — src/tools/StatsKmers3GroupsFinder.java:346-369)."""
    c0 = np.asarray(n0A, dtype=np.float32)
    c1 = np.asarray(n1A, dtype=np.float32)
    p0 = np.asarray(n0B, dtype=np.float32)
    p1 = np.asarray(n1B, dtype=np.float32)
    q0 = np.asarray(n0C, dtype=np.float32)
    q1 = np.asarray(n1C, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        c0n = 100 * c0 / (c0 + c1); c1n = 100 * c1 / (c0 + c1)  # noqa: E702
        p0n = 100 * p0 / (p0 + p1); p1n = 100 * p1 / (p0 + p1)  # noqa: E702
        q0n = 100 * q0 / (q0 + q1); q1n = 100 * q1 / (q0 + q1)  # noqa: E702
        gr1 = c0n + c1n
        gr2 = p0n + p1n
        gr3 = q0n + q1n
        allv = gr1 + gr2 + gr3
        s1 = p1n + c1n + q1n
        s0 = p0n + c0n + q0n
        x1 = gr1 / allv * s1
        x2 = gr1 / allv * s0
        x3 = gr2 / allv * s1
        x4 = gr2 / allv * s0
        x5 = gr3 / allv * s1
        x6 = gr3 / allv * s0
        stat = ((np.abs(p1n - x1) - 0.5).astype(np.float64) ** 2 / x1
                + (np.abs(p0n - x2) - 0.5).astype(np.float64) ** 2 / x2
                + (np.abs(c1n - x3) - 0.5).astype(np.float64) ** 2 / x3
                + (np.abs(c0n - x4) - 0.5).astype(np.float64) ** 2 / x4
                + (np.abs(q1n - x5) - 0.5).astype(np.float64) ** 2 / x5
                + (np.abs(q0n - x6) - 0.5).astype(np.float64) ** 2 / x6)
    return stat


def chisq_reference(n0A, n1A, n0B, n1B, critical: float) -> np.ndarray:
    """Vectorized StatsKmersFinder.chisq: True where statistic > critical."""
    return critical < chisq_statistic2(n0A, n1A, n0B, n1B)


def chisq_statistic2(n0A, n1A, n0B, n1B) -> np.ndarray:
    """The percent-normalized Yates 2x2 statistic itself (float32 like the
    Java original; also TopStatsKmersFinder.chisq_2gr)."""
    c0 = np.asarray(n0A, dtype=np.float32)
    c1 = np.asarray(n1A, dtype=np.float32)
    p0 = np.asarray(n0B, dtype=np.float32)
    p1 = np.asarray(n1B, dtype=np.float32)

    with np.errstate(divide="ignore", invalid="ignore"):
        sc = c0 + c1
        c0n = 100 * c0 / sc
        c1n = 100 * c1 / sc
        sp = p0 + p1
        p0n = 100 * p0 / sp
        p1n = 100 * p1 / sp
        gr1 = c0n + c1n
        gr2 = p0n + p1n
        allv = gr1 + gr2
        x1 = gr1 / allv * (p1n + c1n)
        x2 = gr1 / allv * (p0n + c0n)
        x3 = gr2 / allv * (p1n + c1n)
        x4 = gr2 / allv * (p0n + c0n)
        kk = ((np.abs(p1n - x1) - 0.5).astype(np.float64) ** 2 / x1
              + (np.abs(p0n - x2) - 0.5).astype(np.float64) ** 2 / x2
              + (np.abs(c1n - x3) - 0.5).astype(np.float64) ** 2 / x3
              + (np.abs(c0n - x4) - 0.5).astype(np.float64) ** 2 / x4)
    return kk


def mannwhitney_p_umin(umin, n1: int, n2: int) -> np.ndarray:
    """Two-sided Mann-Whitney p of each U_min, for groups of n1 and n2."""
    mu = n1 * n2 / 2.0
    sigma = math.sqrt(n1 * n2 * (n1 + n2 + 1) / 12.0)
    zstat = (np.asarray(umin, dtype=np.float64) - mu) / sigma
    # commons-math: 2 * Phi(z)
    return 2.0 * _norm_cdf(zstat)


# comparisons held at once on the device: [rows, n1 + n2, n1] a chunk
_MW_CELLS = 1 << 27


def mannwhitney_umin2_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Twice U_min per row of (a [N, n1], b [N, n2]), an exact int64, on
    their device.  Twice a number's average rank among ties is
    2 * (#smaller) + #equal + 1, NaNs not counted.  A NaN ranks as the JAX
    package's stable argsort puts it: after every number, a tie run of
    its own, NaNs in column order, so a NaN at column j of
    concat(a, b) has twice the rank 2 * (#numbers in the row + #NaNs
    before j) + 2.  No rank is rounded."""
    n1, n2 = a.shape[1], b.shape[1]
    rows = max(1, _MW_CELLS // ((n1 + n2) * max(n1, 1)))
    out = torch.empty(len(a), dtype=torch.int64, device=a.device)
    for lo in range(0, len(a), rows):
        z = torch.cat([a[lo:lo + rows], b[lo:lo + rows]], dim=1)
        za = z[:, None, :n1]
        less = (z[:, :, None] < za).sum(dim=1)
        equal = (z[:, :, None] == za).sum(dim=1)
        nan = z.isnan()
        numbers = (~nan).sum(dim=1, keepdim=True)
        nan_a = nan[:, :n1]
        before = nan_a.cumsum(dim=1) - nan_a.long()
        rank2 = torch.where(nan_a, 2 * (numbers + before) + 2,
                            2 * less + equal + 1)
        u1 = rank2.sum(dim=1) - n1 * (n1 + 1)
        out[lo:lo + rows] = torch.minimum(u1, 2 * n1 * n2 - u1)
    return out


def mannwhitney_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-sided Mann-Whitney p per row of (a [N, n1], b [N, n2]), float64
    on their device: twice U_min on the device, then
    ``mannwhitney_p_umin`` on the host once for each distinct U_min, which
    takes few values."""
    u2, inv = torch.unique(mannwhitney_umin2_rows(a, b), return_inverse=True)
    trace.d2h(u2)
    p = mannwhitney_p_umin(u2.cpu().numpy() / 2.0, a.shape[1], b.shape[1])
    return torch.from_numpy(p).to(a.device)[inv]


_erf_vec = np.vectorize(math.erf, otypes=[np.float64])


def _norm_cdf(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return 0.5 * (1.0 + _erf_vec(x / math.sqrt(2.0)))
