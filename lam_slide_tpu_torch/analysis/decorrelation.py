"""Autocovariance / decorrelation analysis.

Numpy replacement for statsmodels ``acovf`` (used at
src/eval_peptide.py:137-186 for torsion and TICA decorrelation curves) and
the emcee autocorrelation-time / effective-sample-size estimate
(src/utils/tica_utils.py:78-86).
"""

from typing import Optional

import numpy as np


def acovf(
    x: np.ndarray,
    demean: bool = True,
    adjusted: bool = False,
    nlag: Optional[int] = None,
) -> np.ndarray:
    """Autocovariance function via FFT (statsmodels.tsa.stattools.acovf).

    adjusted=True divides lag k by (n-k) instead of n.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    if demean:
        x = x - x.mean()
    nobs = nlag + 1 if nlag is not None else n
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conjugate(f), nfft)[:min(nobs, n)].real
    if adjusted:
        acov = acov / (n - np.arange(len(acov)))
    else:
        acov = acov / n
    return acov


def torsion_decorrelation(angles: np.ndarray, nlag: int = 1000) -> np.ndarray:
    """Normalized sin+cos autocovariance curve of a torsion time series
    (eval_peptide.py:140-150): (acovf(sin)+acovf(cos) − baseline)/(1 − baseline)."""
    ac = acovf(np.sin(angles), demean=False, adjusted=True, nlag=nlag) + acovf(
        np.cos(angles), demean=False, adjusted=True, nlag=nlag
    )
    baseline = np.sin(angles).mean() ** 2 + np.cos(angles).mean() ** 2
    return (ac - baseline) / (1.0 - baseline)


def integrated_autocorr_time(x: np.ndarray, c: float = 5.0) -> float:
    """Sokal/emcee-style automated-windowing integrated autocorrelation time."""
    ac = acovf(x, demean=True)
    if ac[0] <= 0:
        return float("nan")
    rho = ac / ac[0]
    taus = 2.0 * np.cumsum(rho) - 1.0
    window = np.arange(len(taus)) >= c * taus
    idx = np.argmax(window) if window.any() else len(taus) - 1
    return float(max(taus[idx], 1.0))


def effective_sample_size(x: np.ndarray) -> float:
    """ESS = N / tau (tica_utils.py:78-86 semantics)."""
    return len(x) / integrated_autocorr_time(x)
