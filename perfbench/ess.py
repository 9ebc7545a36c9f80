"""Bulk effective sample size: a frozen copy.

Copied from ``gaussian_processes_tpu_torch/inference/diagnostics.py``
(``_split_chains``, ``_autocov_fft_batched``, ``ess``), so
that a later change to the program cannot change the yardstick.  Draws are
(S, C, D): samples, chains, dimensions.
"""

from __future__ import annotations

import numpy as np


def _split_chains(draws: np.ndarray) -> np.ndarray:
    """(S, C, D) -> (S//2, 2C, D): each chain halved."""
    S = draws.shape[0] - (draws.shape[0] % 2)
    half = S // 2
    return np.concatenate([draws[:half], draws[half:S]], axis=1)


def _autocov_fft_batched(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance along axis 0 of every (chain, dim) series."""
    m = x.shape[0]
    x = x - x.mean(axis=0, keepdims=True)
    nfft = 1 << (2 * m - 1).bit_length()
    f = np.fft.rfft(x, nfft, axis=0)
    acov = np.fft.irfft(f * np.conjugate(f), nfft, axis=0)[:m].real
    return acov / m


def ess(draws: np.ndarray) -> np.ndarray:
    """Bulk ESS per dimension (D,): Stan's combination of split chains,
    Geyer's initial monotone sequence."""
    x = _split_chains(np.asarray(draws, float))
    m, c, d = x.shape
    acovs = _autocov_fft_batched(x)
    mean_acov = acovs.mean(axis=1)
    chain_var = acovs[0] * m / (m - 1.0)
    W = chain_var.mean(axis=0)
    B_over_m = x.mean(axis=0).var(axis=0, ddof=1) if c > 1 else np.zeros(d)
    var_plus = W * (m - 1.0) / m + B_over_m
    ok = np.isfinite(var_plus) & (var_plus > 0)
    safe_vp = np.where(ok, var_plus, 1.0)
    rho = 1.0 - (W[None, :] - mean_acov) / safe_vp[None, :]
    n_pairs = (m - 1) // 2
    pairs = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs + 1:2]
    keep = np.cumprod(pairs > 0, axis=0).astype(bool)
    mono = np.minimum.accumulate(np.where(keep, pairs, np.inf), axis=0)
    tau = -1.0 + 2.0 * np.sum(np.where(keep, mono, 0.0), axis=0)
    tau = np.maximum(tau, 1.0 / np.log10(m + 10))
    return np.where(ok, m * c / tau, np.nan)

