"""MCMC convergence diagnostics: split-R-hat and effective sample size.

The port's own copy of ``gaussian_processes_tpu/inference/diagnostics.py``
(numpy only; the port imports nothing of the JAX package).  Host-side
post-processing, not a hot path: the standard split-chain potential scale
reduction and the FFT-autocorrelation ESS with Geyer's initial monotone
sequence truncation.

Input convention everywhere: ``draws`` with shape (S, C, D) — samples,
chains, dimensions — as produced by ``sample_nuts`` and ``sample_chees``
(tensors are taken as numpy arrays by the caller).
"""

from __future__ import annotations

import numpy as np


def _split_chains(draws: np.ndarray) -> np.ndarray:
    """(S, C, D) -> (S//2, 2C, D): each chain halved."""
    S = draws.shape[0] - (draws.shape[0] % 2)
    half = S // 2
    a = draws[:half]
    b = draws[half:S]
    return np.concatenate([a, b], axis=1)


def split_rhat(draws: np.ndarray) -> np.ndarray:
    """Split potential scale reduction factor per dimension, shape (D,).

    Values near 1 indicate mixed chains; > 1.01 is cause for concern.
    """
    x = _split_chains(np.asarray(draws, float))
    m, c, d = x.shape
    chain_mean = x.mean(axis=0)  # (2C, D)
    chain_var = x.var(axis=0, ddof=1)  # (2C, D)
    W = chain_var.mean(axis=0)
    B = m * chain_mean.var(axis=0, ddof=1)
    var_plus = (m - 1) / m * W + B / m
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / W)


def _autocov_fft_batched(x: np.ndarray) -> np.ndarray:
    """Autocovariance along axis 0 for every (chain, dim) series at once,
    biased (divided by m): x (m, c, d) -> (m, c, d), one batched rfft/irfft
    pair."""
    m = x.shape[0]
    x = x - x.mean(axis=0, keepdims=True)
    nfft = 1 << (2 * m - 1).bit_length()
    f = np.fft.rfft(x, nfft, axis=0)
    acov = np.fft.irfft(f * np.conjugate(f), nfft, axis=0)[:m].real
    return acov / m


def ess(draws: np.ndarray) -> np.ndarray:
    """Bulk effective sample size per dimension, shape (D,).

    Combines chains a la Stan: mean autocovariance across (split) chains,
    between-chain correction through var_plus, paired-sum (Geyer) series
    truncated at the first non-positive pair and enforced monotone.
    Fully vectorized over chains and dimensions.
    """
    x = _split_chains(np.asarray(draws, float))
    m, c, d = x.shape
    acovs = _autocov_fft_batched(x)  # (m, c, d)
    mean_acov = acovs.mean(axis=1)  # (m, d)
    chain_var = acovs[0] * m / (m - 1.0)  # (c, d)
    W = chain_var.mean(axis=0)  # (d,)
    if c > 1:
        B_over_m = x.mean(axis=0).var(axis=0, ddof=1)  # (d,)
    else:
        B_over_m = np.zeros(d)
    var_plus = W * (m - 1.0) / m + B_over_m  # (d,)
    ok = np.isfinite(var_plus) & (var_plus > 0)
    safe_vp = np.where(ok, var_plus, 1.0)
    rho = 1.0 - (W[None, :] - mean_acov) / safe_vp[None, :]  # (m, d)
    # Geyer paired sums: P_t = rho_{2t} + rho_{2t+1}, truncated at the
    # first non-positive pair; tau = -1 + 2 * sum of monotone pairs
    n_pairs = (m - 1) // 2
    pairs = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs + 1 : 2]  # (T, d)
    keep = np.cumprod(pairs > 0, axis=0).astype(bool)  # stop at 1st <= 0
    mono = np.minimum.accumulate(np.where(keep, pairs, np.inf), axis=0)
    tau = -1.0 + 2.0 * np.sum(np.where(keep, mono, 0.0), axis=0)
    tau = np.maximum(tau, 1.0 / np.log10(m + 10))  # guard anti-correlation
    return np.where(ok, m * c / tau, np.nan)


def summarize(draws: np.ndarray, wall_s: float | None = None) -> dict:
    """Standard diagnostic summary for a (S, C, D) draw array."""
    draws = np.asarray(draws, float)
    r = split_rhat(draws)
    e = ess(draws)
    flat = draws.reshape(-1, draws.shape[-1])
    out = {
        "mean": flat.mean(0).tolist(),
        "sd": flat.std(0).tolist(),
        "split_rhat": r.tolist(),
        "ess": e.tolist(),
        "min_ess": float(np.nanmin(e)),
        "max_rhat": float(np.nanmax(r)),
    }
    if wall_s is not None:
        out["ess_per_s"] = float(np.nanmin(e) / wall_s)
    return out
