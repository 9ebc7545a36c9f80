"""Warmup adaptation for HMC/NUTS: step size and mass matrix.

Counterpart of ``gaussian_processes_tpu/inference/adaptation.py``:

* **Dual averaging** (Nesterov primal-dual) of the log step size toward a
  target acceptance statistic.
* **Welford** running mean/variance of the positions, pooled across all
  chains, regularized toward the identity.
* A **windowed warmup schedule**: a step-size-only init buffer, doubling
  "slow" windows in which the mass matrix is estimated (applied at each
  window end, with the step size re-initialized), and a step-size-only
  term buffer.  The schedule is plain numpy; the samplers read its flags on
  the host, one step at a time.

The states are frozen dataclasses of tensors (the dual-averaging count is a
Python int: the samplers' loops run on the host); every update is a pure
function ``state -> state``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Dual averaging (step size)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DualAveragingState:
    """Primal-dual averaging state for log step size."""

    log_step: torch.Tensor
    log_avg_step: torch.Tensor
    avg_error: torch.Tensor  # running weighted average of (target - accept)
    count: int  # adaptation steps taken in the current window
    mu: torch.Tensor  # shrinkage target (log of 10x initial step)


def da_init(step_size) -> DualAveragingState:
    log_step = torch.log(torch.as_tensor(step_size))
    return DualAveragingState(
        log_step=log_step,
        log_avg_step=log_step,
        avg_error=torch.zeros_like(log_step),
        count=0,
        mu=math.log(10.0) + log_step,
    )


def da_update(
    state: DualAveragingState,
    accept_prob,
    target_accept: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.count + 1
    eta_h = 1.0 / (t + t0)
    avg_error = (1.0 - eta_h) * state.avg_error + eta_h * (target_accept - accept_prob)
    log_step = state.mu - math.sqrt(t) / gamma * avg_error
    eta = t ** (-kappa)
    log_avg_step = eta * log_step + (1.0 - eta) * state.log_avg_step
    return DualAveragingState(
        log_step=log_step,
        log_avg_step=log_avg_step,
        avg_error=avg_error,
        count=t,
        mu=state.mu,
    )


def da_restart(state: DualAveragingState, step_size) -> DualAveragingState:
    """Re-initialize after a mass-matrix update (new window)."""
    return da_init(step_size)


# ---------------------------------------------------------------------------
# Welford (mass matrix)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WelfordState:
    """Running mean/M2 over position draws; ``mean``/``m2`` shape (D,)."""

    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(dim: int, dtype=torch.float32, device=None) -> WelfordState:
    return WelfordState(
        mean=torch.zeros((dim,), dtype=dtype, device=device),
        m2=torch.zeros((dim,), dtype=dtype, device=device),
        count=torch.zeros((), dtype=dtype, device=device),
    )


def welford_update_batch(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """Fold a batch of draws x with shape (C, D) into the running moments.

    Chan et al. parallel update: exact pooled mean/M2 for the batch, then
    merge with the running state; one call per warmup step folds all chains
    at once.
    """
    c = torch.full((), x.shape[0], dtype=state.count.dtype, device=state.count.device)
    bmean = torch.mean(x, dim=0)
    bm2 = torch.sum(torch.square(x - bmean), dim=0)
    return welford_merge(state, WelfordState(mean=bmean, m2=bm2, count=c))


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Merge two independent Welford accumulators (exact)."""
    n = a.count + b.count
    safe_n = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe_n)
    m2 = a.m2 + b.m2 + torch.square(delta) * (a.count * b.count / safe_n)
    return WelfordState(mean=mean, m2=m2, count=n)


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    """(Regularized) sample variance — the diagonal inverse mass matrix.

    Shrinks toward 1e-3 with weight 5/(n+5), keeping early-window
    estimates well-conditioned.
    """
    n = state.count
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        w = n / (n + 5.0)
        var = w * var + (1.0 - w) * 1e-3
    return var


# ---------------------------------------------------------------------------
# Warmup window schedule
# ---------------------------------------------------------------------------


def build_warmup_schedule(
    num_warmup: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    first_window: int = 25,
):
    """Per-step flags for the windowed warmup, as numpy bool arrays.

    Returns a dict with, for each warmup step i:
      in_slow[i]     — positions at step i feed the Welford estimator
      window_end[i]  — after step i, refresh inv-mass from Welford,
                       reset Welford, and restart dual averaging
      last[i]        — i is the final warmup step (finalize step size)

    For short warmups (< init+term+first), everything collapses to
    step-size-only adaptation (no mass-matrix windows), like Stan.
    """
    in_slow = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    last = np.zeros(num_warmup, dtype=bool)
    if num_warmup > 0:
        last[num_warmup - 1] = True
    if num_warmup >= init_buffer + term_buffer + first_window:
        slow_lo = init_buffer
        slow_hi = num_warmup - term_buffer
        in_slow[slow_lo:slow_hi] = True
        # doubling windows: sizes first_window, 2*first_window, ... with the
        # final window absorbing the remainder up to slow_hi.
        size = first_window
        pos = slow_lo
        while pos < slow_hi:
            end = pos + size
            if end + 2 * size > slow_hi:
                end = slow_hi
            window_end[min(end, slow_hi) - 1] = True
            pos = end
            size *= 2
    return {"in_slow": in_slow, "window_end": window_end, "last": last}


def _identity(w):
    return w


def adapt_window(welford: WelfordState, da: DualAveragingState, inv_mass, chains_z,
                 flags: dict, step: int, reduce_welford=_identity):
    """The mass-matrix half of one warmup step, shared by NUTS and ChEES
    (``warmup_step`` in nuts.py, ``chees_step`` in chees.py of the JAX
    package): fold the chains' positions into Welford inside a slow window;
    at a window's end refresh the inverse mass from the pooled estimate
    (``reduce_welford`` of the local moments: the identity on one process,
    the exact merge across ranks in ``parallel/sharded.py``), reset the
    moments and restart dual averaging at the current step size.
    Returns (welford, da, inv_mass)."""
    if flags["in_slow"][step]:
        welford = welford_update_batch(welford, chains_z)
    if flags["window_end"][step]:
        inv_mass = welford_variance(reduce_welford(welford))
        welford = welford_init(inv_mass.shape[0], inv_mass.dtype, inv_mass.device)
        da = da_init(torch.exp(da.log_step))
    return welford, da, inv_mass
