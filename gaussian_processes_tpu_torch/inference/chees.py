"""ChEES-HMC: jittered fixed-trajectory HMC with adaptive length.

Counterpart of ``gaussian_processes_tpu/inference/chees.py``: the tree-free
alternative to NUTS.  Every iteration runs ONE jittered trajectory length
``t = u * T`` (u ~ Uniform(0, 1), the same for all chains), so every
leapfrog evaluates the log density of all C chains at once with nothing
masked (``log_density.value_and_grad`` on (C, D): on a card one B1 launch,
the batched blocked factor over B3, one B2a launch).  The mean trajectory
length T adapts by Adam on log T with the ChEES criterion's gradient
(Change in the Estimator of the Expected Square)

    (||z' - mu||^2 - ||z - mu||^2) * ((z' - mu) . v') * u

with v' the final velocity and mu the cross-chain mean; the step size by
dual averaging toward acceptance 0.651, the diagonal mass matrix by the
windowed Welford estimate of NUTS.  Two measured fixes of the JAX package
are kept: the step size adapts to the HARMONIC mean of the chains'
acceptance (the arithmetic mean hides stuck chains), and the ChEES gradient
is NaN-safe (a non-finite trajectory contributes zero; 0 * NaN once stuck
T at NaN and collapsed trajectories to one leapfrog).

The loop over transitions runs on the host; the number of leapfrogs of a
transition is read from the device once per transition (one
``inference.host_syncs`` in ``utils.profiling.counts``).  Randomness comes
from one ``torch.Generator`` in a fixed order; a chain-sharded run
(``parallel/sharded.py``) draws the trajectory jitter from a generator every
rank shares and the momenta from its own (``CheesState.momentum_generator``),
as the JAX package folds the device index into the momentum key only.

CAVEAT (JAX package, measured): with a shared trajectory length, a chain in
a mode much narrower than the bulk's can integrate whole oscillations per
trajectory and appear frozen at acceptance ~1; watch per-chain spread
beside R-hat, and prefer NUTS where modes of very different scales are
expected.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gaussian_processes_tpu_torch.inference import adaptation as adapt
from gaussian_processes_tpu_torch.inference.nuts import (
    ChainState,
    _default_reduce_mean,
    _default_reduce_welford,
    _draw,
    _kinetic,
    init_chain,
    value_and_grad_fn,
)
from gaussian_processes_tpu_torch.utils.profiling import counts, span


def _default_reduce_vec_mean(x):
    return torch.mean(x, dim=0)


class CheesInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,)
    num_leapfrog: int  # shared across chains
    diverging: torch.Tensor  # (C,)


@dataclasses.dataclass(frozen=True)
class CheesState:
    """State carried between ChEES transitions."""

    chains: ChainState  # batched (C, ...)
    da: adapt.DualAveragingState  # step size
    welford: adapt.WelfordState  # mass matrix moments
    inv_mass: torch.Tensor  # (D,)
    step_size: torch.Tensor
    traj_length: torch.Tensor  # mean trajectory length T
    traj_m: torch.Tensor  # Adam first moment for log T
    traj_v: torch.Tensor  # Adam second moment for log T
    traj_count: int
    generator: torch.Generator | None
    #: the momenta's and acceptances' own stream (None: ``generator``)
    momentum_generator: torch.Generator | None = None


class CheesResult(NamedTuple):
    positions: torch.Tensor  # (S, C, D)
    log_probs: torch.Tensor
    accept_prob: torch.Tensor
    num_leapfrog: torch.Tensor  # (S,)
    diverging: torch.Tensor
    step_size: torch.Tensor
    traj_length: torch.Tensor
    inv_mass: torch.Tensor
    final: CheesState


def _hmc_trajectory(vg, chains: ChainState, generator, eps, n_steps: int, inv_mass):
    """Leapfrog trajectory of ``n_steps`` + MH accept for all chains at once."""
    r0 = _draw(generator, torch.randn, chains.z.shape, chains.z) / torch.sqrt(inv_mass)
    u = _draw(generator, torch.rand, chains.logp.shape, chains.logp)
    z, r, logp, grad = chains.z, r0, chains.logp, chains.grad
    for _ in range(n_steps):
        r_half = r + 0.5 * eps * grad
        z = z + eps * inv_mass * r_half
        logp, grad = vg(z)
        r = r_half + 0.5 * eps * grad

    log_accept = (-chains.logp + _kinetic(r0, inv_mass)) - (-logp + _kinetic(r, inv_mass))
    finite = torch.isfinite(log_accept)
    accept_prob = torch.where(finite, torch.exp(torch.clamp(log_accept, max=0.0)),
                              torch.zeros_like(log_accept))
    take = (u < accept_prob) & finite
    new = ChainState(z=torch.where(take[:, None], z, chains.z),
                     logp=torch.where(take, logp, chains.logp),
                     grad=torch.where(take[:, None], grad, chains.grad))
    # final velocity of the proposal, for the ChEES gradient
    return new, z, inv_mass * r, accept_prob, ~finite


def _chees_grad(z0, z1, v1, accept_prob, u_jitter, reduce_mean=_default_reduce_mean,
                reduce_vec_mean=_default_reduce_vec_mean):
    """Stochastic gradient of the ChEES criterion wrt trajectory time; the
    cross-chain means go through the pooling hooks.

    NaN-safe: a blown-up trajectory (non-finite z1/v1, acceptance 0)
    contributes zero instead of poisoning the Adam moments.
    """
    finite = torch.isfinite(z1).all(dim=-1) & torch.isfinite(v1).all(dim=-1)  # (C,)
    z1s = torch.where(finite[:, None], z1, z0)
    v1s = torch.where(finite[:, None], v1, torch.zeros_like(v1))
    mu0 = reduce_vec_mean(z0)  # (D,) cross-chain (and cross-rank) mean
    mu1 = reduce_vec_mean(z1s)
    a = torch.sum(torch.square(z1s - mu1), dim=-1) - torch.sum(torch.square(z0 - mu0), dim=-1)
    b = torch.sum((z1s - mu1) * v1s, dim=-1)  # d/dt ||z1 - mu||^2 / 2
    per_chain = torch.where(finite, accept_prob * a * b * u_jitter, torch.zeros_like(a))
    denom = torch.clamp(reduce_mean(accept_prob), min=1e-4)
    g = reduce_mean(per_chain) / denom
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _n_leapfrog(t, eps, max_leapfrog: int) -> int:
    """clip(ceil(t / eps), 1, max_leapfrog), read on the host (a host sync,
    counted); a non-finite ratio takes one step."""
    counts["inference.host_syncs"] += 1
    ratio = float(t / eps)
    if not math.isfinite(ratio):
        return 1
    return min(max(math.ceil(ratio), 1), max_leapfrog)


def chees_step(
    log_density,
    state: CheesState,
    *,
    adapt_traj: bool,
    flags=None,
    step: int = 0,
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
    adam_lr: float = 0.025,
    reduce_mean=_default_reduce_mean,
    reduce_welford=_default_reduce_welford,
    reduce_vec_mean=_default_reduce_vec_mean,
):
    """One ChEES-HMC iteration over all (local) chains; with ``adapt_traj``,
    warmup step ``step`` of the schedule ``flags``.  The ``reduce_*`` hooks
    pool the adaptation statistics (local by default; across ranks in
    ``parallel/sharded.py``)."""
    with span("gp.inference.chees_step"):
        vg = value_and_grad_fn(log_density)
        mom_gen = (state.momentum_generator if state.momentum_generator is not None
                   else state.generator)
        eps = torch.exp(state.da.log_step) if adapt_traj else state.step_size
        u_jitter = _draw(state.generator, torch.rand, (), state.traj_length)
        n_steps = _n_leapfrog(u_jitter * state.traj_length, eps, max_leapfrog)

        z0 = state.chains.z
        chains, z1, v1, accept, nonfinite = _hmc_trajectory(
            vg, state.chains, mom_gen, eps, n_steps, state.inv_mass)

        da, welford, inv_mass = state.da, state.welford, state.inv_mass
        traj_length, traj_m, traj_v = state.traj_length, state.traj_m, state.traj_v
        traj_count, step_size = state.traj_count, state.step_size

        if adapt_traj:
            # HARMONIC mean of the chains' acceptance: dominated by the worst
            # chains, it throttles the shared step size until every chain
            # moves; the 1e-3 floor keeps one pathological chain from stalling
            # adaptation outright
            pooled_accept = 1.0 / reduce_mean(1.0 / torch.clamp(accept, min=1e-3))
            da = adapt.da_update(da, pooled_accept, target_accept=target_accept)

            # trajectory length: Adam on log T with the normalized gradient (ascent)
            g = _chees_grad(z0, z1, v1, accept, u_jitter, reduce_mean, reduce_vec_mean)
            g = g / (torch.abs(g) + 1e-10)
            traj_count += 1
            b1, b2 = 0.9, 0.999
            traj_m = b1 * traj_m + (1 - b1) * g
            traj_v = b2 * traj_v + (1 - b2) * g * g
            mhat = traj_m / (1 - b1 ** traj_count)
            vhat = traj_v / (1 - b2 ** traj_count)
            traj_length = torch.exp(torch.log(traj_length)
                                    + adam_lr * mhat / (torch.sqrt(vhat) + 1e-8))

            welford, da, inv_mass = adapt.adapt_window(welford, da, inv_mass, chains.z, flags,
                                                       step, reduce_welford)
            step_size = torch.exp(da.log_avg_step if flags["last"][step] else da.log_step)

        new_state = CheesState(chains=chains, da=da, welford=welford, inv_mass=inv_mass,
                               step_size=step_size, traj_length=traj_length, traj_m=traj_m,
                               traj_v=traj_v, traj_count=traj_count, generator=state.generator,
                               momentum_generator=state.momentum_generator)
        return new_state, CheesInfo(accept_prob=accept, num_leapfrog=n_steps, diverging=nonfinite)


def init_chees_state(log_density, init_position, generator, *, init_step_size: float = 0.1,
                     init_traj_length: float = 1.0, momentum_generator=None) -> CheesState:
    """The state before warmup, for the (C, D) chains ``init_position``."""
    like = dict(dtype=init_position.dtype, device=init_position.device)
    dim = init_position.shape[-1]
    step = torch.as_tensor(init_step_size, **like)
    return CheesState(
        chains=init_chain(log_density, init_position),
        da=adapt.da_init(step),
        welford=adapt.welford_init(dim, **like),
        inv_mass=torch.ones((dim,), **like),
        step_size=step,
        traj_length=torch.as_tensor(init_traj_length, **like),
        traj_m=torch.zeros((), **like),
        traj_v=torch.zeros((), **like),
        traj_count=0,
        generator=generator,
        momentum_generator=momentum_generator,
    )


def chees_warmup(log_density, state: CheesState, num_warmup: int, *, start: int = 0,
                 stop: int | None = None, target_accept: float = 0.651,
                 max_leapfrog: int = 1000, reduce_mean=_default_reduce_mean,
                 reduce_welford=_default_reduce_welford,
                 reduce_vec_mean=_default_reduce_vec_mean) -> CheesState:
    """Steps [start, stop) of the warmup schedule of ``num_warmup`` steps
    (step size, mass matrix, trajectory length): a warmup checkpointed after
    ``start`` steps resumes here bit for bit."""
    flags = adapt.build_warmup_schedule(num_warmup)
    stop = num_warmup if stop is None else stop
    for i in range(start, stop):
        state, _ = chees_step(log_density, state, adapt_traj=True, flags=flags, step=i,
                              target_accept=target_accept, max_leapfrog=max_leapfrog,
                              reduce_mean=reduce_mean, reduce_welford=reduce_welford,
                              reduce_vec_mean=reduce_vec_mean)
    return state


def chees_collect(log_density, state: CheesState, num_samples: int, *,
                  max_leapfrog: int = 1000) -> CheesResult:
    """Fixed-settings collection of ``num_samples`` >= 1 draws from
    ``state``; resumable from a checkpointed state."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    zs, lps, accs, nls, divs = [], [], [], [], []
    for _ in range(num_samples):
        state, info = chees_step(log_density, state, adapt_traj=False, max_leapfrog=max_leapfrog)
        zs.append(state.chains.z)
        lps.append(state.chains.logp)
        accs.append(info.accept_prob)
        nls.append(info.num_leapfrog)
        divs.append(info.diverging)
    return CheesResult(
        positions=torch.stack(zs),
        log_probs=torch.stack(lps),
        accept_prob=torch.stack(accs),
        num_leapfrog=torch.tensor(nls, dtype=torch.int64),
        diverging=torch.stack(divs),
        step_size=state.step_size,
        traj_length=state.traj_length,
        inv_mass=state.inv_mass,
        final=state,
    )


def sample_chees(
    log_density,
    init_position,
    generator=None,
    num_warmup: int = 500,
    num_samples: int = 1000,
    *,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
    reduce_mean=_default_reduce_mean,
    reduce_welford=_default_reduce_welford,
    reduce_vec_mean=_default_reduce_vec_mean,
) -> CheesResult:
    """ChEES-HMC over C chains (``init_position`` (C, D)): warmup (step
    size, mass matrix, trajectory length), then fixed-settings collection
    of ``num_samples`` >= 1 draws; the ``reduce_*`` hooks pool the warmup's
    statistics."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    state = init_chees_state(log_density, init_position, generator,
                             init_step_size=init_step_size, init_traj_length=init_traj_length)
    state = chees_warmup(log_density, state, num_warmup, target_accept=target_accept,
                         max_leapfrog=max_leapfrog, reduce_mean=reduce_mean,
                         reduce_welford=reduce_welford, reduce_vec_mean=reduce_vec_mean)
    return chees_collect(log_density, state, num_samples, max_leapfrog=max_leapfrog)
