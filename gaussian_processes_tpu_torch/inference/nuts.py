"""No-U-Turn Sampler over C chains in lockstep.

Counterpart of ``gaussian_processes_tpu/inference/nuts.py``: iterative
multinomial NUTS with the popcount checkpoint scheme for the U-turn checks
(O(max_depth) memory per chain), windowed warmup adaptation and
non-adaptive collection.  The JAX package writes one chain and batches it
with ``vmap``, whose while-loop rule masks the lanes that have finished.
Here the chains are an explicit leading dimension and the masking is
written out: a host loop over tree depths and, inside it, over the leaves
of the subtree; per-chain masks freeze the chains whose subtree or tree
has finished, diverged or turned.  Every leaf evaluates the log density
once, on the k chains still live there (``log_density.value_and_grad`` on
(k, D): on a card one B1 launch, one batched blocked factor over B3, one
B2a launch), gathered from and scattered back into the C rows; a leaf
where every chain lives evaluates all C rows as they are.  A chain's log
density never depends on another chain's row, as under ``vmap``, so the
live chains read the values a full-width evaluation gives them (bit for
bit on the CPU; on a card a smaller batch may round differently).  A depth
ends when no chain is active, a subtree when no chain is live: one read
from the device per depth (``active.any()``) and per leaf (the live count
k, which the gather also takes); each read counts one
``inference.host_syncs`` in ``utils.profiling.counts``.

* **Checkpoints.** Within a subtree, leaf ``i`` (0-indexed) is stored at
  slot ``popcount(i)`` when ``i`` is even; a complete sub-subtree of size
  ``2**k`` ending at leaf ``i`` (``2**k`` divides ``i+1``) is U-turn
  checked against the checkpoint at slot ``popcount(i + 1 - 2**k)``.  The
  leaf index is the same for every chain, so slots and checks are host
  integers.
* **Multinomial sampling** over the trajectory: leaves carry weight
  ``exp(energy0 - energy_leaf)``; subtrees resample progressively; a
  completed subtree replaces the tree proposal with probability
  ``min(1, w_subtree / w_tree)``.
* **Direction handling:** the backward edge stores its momentum negated,
  so every subtree is a forward integration from its edge; the cross-tree
  check un-negates the backward momentum.
* **Divergence** (energy error above ``max_delta_energy``, or non-finite)
  stops that chain's tree; NaN compares register as divergent.

Randomness comes from one ``torch.Generator`` (where the JAX package splits
keys), drawn on the generator's device for all chains in a fixed order, so
a run is deterministic under a seeded generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from gaussian_processes_tpu_torch.inference import adaptation as adapt
from gaussian_processes_tpu_torch.utils.profiling import counts, span


class ChainState(NamedTuple):
    """Per-chain state: positions (C, D), log densities (C,), gradients (C, D)."""

    z: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


class TransitionInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,)
    num_leapfrog: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor
    depth: torch.Tensor
    energy: torch.Tensor


def value_and_grad_fn(log_density) -> Callable:
    """``log_density.value_and_grad`` where it has one (gp_model's
    builders), else autograd of a plain function (C, D) -> (C,)."""
    if hasattr(log_density, "value_and_grad"):
        return log_density.value_and_grad

    def value_and_grad(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            value = log_density(z)
            (grad,) = torch.autograd.grad(value.sum(), z)
        return value.detach(), grad

    return value_and_grad


def init_chain(log_density, z) -> ChainState:
    logp, grad = value_and_grad_fn(log_density)(z)
    return ChainState(z=z, logp=logp, grad=grad)


def _draw(generator, fn, shape, like):
    device = generator.device if generator is not None else "cpu"
    return fn(shape, generator=generator, dtype=like.dtype, device=device).to(like.device)


def _leapfrog(vg, z, r, grad, eps, inv_mass):
    r_half = r + 0.5 * eps * grad
    z_new = z + eps * inv_mass * r_half
    logp, grad_new = vg(z_new)
    r_new = r_half + 0.5 * eps * grad_new
    return z_new, r_new, logp, grad_new


def _live_value_and_grad(vg, z, live, k: int, logp_fill, grad_fill):
    """``vg`` of the ``k`` rows of z (C, D) that ``live`` (C,) marks,
    scattered back into (C,) and (C, D); the other rows read ``logp_fill``
    and ``grad_fill``.  With every row live, ``vg(z)`` itself."""
    if k == z.shape[0]:
        return vg(z)
    rows = torch.nonzero_static(live, size=k).squeeze(1)  # k is known: no second sync
    logp, grad = vg(z.index_select(0, rows))
    return logp_fill.index_copy(0, rows, logp), grad_fill.index_copy(0, rows, grad)


def _kinetic(r, inv_mass):
    return 0.5 * torch.sum(inv_mass * r * r, dim=-1)


def _uturn(dz, r_a, r_b, inv_mass):
    """Original NUTS criterion on the span dz = z_b - z_a (diag metric),
    per chain over the last axis."""
    return (torch.sum(dz * inv_mass * r_a, dim=-1) < 0) | (torch.sum(dz * inv_mass * r_b, dim=-1) < 0)


def _where(mask, new, old):
    """Per-chain select: ``mask`` (C,) against (C,) or (C, D) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


@dataclasses.dataclass
class _Subtree:
    z_e: torch.Tensor  # forward edge of the subtree (continues with +eps)
    r_e: torch.Tensor
    grad_e: torch.Tensor
    logp_e: torch.Tensor
    z_p: torch.Tensor  # subtree proposal
    logp_p: torch.Tensor
    grad_p: torch.Tensor
    lsw: torch.Tensor  # log sum of leaf weights
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_acc: torch.Tensor
    n_leaves: torch.Tensor


def _build_subtree(vg, depth: int, edge, active, eps, inv_mass, energy0, max_depth,
                   max_delta_energy, generator) -> _Subtree:
    """Integrate up to 2**depth leapfrog steps forward from ``edge`` for
    the chains in ``active``; a chain stops at its first turning or
    divergent leaf.  Callers treat a turning or diverging subtree as
    rejected."""
    z0, r0, grad0, logp0 = edge
    C, D = z0.shape
    s = _Subtree(z_e=z0, r_e=r0, grad_e=grad0, logp_e=logp0, z_p=z0, logp_p=logp0,
                 grad_p=grad0, lsw=torch.full_like(logp0, -float("inf")),
                 turning=torch.zeros_like(active), diverging=torch.zeros_like(active),
                 sum_acc=torch.zeros_like(logp0), n_leaves=torch.zeros_like(logp0, dtype=torch.int64))
    ckpt_z = z0.new_zeros((C, max_depth + 1, D))
    ckpt_r = z0.new_zeros((C, max_depth + 1, D))
    for i in range(1 << depth):
        live = active & ~s.turning & ~s.diverging
        counts["inference.host_syncs"] += 1
        k = int(live.sum())
        if k == 0:
            break
        u = _draw(generator, torch.rand, (C,), logp0)
        z, r, logp, grad = _leapfrog(
            lambda z_new: _live_value_and_grad(vg, z_new, live, k, s.logp_e, s.grad_e),
            s.z_e, s.r_e, s.grad_e, eps, inv_mass)
        energy = -logp + _kinetic(r, inv_mass)
        lw = energy0 - energy  # log leaf weight; NaN => divergent below
        diverging = ~(lw > -max_delta_energy)
        # a non-finite leaf counts as acceptance 0, not NaN
        acc_leaf = torch.where(torch.isfinite(lw), torch.exp(torch.clamp(lw, max=0.0)),
                               torch.zeros_like(lw))
        # progressive multinomial proposal within the subtree
        lsw = torch.logaddexp(s.lsw, lw)
        take = live & (u < torch.exp(lw - lsw))
        s.z_p = _where(take, z, s.z_p)
        s.logp_p = _where(take, logp, s.logp_p)
        s.grad_p = _where(take, grad, s.grad_p)
        if i % 2 == 0:  # checkpoint even leaves at slot popcount(i)
            slot = bin(i).count("1")
            ckpt_z[:, slot] = _where(live, z, ckpt_z[:, slot])
            ckpt_r[:, slot] = _where(live, r, ckpt_r[:, slot])
        # U-turn checks of every complete sub-subtree ending at leaf i
        turning = s.turning
        k = 1
        while (i + 1) % (1 << k) == 0:
            slot = bin(i + 1 - (1 << k)).count("1")
            turn = _uturn(z - ckpt_z[:, slot], ckpt_r[:, slot], r, inv_mass)
            turning = turning | (live & turn)
            k += 1
        s.turning = turning
        s.z_e, s.r_e = _where(live, z, s.z_e), _where(live, r, s.r_e)
        s.grad_e, s.logp_e = _where(live, grad, s.grad_e), _where(live, logp, s.logp_e)
        s.lsw = _where(live, lsw, s.lsw)
        s.diverging = s.diverging | (live & diverging)
        s.sum_acc = s.sum_acc + torch.where(live, acc_leaf, torch.zeros_like(acc_leaf))
        s.n_leaves = s.n_leaves + live.to(s.n_leaves.dtype)
    return s


def nuts_transition(
    log_density,
    state: ChainState,
    generator: torch.Generator | None,
    step_size,
    inv_mass,
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
):
    """One NUTS transition of every chain of ``state`` (positions (C, D)),
    in lockstep."""
    with span("gp.inference.nuts_transition"):
        vg = value_and_grad_fn(log_density)
        z = state.z
        dtype = z.dtype
        eps = torch.as_tensor(step_size, dtype=dtype, device=z.device)
        inv_mass = torch.as_tensor(inv_mass, dtype=dtype, device=z.device).expand(z.shape[1:])
        C = z.shape[0]

        # r ~ N(0, M) with M^-1 = inv_mass (diagonal)
        r0 = _draw(generator, torch.randn, z.shape, z) / torch.sqrt(inv_mass)
        energy0 = -state.logp + _kinetic(r0, inv_mass)

        z_b, r_b, g_b, lp_b = z, -r0, state.grad, state.logp  # backward edge, momentum negated
        z_f, r_f, g_f, lp_f = z, r0, state.grad, state.logp
        z_p, lp_p, g_p = z, state.logp, state.grad
        lsw = torch.zeros_like(state.logp)  # the initial point has log weight 0
        depth = torch.zeros(C, dtype=torch.int64, device=z.device)
        turning = torch.zeros(C, dtype=torch.bool, device=z.device)
        diverging = torch.zeros_like(turning)
        sum_acc = torch.zeros_like(state.logp)
        n_leaves = torch.zeros_like(depth)

        for d in range(max_depth):
            active = ~turning & ~diverging
            counts["inference.host_syncs"] += 1
            if not bool(active.any()):
                break
            go_fwd = _draw(generator, torch.rand, (C,), z) < 0.5
            merge_u = _draw(generator, torch.rand, (C,), z)
            edge = (_where(go_fwd, z_f, z_b), _where(go_fwd, r_f, r_b),
                    _where(go_fwd, g_f, g_b), _where(go_fwd, lp_f, lp_b))
            sub = _build_subtree(vg, d, edge, active, eps, inv_mass, energy0, max_depth,
                                 max_delta_energy, generator)
            ok = active & ~sub.turning & ~sub.diverging

            # extend the chosen edge only when the subtree completed
            upd_f, upd_b = ok & go_fwd, ok & ~go_fwd
            z_f, r_f = _where(upd_f, sub.z_e, z_f), _where(upd_f, sub.r_e, r_f)
            g_f, lp_f = _where(upd_f, sub.grad_e, g_f), _where(upd_f, sub.logp_e, lp_f)
            z_b, r_b = _where(upd_b, sub.z_e, z_b), _where(upd_b, sub.r_e, r_b)
            g_b, lp_b = _where(upd_b, sub.grad_e, g_b), _where(upd_b, sub.logp_e, lp_b)

            # biased progressive proposal swap
            p_take = torch.clamp(torch.exp(sub.lsw - lsw), max=1.0)
            take = ok & (merge_u < p_take)
            z_p, lp_p, g_p = _where(take, sub.z_p, z_p), _where(take, sub.logp_p, lp_p), \
                _where(take, sub.grad_p, g_p)
            lsw = _where(ok, torch.logaddexp(lsw, sub.lsw), lsw)

            # cross-tree U-turn over the full extended trajectory
            cross = _uturn(z_f - z_b, -r_b, r_f, inv_mass)
            turning = turning | (active & sub.turning) | (ok & cross)
            diverging = diverging | (active & sub.diverging)
            sum_acc = sum_acc + sub.sum_acc
            n_leaves = n_leaves + sub.n_leaves
            depth = depth + active.to(depth.dtype)

        nl = torch.clamp(n_leaves, min=1)
        info = TransitionInfo(accept_prob=sum_acc / nl.to(dtype), num_leapfrog=n_leaves,
                              diverging=diverging, turning=turning, depth=depth, energy=-lp_p)
        return ChainState(z=z_p, logp=lp_p, grad=g_p), info


# ---------------------------------------------------------------------------
# Sampler driver: windowed warmup + collection, many chains
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """State carried between transitions."""

    chains: ChainState  # batched over chains (C, ...)
    da: adapt.DualAveragingState
    welford: adapt.WelfordState
    inv_mass: torch.Tensor
    step_size: torch.Tensor
    generator: torch.Generator | None


class NUTSResult(NamedTuple):
    positions: torch.Tensor  # (num_samples, C, D)
    log_probs: torch.Tensor  # (num_samples, C)
    accept_prob: torch.Tensor  # (num_samples, C)
    num_leapfrog: torch.Tensor  # (num_samples, C)
    diverging: torch.Tensor  # (num_samples, C) bool
    step_size: torch.Tensor
    inv_mass: torch.Tensor
    final: SamplerState


def _default_reduce_mean(x):
    return torch.mean(x)


def _default_reduce_welford(w):
    return w


def init_sampler_state(log_density, init_position, generator, init_step_size=0.1) -> SamplerState:
    """Batched init: ``init_position`` has shape (C, D)."""
    chains = init_chain(log_density, init_position)
    dim = init_position.shape[-1]
    like = dict(dtype=init_position.dtype, device=init_position.device)
    step = torch.as_tensor(init_step_size, **like)
    return SamplerState(chains=chains, da=adapt.da_init(step),
                        welford=adapt.welford_init(dim, **like),
                        inv_mass=torch.ones((dim,), **like), step_size=step,
                        generator=generator)


def warmup_step(log_density, state: SamplerState, flags: dict, step: int, *, max_depth=10,
                target_accept=0.8, max_delta_energy=1000.0,
                reduce_mean=_default_reduce_mean, reduce_welford=_default_reduce_welford):
    """Adaptive warmup step ``step`` over all (local) chains; ``flags`` is
    ``adapt.build_warmup_schedule``'s dict.  ``reduce_mean`` and
    ``reduce_welford`` are the pooling hooks: the local mean and the
    identity by default; ``parallel/sharded.py`` passes collectives, so the
    chains of every rank adapt as one population."""
    step_size = torch.exp(state.da.log_step)
    chains, info = nuts_transition(log_density, state.chains, state.generator, step_size,
                                   state.inv_mass, max_depth, max_delta_energy)
    da = adapt.da_update(state.da, reduce_mean(info.accept_prob), target_accept=target_accept)
    welford, da, inv_mass = adapt.adapt_window(state.welford, da, state.inv_mass, chains.z,
                                               flags, step, reduce_welford)
    # final warmup step: freeze the averaged step size
    step_out = torch.exp(da.log_avg_step if flags["last"][step] else da.log_step)
    return SamplerState(chains=chains, da=da, welford=welford, inv_mass=inv_mass,
                        step_size=step_out, generator=state.generator), info


def sample_step(log_density, state: SamplerState, *, max_depth=10, max_delta_energy=1000.0):
    """One non-adaptive collection step over all chains."""
    chains, info = nuts_transition(log_density, state.chains, state.generator, state.step_size,
                                   state.inv_mass, max_depth, max_delta_energy)
    return dataclasses.replace(state, chains=chains), info


def collect(log_density, state: SamplerState, num_samples: int, *, max_depth: int = 10,
            max_delta_energy: float = 1000.0) -> NUTSResult:
    """Non-adaptive collection of ``num_samples`` >= 1 draws from an
    existing ``SamplerState``, the checkpoint/resume entry point: a state
    saved with ``utils.save_pytree`` and loaded back continues bit for bit."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    zs, lps, accs, nls, divs = [], [], [], [], []
    for _ in range(num_samples):
        state, info = sample_step(log_density, state, max_depth=max_depth,
                                  max_delta_energy=max_delta_energy)
        zs.append(state.chains.z)
        lps.append(state.chains.logp)
        accs.append(info.accept_prob)
        nls.append(info.num_leapfrog)
        divs.append(info.diverging)
    return NUTSResult(positions=torch.stack(zs), log_probs=torch.stack(lps),
                      accept_prob=torch.stack(accs), num_leapfrog=torch.stack(nls),
                      diverging=torch.stack(divs), step_size=state.step_size,
                      inv_mass=state.inv_mass, final=state)


def continue_warmup(log_density, state: SamplerState, num_warmup: int, *, start: int = 0,
                    stop: int | None = None, max_depth: int = 10, target_accept: float = 0.8,
                    max_delta_energy: float = 1000.0, reduce_mean=_default_reduce_mean,
                    reduce_welford=_default_reduce_welford, init_buffer: int = 75,
                    first_window: int = 25, term_buffer: int = 50) -> SamplerState:
    """Steps [start, stop) of the warmup schedule of ``num_warmup`` steps
    from ``state``: a warmup checkpointed after ``start`` steps resumes here
    bit for bit, given the same buffers.  ``init_buffer``, ``first_window``
    and ``term_buffer`` shape the schedule (``adapt.build_warmup_schedule``;
    the defaults are the JAX package's): a warmup shorter than their sum
    adapts the step size alone."""
    flags = adapt.build_warmup_schedule(num_warmup, init_buffer=init_buffer,
                                        term_buffer=term_buffer, first_window=first_window)
    stop = num_warmup if stop is None else stop
    for step in range(start, stop):
        state, _ = warmup_step(log_density, state, flags, step, max_depth=max_depth,
                               target_accept=target_accept, max_delta_energy=max_delta_energy,
                               reduce_mean=reduce_mean, reduce_welford=reduce_welford)
    return state


def warmup(log_density, init_position, generator, num_warmup: int = 500, *,
           max_depth: int = 10, target_accept: float = 0.8, init_step_size: float = 0.1,
           max_delta_energy: float = 1000.0, reduce_mean=_default_reduce_mean,
           reduce_welford=_default_reduce_welford) -> SamplerState:
    """Run the adaptive warmup alone; pair with ``collect`` to sample."""
    state = init_sampler_state(log_density, init_position, generator, init_step_size)
    return continue_warmup(log_density, state, num_warmup, max_depth=max_depth,
                           target_accept=target_accept, max_delta_energy=max_delta_energy,
                           reduce_mean=reduce_mean, reduce_welford=reduce_welford)


def sample_nuts(log_density, init_position, generator=None, num_warmup: int = 500,
                num_samples: int = 1000, *, max_depth: int = 10, target_accept: float = 0.8,
                init_step_size: float = 0.1, max_delta_energy: float = 1000.0,
                reduce_mean=_default_reduce_mean,
                reduce_welford=_default_reduce_welford) -> NUTSResult:
    """Windowed-warmup NUTS over C chains.

    Args:
      log_density: a ``gp_model`` log density, or a function of (C, D)
        positions returning (C,) log densities (differentiated by autograd).
      init_position: (C, D) initial positions (C chains).
      generator: the source of every random draw (None: the global one).
      reduce_mean, reduce_welford: the warmup's pooling hooks
        (``warmup_step``).
    """
    state = warmup(log_density, init_position, generator, num_warmup, max_depth=max_depth,
                   target_accept=target_accept, init_step_size=init_step_size,
                   max_delta_energy=max_delta_energy, reduce_mean=reduce_mean,
                   reduce_welford=reduce_welford)
    return collect(log_density, state, num_samples, max_depth=max_depth,
                   max_delta_energy=max_delta_energy)
