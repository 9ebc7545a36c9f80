"""One NUTS or ChEES-HMC transition of C chains, written plainly.

A transition is random, so the reference replays it: from positions z, with
the step size, the diagonal inverse mass and a generator in the state the
sampler's generator had before the transition, it draws the same variates in
the same order (in the sampler's precision, on the generator's device, as
the sampler draws them), integrates in its own precision with its own log density, and
returns the new positions.  What is replayed is the semantics of the
program's samplers:

* NUTS: multinomial NUTS over C chains in lockstep; momenta first, then per
  depth a direction and a merge variate, per leaf a variate while any chain
  is live; leaves checkpointed at slot popcount(i) for even i, every complete
  sub-subtree ending at leaf i U-turn checked against its checkpoint,
  progressive multinomial sampling in the subtree, a biased swap into the
  tree, the cross-tree U-turn, divergence above ``max_delta_energy``.
* ChEES: one jitter variate u for all chains, u T / eps rounded up to the
  number of leapfrogs (1 to ``max_leapfrog``, in the sampler's precision as
  it does it), momenta, a uniform per chain, the trajectory, Metropolis.
"""

from __future__ import annotations

import math

import torch


def _draw(gen, fn, shape, dtype):
    return fn(shape, generator=gen, dtype=dtype, device=gen.device)


def _sel(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _kinetic(r, inv_mass):
    return 0.5 * torch.sum(inv_mass * r * r, dim=-1)


def _uturn(dz, r_a, r_b, inv_mass):
    return ((torch.sum(dz * inv_mass * r_a, -1) < 0) | (torch.sum(dz * inv_mass * r_b, -1) < 0))


def _leapfrog(vg, z, r, grad, eps, inv_mass):
    r = r + 0.5 * eps * grad
    z = z + eps * inv_mass * r
    logp, grad = vg(z)
    return z, r + 0.5 * eps * grad, logp, grad


def nuts_transition(vg, z, gen, step_size, inv_mass, max_depth, max_delta_energy=1000.0,
                    draw_dtype=torch.float32):
    """(new positions (C, D), acceptance (C,)) of one NUTS transition from
    z; the variates are drawn in ``draw_dtype``, the sampler's own
    precision.  The acceptance is the mean over the tree's leaves of
    min(1, exp(-energy change)), a non-finite leaf counting 0: the statistic
    that the step size's dual averaging drives to its target."""
    dt, dev, ddt = z.dtype, z.device, draw_dtype
    C, D = z.shape
    eps = torch.as_tensor(step_size).to(device=dev, dtype=dt)
    inv_mass = torch.as_tensor(inv_mass).to(device=dev, dtype=dt).expand(D)
    logp, grad = vg(z)
    r0 = _draw(gen, torch.randn, (C, D), ddt).to(device=dev, dtype=dt) / torch.sqrt(inv_mass)
    energy0 = -logp + _kinetic(r0, inv_mass)
    ends = {True: [z, r0, grad, logp], False: [z, -r0, grad, logp]}  # forward, backward
    prop = [z, logp, grad]
    log_w = torch.zeros_like(logp)
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_acc, n_leaves = torch.zeros_like(logp), torch.zeros_like(logp)
    for d in range(max_depth):
        active = ~turning & ~diverging
        if not bool(active.any()):
            break
        fwd = _draw(gen, torch.rand, (C,), ddt).to(dev) < 0.5
        merge = _draw(gen, torch.rand, (C,), ddt).to(device=dev, dtype=dt)
        edge = [_sel(fwd, a, b) for a, b in zip(ends[True], ends[False])]
        sub = _subtree(vg, d, edge, active, eps, inv_mass, energy0, max_depth,
                       max_delta_energy, gen, ddt)
        ok = active & ~sub["turning"] & ~sub["diverging"]
        for side, mask in ((True, ok & fwd), (False, ok & ~fwd)):
            ends[side] = [_sel(mask, a, b) for a, b in zip(sub["edge"], ends[side])]
        take = ok & (merge < torch.clamp(torch.exp(sub["log_w"] - log_w), max=1.0))
        prop = [_sel(take, a, b) for a, b in zip(sub["prop"], prop)]
        log_w = _sel(ok, torch.logaddexp(log_w, sub["log_w"]), log_w)
        z_f, r_f = ends[True][0], ends[True][1]
        z_b, r_b = ends[False][0], ends[False][1]
        cross = _uturn(z_f - z_b, -r_b, r_f, inv_mass)
        turning = turning | (active & sub["turning"]) | (ok & cross)
        diverging = diverging | (active & sub["diverging"])
        sum_acc, n_leaves = sum_acc + sub["sum_acc"], n_leaves + sub["n_leaves"]
    return prop[0], sum_acc / torch.clamp(n_leaves, min=1.0)


def _subtree(vg, depth, edge, active, eps, inv_mass, energy0, max_depth, max_delta_energy,
             gen, ddt):
    z0, r0, grad0, logp0 = edge
    C, D = z0.shape
    dt, dev = z0.dtype, z0.device
    s = {"edge": [z0, r0, grad0, logp0], "prop": [z0, logp0, grad0],
         "log_w": torch.full_like(logp0, -math.inf),
         "turning": torch.zeros_like(active), "diverging": torch.zeros_like(active),
         "sum_acc": torch.zeros_like(logp0), "n_leaves": torch.zeros_like(logp0)}
    ckpt_z = z0.new_zeros((C, max_depth + 1, D))
    ckpt_r = z0.new_zeros((C, max_depth + 1, D))
    for i in range(1 << depth):
        live = active & ~s["turning"] & ~s["diverging"]
        if not bool(live.any()):
            break
        u = _draw(gen, torch.rand, (C,), ddt).to(device=dev, dtype=dt)
        z_e, r_e, grad_e, _ = s["edge"]
        z, r, logp, grad = _leapfrog(vg, z_e, r_e, grad_e, eps, inv_mass)
        lw = energy0 - (-logp + _kinetic(r, inv_mass))
        diverging = ~(lw > -max_delta_energy)
        acc = torch.where(torch.isfinite(lw), torch.exp(torch.clamp(lw, max=0.0)),
                          torch.zeros_like(lw))
        s["sum_acc"] = s["sum_acc"] + torch.where(live, acc, torch.zeros_like(acc))
        s["n_leaves"] = s["n_leaves"] + live.to(acc.dtype)
        log_w = torch.logaddexp(s["log_w"], lw)
        take = live & (u < torch.exp(lw - log_w))
        s["prop"] = [_sel(take, a, b) for a, b in zip((z, logp, grad), s["prop"])]
        if i % 2 == 0:
            slot = bin(i).count("1")
            ckpt_z[:, slot] = _sel(live, z, ckpt_z[:, slot])
            ckpt_r[:, slot] = _sel(live, r, ckpt_r[:, slot])
        turning = s["turning"]
        k = 1
        while (i + 1) % (1 << k) == 0:
            slot = bin(i + 1 - (1 << k)).count("1")
            turning = turning | (live & _uturn(z - ckpt_z[:, slot], ckpt_r[:, slot], r, inv_mass))
            k += 1
        s["turning"] = turning
        s["edge"] = [_sel(live, a, b) for a, b in zip((z, r, grad, logp), s["edge"])]
        s["log_w"] = _sel(live, log_w, s["log_w"])
        s["diverging"] = s["diverging"] | (live & diverging)
    return s


def chees_n_leapfrog(u_jitter, traj_length, step_size, max_leapfrog) -> int:
    """ceil(u T / eps) clipped to [1, max_leapfrog], worked in the sampler's
    own precision, as it works it (a non-finite ratio takes one step)."""
    ratio = float(u_jitter * traj_length / step_size)
    if not math.isfinite(ratio):
        return 1
    return min(max(math.ceil(ratio), 1), max_leapfrog)


def chees_transition(vg, z, gen, step_size, traj_length, inv_mass, max_leapfrog):
    """(new positions (C, D), leapfrogs) of one fixed-settings ChEES-HMC
    transition; ``step_size`` and ``traj_length`` are the sampler's own
    tensors, whose dtype is the precision its variates are drawn in."""
    dt, dev, ddt = z.dtype, z.device, traj_length.dtype
    C, D = z.shape
    inv_mass = torch.as_tensor(inv_mass).to(device=dev, dtype=dt).expand(D)
    u_jitter = _draw(gen, torch.rand, (), ddt).to(traj_length.device)
    n_steps = chees_n_leapfrog(u_jitter, traj_length, step_size, max_leapfrog)
    eps = step_size.to(device=dev, dtype=dt)
    r0 = _draw(gen, torch.randn, (C, D), ddt).to(device=dev, dtype=dt) / torch.sqrt(inv_mass)
    u = _draw(gen, torch.rand, (C,), ddt).to(device=dev, dtype=dt)
    logp0, grad = vg(z)
    z1, r, logp = z, r0, logp0
    for _ in range(n_steps):
        z1, r, logp, grad = _leapfrog(vg, z1, r, grad, eps, inv_mass)
    log_accept = (-logp0 + _kinetic(r0, inv_mass)) - (-logp + _kinetic(r, inv_mass))
    finite = torch.isfinite(log_accept)
    accept = torch.where(finite, torch.exp(torch.clamp(log_accept, max=0.0)),
                         torch.zeros_like(log_accept))
    return _sel((u < accept) & finite, z1, z), n_steps
