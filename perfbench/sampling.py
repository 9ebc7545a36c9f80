"""What the two sampler cells of config #3 share.

Set-up builds the program's log posterior (``inference.make_log_posterior``)
on the configuration's data, the chains' starting points
(``inference.init_positions``) from a generator seeded by the
configuration's ``warmup_seed``, and runs the sampler's first warmup
transition, then the rest of the warmup: every run adapts to the same step
size, inverse mass and trajectory length, so every seed asks for the same
work.  The generator is then reseeded from the run's seed; each call of the
window is one transition of all chains, and every draw is kept.
``Counted`` wraps the log posterior to count the batched value+grad
evaluations (and, in a traced run, to mark each with a span).

The check, against ``reference/``: the log posterior and its gradient that
the program holds at the chains' new positions (a sample of transitions)
against float64, and the new positions themselves against the reference's
replay of each transition in float64, each by a quantile over the chains
and by a count of chains far off.  The replay of the first warmup
transition starts from the reference's own starting points; a window
transition starts from the positions, step size, inverse mass (and, for
ChEES, trajectory length) that the program's warmup left, which the
reference cannot work out again, and from the generator's state.  The
adapted settings are judged by the reference's acceptance in its replays,
against the target that the adaptation aimed at.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import data, ess
from perfbench.reference import arith as ar
from perfbench.reference.posterior import LogPosterior

GAP_QUANTILE = 0.9


class Counted:
    """A log density whose ``value_and_grad`` calls are counted."""

    def __init__(self, density, tracing: bool):
        self.density, self.tracing, self.calls = density, tracing, 0

    def value_and_grad(self, u):
        self.calls += 1
        if self.tracing:
            with torch.profiler.record_function("perfbench.value_and_grad"):
                return self.density.value_and_grad(u)
        return self.density.value_and_grad(u)


class _Float32:
    """The reference's log density in the program's place (the control)."""

    def __init__(self, ref: LogPosterior):
        self.ref = ref

    def value_and_grad(self, u):
        value, grad = self.ref.value_and_grad(u)
        return value.to(torch.float32), grad.to(torch.float32)


def problem(ctx):
    """(x, y) of the configuration, float32 on the device, and the kernel."""
    cfg = ctx.config
    x, y = data.make_data(cfg["n"], cfg["data_noise"], cfg["freq"], cfg["data_seed"],
                          cfg["x_lo"], cfg["x_hi"])
    dtype = getattr(torch, cfg["dtype"])
    x, y = (torch.as_tensor(a, dtype=dtype, device=ctx.device) for a in (x, y))
    return x, y, dtype


def start(ctx):
    """The program's log density (counted), generator and starting points."""
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.inference import init_positions, make_log_posterior

    cfg = ctx.config
    x, y, dtype = problem(ctx)
    kernel = GaussianKernel(cfg["h"], cfg["w"], dtype=dtype, device=ctx.device)
    density = make_log_posterior(kernel, x, y, prior_mean=cfg["prior_mean"],
                                 prior_std=cfg["prior_std"], jitter=cfg["jitter"])
    gen = torch.Generator(device=ctx.device).manual_seed(cfg["warmup_seed"])
    init = init_positions(kernel, cfg["noise"], gen, n_chains=cfg["n_chains"],
                          spread=cfg["init_spread"], dtype=dtype)
    return Counted(density, ctx.tracing), gen, init, x, y


def start_window(ctx, density: Counted, gen) -> Counted:
    """Reseed the sampler's generator from the run's seed and return the log
    density the window's transitions use: the program's, or for the control
    the reference's in ``ctx.control`` precision (the warmup, which is
    set-up, stays the program's)."""
    gen.manual_seed(data.derive_seed(ctx.seed, "chains"))
    if not ctx.control:
        density.calls = 0
        return density
    cfg = ctx.config
    x, y, _ = problem(ctx)
    ref = LogPosterior(x, y, cfg["prior_mean"], cfg["prior_std"], cfg["jitter"],
                       ar.arith(ctx.control), ctx.traffic["reference_block"])
    return Counted(_Float32(ref), ctx.tracing)


def reference_start(ctx, device):
    """The chains' starting points and the generator after drawing them,
    worked out by the reference from the warmup's seed: log(h, w, s) in
    float32 plus ``init_spread`` standard normals."""
    cfg = ctx.config
    gen = torch.Generator(device=device).manual_seed(cfg["warmup_seed"])
    u0 = torch.log(torch.tensor([cfg["h"], cfg["w"], cfg["noise"]], dtype=torch.float32,
                                device=device))
    eps = torch.randn((cfg["n_chains"], 3), generator=gen, dtype=torch.float32, device=device)
    return (u0[None, :] + cfg["init_spread"] * eps).double(), gen


def record(st_gen_state, z0, chains, leapfrog, finite_z):
    return {"gen": st_gen_state, "z0": z0, "z": chains.z, "logp": chains.logp,
            "grad": chains.grad, "leapfrog": leapfrog, "finite": finite_z}


def ess_per_s(records, window_s) -> float:
    draws = torch.stack([r["z"] for r in records]).double().cpu().numpy()
    return float(np.min(ess.ess(np.exp(draws))) / window_s)


def counters(st, records) -> dict:
    return {"transitions": len(records), "chains": int(records[0]["z"].shape[0]),
            "leapfrog_max": [float(r["leapfrog"]) for r in records],
            "evaluations": st["density"].calls}


def _stack(gaps: list) -> torch.Tensor:
    """(T, C) gaps of T compared transitions; NaN counts as infinitely far."""
    g = torch.stack(gaps)
    return torch.where(torch.isnan(g), torch.full_like(g, float("inf")), g)


def transition_gaps(ctx, records, first, replay) -> tuple:
    """({name: (T, C) gaps}, [acceptances (C,) or None]) over the first warmup
    transition (draws only) and a sample of the window's transitions drawn
    from the seed: ``first`` holds the program's positions after the first
    warmup transition and the reference's replay of it; ``replay(vg, z0,
    gen, rec)`` is the reference's transition of a window record: (new
    positions, acceptance or None)."""
    cfg = ctx.config
    x, y, _ = problem(ctx)
    ref = LogPosterior(x, y, cfg["prior_mean"], cfg["prior_std"], cfg["jitter"], ar.FLOAT64,
                       ctx.traffic["reference_block"])
    vg = ref.value_and_grad
    picked = data.sample_indices(ctx.seed, len(records), ctx.traffic["check_transitions"])
    gaps = {"logp_gap": [], "grad_gap": [], "draw_gap": []}
    accepts = []
    z_init, gen = reference_start(ctx, ctx.device)
    z_ref = first["replay"](vg, z_init, gen)
    gaps["draw_gap"].append(torch.max(torch.abs(first["z"].double() - z_ref), dim=-1).values)
    for i in picked:
        rec = records[i]
        value, grad = vg(rec["z"].double())
        gaps["logp_gap"].append(torch.abs(rec["logp"].double() - value))
        gaps["grad_gap"].append(torch.max(torch.abs(rec["grad"].double() - grad), dim=-1).values)
        gen = torch.Generator(device=ctx.device)
        gen.set_state(rec["gen"])
        z_ref, accept = replay(vg, rec["z0"].double(), gen, rec)
        accepts.append(accept)
        gaps["draw_gap"].append(torch.max(torch.abs(rec["z"].double() - z_ref), dim=-1).values)
    return {name: _stack(g) for name, g in gaps.items()}, accepts


def judge(gaps: dict, accept_gap: float | None, traffic: dict) -> list:
    """[(name, value, limit)]: for each gap, its ``GAP_QUANTILE`` quantile
    over every compared chain transition (a widest gap swings from seed to
    seed by float32's nature, while the control's gaps are wide on every
    chain), and ``<gap>_chains``, the number of chains whose widest
    compared gap passes the wider per-chain limit ``chain_limits``: a
    fault confined to a few chains passes the quantile, not this count;
    then ``accept_gap`` where there is one."""
    from perfbench.harness import log

    lim, chain_lim = traffic["limits"], traffic["chain_limits"]
    out = []
    for name, g in gaps.items():
        q = float(torch.quantile(g.flatten(), GAP_QUANTILE))
        widest = g.max(dim=0).values
        over = int((widest > chain_lim[name]).sum())
        log(f"{name} over {g.numel()} chain transitions: median {float(g.median())!r}, "
            f"q{GAP_QUANTILE} {q!r}, max {float(widest.max())!r}; {over} chains over "
            f"{chain_lim[name]!r}")
        out.append((name, q, lim[name]))
        out.append((name.replace("_gap", "_chains"), float(over), float(traffic["chain_count"])))
    if accept_gap is not None:
        out.append(("accept_gap", accept_gap, lim["accept_gap"]))
    return out


def check(ctx, records, first, replay, target_accept=None):
    """[(name, value, limit)] of ``judge``: the gaps of ``transition_gaps``
    and, given ``target_accept``, ``accept_gap``: how far the reference's
    acceptance, averaged over the chains and the sampled transitions, lies
    from the target that the step size's dual averaging aimed at.  The
    replays start from the step size and inverse mass that the program's
    warmup adapted, which the reference cannot work out again; this number
    judges them by the reference's own acceptance."""
    gaps, accepts = transition_gaps(ctx, records, first, replay)
    if target_accept is None:
        return judge(gaps, None, ctx.traffic)
    accepts = torch.stack(accepts)
    mean = float(accepts.mean())
    from perfbench.harness import log

    log(f"reference acceptance, mean over {accepts.shape[0]} transitions of "
        f"{accepts.shape[1]} chains: {mean!r} (target {target_accept!r})")
    return judge(gaps, abs(mean - target_accept), ctx.traffic)
