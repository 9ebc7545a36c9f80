"""ChEES-HMC transitions of config #3's chains (``inference.chees``).

Set-up: the first warmup transition (``chees_warmup`` up to step 1), then the
rest of ``num_warmup``; the window: ``chees_step`` without adaptation, the
step of ``chees_collect``, back to back.
"""

from __future__ import annotations

import torch

from perfbench import sampling
from perfbench.reference import samplers


def setup(ctx):
    from gaussian_processes_tpu_torch.inference import chees

    cfg, ccfg = ctx.config, ctx.config["chees"]
    density, gen, init, _, _ = sampling.start(ctx)
    state = chees.init_chees_state(density, init, gen, init_step_size=cfg["init_step_size"],
                                   init_traj_length=ccfg["init_traj_length"])
    opts = dict(target_accept=ccfg["target_accept"], max_leapfrog=ccfg["max_leapfrog"])
    step0, traj0 = torch.exp(state.da.log_step), state.traj_length
    state = chees.chees_warmup(density, state, cfg["num_warmup"], start=0, stop=1, **opts)
    first = {"z": state.chains.z,
             "replay": lambda vg, z, g: samplers.chees_transition(
                 vg, z, g, step0, traj0, 1.0, ccfg["max_leapfrog"])[0]}
    state = chees.chees_warmup(density, state, cfg["num_warmup"], start=1, **opts)
    return {"density": sampling.start_window(ctx, density, gen), "gen": gen, "state": state,
            "first": first}


def call(ctx, st, i):
    from gaussian_processes_tpu_torch.inference import chees

    g, z0 = st["gen"].get_state(), st["state"].chains.z
    st["state"], info = chees.chees_step(st["density"], st["state"], adapt_traj=False,
                                         max_leapfrog=ctx.config["chees"]["max_leapfrog"])
    ctx.synchronize()
    z = st["state"].chains.z
    return sampling.record(g, z0, st["state"].chains, info.num_leapfrog, torch.isfinite(z).all())


def end_to_end(ctx, st, records, window_s):
    return {"ess_per_s": sampling.ess_per_s(records, window_s)}


def counters(ctx, st, records):
    return sampling.counters(st, records)


def release(ctx, st):
    """What the check keeps: the first warmup transition and the settings
    that the warmup left."""
    s = st["state"]
    return {"first": st["first"], "step": s.step_size, "traj": s.traj_length,
            "inv_mass": s.inv_mass}


def check(ctx, records, kept):
    max_leapfrog = ctx.config["chees"]["max_leapfrog"]

    def replay(vg, z0, gen, rec):
        z, _ = samplers.chees_transition(vg, z0, gen, kept["step"], kept["traj"],
                                         kept["inv_mass"], max_leapfrog)
        return z, None

    return sampling.check(ctx, records, kept["first"], replay)
