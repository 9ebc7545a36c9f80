"""NUTS transitions of config #3's chains, in lockstep (``inference.nuts``).

Set-up: the first warmup transition (``continue_warmup`` up to step 1), then
the rest of ``num_warmup``; the window: ``sample_step`` back to back.
"""

from __future__ import annotations

import torch

from perfbench import sampling
from perfbench.reference import samplers


def setup(ctx):
    from gaussian_processes_tpu_torch.inference import nuts

    cfg, ncfg = ctx.config, ctx.config["nuts"]
    density, gen, init, _, _ = sampling.start(ctx)
    state = nuts.init_sampler_state(density, init, gen, cfg["init_step_size"])
    opts = dict(max_depth=ncfg["max_depth"], target_accept=ncfg["target_accept"])
    state = nuts.continue_warmup(density, state, cfg["num_warmup"], start=0, stop=1, **opts)
    first = {"z": state.chains.z,
             "replay": lambda vg, z, g: samplers.nuts_transition(
                 vg, z, g, torch.exp(torch.log(torch.tensor(cfg["init_step_size"],
                                                            dtype=torch.float32, device=z.device))),
                 1.0, ncfg["max_depth"])[0]}
    state = nuts.continue_warmup(density, state, cfg["num_warmup"], start=1, **opts)
    return {"density": sampling.start_window(ctx, density, gen), "gen": gen, "state": state,
            "first": first}


def call(ctx, st, i):
    from gaussian_processes_tpu_torch.inference import nuts

    g, z0 = st["gen"].get_state(), st["state"].chains.z
    st["state"], info = nuts.sample_step(st["density"], st["state"],
                                         max_depth=ctx.config["nuts"]["max_depth"])
    ctx.synchronize()
    z = st["state"].chains.z
    return sampling.record(g, z0, st["state"].chains, info.num_leapfrog.max(),
                           torch.isfinite(z).all())


def end_to_end(ctx, st, records, window_s):
    return {"ess_per_s": sampling.ess_per_s(records, window_s)}


def counters(ctx, st, records):
    return sampling.counters(st, records)


def release(ctx, st):
    """What the check keeps: the first warmup transition and the settings
    that the warmup left."""
    return {"first": st["first"], "step": st["state"].step_size,
            "inv_mass": st["state"].inv_mass}


def check(ctx, records, kept):
    """The sampled transitions against the reference's replays, and the
    adapted step size by the reference's mean acceptance, which the dual
    averaging drove to ``target_accept``."""
    ncfg = ctx.config["nuts"]

    def replay(vg, z0, gen, rec):
        return samplers.nuts_transition(vg, z0, gen, kept["step"], kept["inv_mass"],
                                        ncfg["max_depth"])

    return sampling.check(ctx, records, kept["first"], replay, ncfg["target_accept"])
