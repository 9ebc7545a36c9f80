"""NUTS transitions of config #5's chains through the chain-sharded stages.

The program's ``parallel.init_nuts_sharded``, ``warmup_nuts_sharded``,
``collect_nuts_sharded`` and ``checkpoint_nuts_sharded`` on a mesh of one
rank without a process group, as the CLI runs ``config5_nuts_sharded`` on a
one-card machine: every chain on the card, each collective the identity.

Set-up: the log posterior and starting points of ``sampling.start``, the
rank's state (its generator derived from the warmup's generator), the first
warmup transition, then the rest of ``num_warmup`` with the configuration's
``warmup_buffers``; the rank's generator is then reseeded from the run's
seed.  The window: ``collect_nuts_sharded`` of one transition of every
chain a call, every draw kept, and after every ``chunk_size``-th call the
state written to its checkpoint file in a temporary directory and read back.

The check is ``sampling``'s with two changes for the chain count.  The log
posterior and its gradient are compared on every chain.  The replays of the
first warmup transition (from the reference's own starting points and rank
generator) and of the sampled window transitions follow ``replay_chains``
chains drawn from the seed (``reference.sharded.on_rows``): the reference
still draws every variate for all chains, so each followed chain sees the
variates the program drew for it.  A replay starts from the state its call
was handed, so it cannot see a fault in the checkpoint's round trip; the
check therefore also counts ``handoff_breaks``, the calls whose state
(positions, log densities, gradients, step size, inverse mass and the
rank's generator) is not bit for bit the state the call before it left,
and allows none.

``counters`` hands the per-layer readers ``sampling.counters`` (transitions,
chains, each transition's largest leapfrog count, the log posterior's
evaluations), the window's rows of the batched value+grad, counted by the
program (``core.rows``; None where the program has no such counter), and the
chains' leapfrogs summed over the window.
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch

from perfbench import data, sampling
from perfbench.reference import arith as ar
from perfbench.reference import samplers
from perfbench.reference import sharded as sharded_ref
from perfbench.reference.posterior import LogPosterior

ROWS_COUNTER = "core.rows"


def _counts():
    from gaussian_processes_tpu_torch.utils.profiling import counts

    return counts


def setup(ctx):
    from gaussian_processes_tpu_torch import parallel

    cfg, ncfg = ctx.config, ctx.config["nuts"]
    density, gen, init, _, _ = sampling.start(ctx)
    mesh = parallel.make_chain_mesh(device=ctx.device)
    state = parallel.init_nuts_sharded(density, init, gen, mesh=mesh,
                                       init_step_size=cfg["init_step_size"])
    opts = dict(mesh=mesh, max_depth=ncfg["max_depth"], target_accept=ncfg["target_accept"],
                **cfg["warmup_buffers"])
    state = parallel.warmup_nuts_sharded(density, state, cfg["num_warmup"], stop=1, **opts)
    first = state.chains.z
    state = parallel.warmup_nuts_sharded(density, state, cfg["num_warmup"], start=1, **opts)
    window_density = sampling.start_window(ctx, density, state.generator)
    tmp = tempfile.mkdtemp(prefix="perfbench_config5_")
    return {"density": window_density, "state": state, "mesh": mesh, "first": first,
            "tmp": tmp, "checkpoint": f"{tmp}/state.npz",
            "rows0": _counts().get(ROWS_COUNTER)}


def _handoff(state) -> dict:
    """What a call hands the next: the chains, the adapted settings and the
    rank's generator (its state copied now, since it is drawn in place)."""
    c = state.chains
    return {"z": c.z, "logp": c.logp, "grad": c.grad, "step": state.step_size,
            "inv_mass": state.inv_mass, "gen": state.generator.get_state()}


def call(ctx, st, i):
    from gaussian_processes_tpu_torch import parallel

    handed = _handoff(st["state"])
    res = parallel.collect_nuts_sharded(st["density"], st["state"], 1, mesh=st["mesh"],
                                        max_depth=ctx.config["nuts"]["max_depth"])
    left = _handoff(res.final)
    st["state"] = res.final
    if (i + 1) % ctx.config["chunk_size"] == 0:
        st["state"] = parallel.checkpoint_nuts_sharded(res.final, st["checkpoint"], st["mesh"])
    ctx.synchronize()
    chains = res.final.chains
    rec = sampling.record(handed["gen"], handed["z"], chains, res.num_leapfrog.max(),
                          torch.isfinite(chains.z).all())
    rec.update(live=res.num_leapfrog.sum(), handed=handed, left=left)
    return rec


def end_to_end(ctx, st, records, window_s):
    return {"ess_per_s": sampling.ess_per_s(records, window_s)}


def counters(ctx, st, records):
    counts = _counts()
    rows = (counts[ROWS_COUNTER] - (st["rows0"] or 0)) if ROWS_COUNTER in counts else None
    return {**sampling.counters(st, records), "core_rows": rows,
            "live_rows": sum(int(r["live"]) for r in records)}


def release(ctx, st):
    """What the check keeps: the first warmup transition and the settings
    that the warmup left; the checkpoint's directory goes."""
    shutil.rmtree(st["tmp"], ignore_errors=True)
    s = st["state"]
    return {"first": st["first"], "step": s.step_size, "inv_mass": s.inv_mass}


def replay_rows(ctx) -> torch.Tensor:
    """The ``replay_chains`` chains the replays follow, drawn from the seed."""
    n, k = ctx.config["n_chains"], ctx.traffic["replay_chains"]
    rng = np.random.default_rng(data.derive_seed(ctx.seed, "check", 1))
    return torch.as_tensor(np.sort(rng.choice(n, size=min(k, n), replace=False)))


def handoff_breaks(records) -> int:
    """The calls whose state is not, bit for bit, the state the call before
    left: a checkpoint's round trip (or anything between two calls) that
    moved the chains, the settings or the generator."""
    def same(a, b):
        return all(a[k].shape == b[k].shape and torch.equal(a[k], b[k]) for k in a)

    return sum(not same(a["left"], b["handed"]) for a, b in zip(records, records[1:]))


def check(ctx, records, kept):
    """The gaps of ``sampling.judge`` over the first warmup transition and a
    sample of the window's, ``accept_gap``: the reference's acceptance over
    the followed chains of the replayed window transitions against
    ``target_accept``, and ``handoff_breaks`` (none allowed)."""
    from perfbench.harness import log

    cfg, ncfg = ctx.config, ctx.config["nuts"]
    x, y, _ = sampling.problem(ctx)
    ref = LogPosterior(x, y, cfg["prior_mean"], cfg["prior_std"], cfg["jitter"], ar.FLOAT64,
                       ctx.traffic["reference_block"])
    rows = replay_rows(ctx).to(ctx.device)
    vg_rows = sharded_ref.on_rows(ref.value_and_grad, rows)
    gaps = {"logp_gap": [], "grad_gap": [], "draw_gap": []}

    z_init, gen = sampling.reference_start(ctx, ctx.device)
    gen = sharded_ref.rank_generator(gen, 0, ctx.device)
    step0 = torch.exp(torch.log(torch.tensor(cfg["init_step_size"], dtype=torch.float32,
                                             device=ctx.device)))
    z_ref, _ = samplers.nuts_transition(vg_rows, z_init, gen, step0, 1.0, ncfg["max_depth"])
    gaps["draw_gap"].append(_widest(kept["first"][rows].double() - z_ref[rows]))

    accepts = []
    for i in data.sample_indices(ctx.seed, len(records), ctx.traffic["check_transitions"]):
        rec = records[i]
        value, grad = ref.value_and_grad(rec["z"].double())
        gaps["logp_gap"].append(torch.abs(rec["logp"].double() - value))
        gaps["grad_gap"].append(_widest(rec["grad"].double() - grad))
        gen = torch.Generator(device=ctx.device)
        gen.set_state(rec["gen"])
        z_ref, accept = samplers.nuts_transition(vg_rows, rec["z0"].double(), gen, kept["step"],
                                                 kept["inv_mass"], ncfg["max_depth"])
        gaps["draw_gap"].append(_widest(rec["z"][rows].double() - z_ref[rows]))
        accepts.append(accept[rows])
    mean = float(torch.stack(accepts).mean())
    log(f"reference acceptance, mean over {len(accepts)} transitions of {rows.numel()} "
        f"followed chains: {mean!r} (target {ncfg['target_accept']!r})")
    stacked = {name: sampling._stack(g) for name, g in gaps.items()}
    breaks = handoff_breaks(records)
    log(f"handoffs: {breaks} of {len(records) - 1} calls not handed the state the call "
        f"before left")
    return (sampling.judge(stacked, abs(mean - ncfg["target_accept"]), ctx.traffic)
            + [("handoff_breaks", float(breaks), 0.0)])


def _widest(diff: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(diff), dim=-1).values
