"""Port warmup adaptation (inference/adaptation.py) against the JAX package:
dual averaging, Welford (batch and merge) and the warmup schedule, with the
default buffers and with explicit ones, on the same inputs, float64, to
1e-12; and a whole buffered NUTS warmup (``nuts.continue_warmup`` and the
chain-sharded ``warmup_nuts_sharded`` at one rank) against the JAX
package's ``warmup_step`` fed the same schedule, with the tree replaced on
both sides by one deterministic move, so that every step's adaptation
state can be compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_processes_tpu.inference import adaptation as ja
from gaussian_processes_tpu.inference import nuts as jnuts
from gaussian_processes_tpu_torch import parallel as tpar
from gaussian_processes_tpu_torch.inference import adaptation as ta
from gaussian_processes_tpu_torch.inference import nuts as tnuts
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

TOL = 1e-12


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_dual_averaging_matches_jax():
    accepts = np.random.default_rng(0).uniform(0.0, 1.0, 30)
    js, ts = ja.da_init(jnp.asarray(0.1)), ta.da_init(torch.tensor(0.1, dtype=torch.float64))
    for i, a in enumerate(accepts):
        js = ja.da_update(js, jnp.asarray(a), target_accept=0.651)
        ts = ta.da_update(ts, torch.tensor(a, dtype=torch.float64), target_accept=0.651)
        for field in ("log_step", "log_avg_step", "avg_error", "mu"):
            _close(getattr(ts, field), getattr(js, field))
        assert ts.count == int(js.count) == i + 1
    js, ts = ja.da_restart(js, jnp.exp(js.log_step)), ta.da_restart(ts, torch.exp(ts.log_step))
    _close(ts.mu, js.mu)
    assert ts.count == 0


def test_welford_batch_merge_and_variance_match_jax():
    rng = np.random.default_rng(1)
    batches = [rng.normal(2.0, 3.0, (8, 3)) for _ in range(5)]
    js, ts = ja.welford_init(3, jnp.float64), ta.welford_init(3, torch.float64)
    for b in batches:
        js = ja.welford_update_batch(js, jnp.asarray(b))
        ts = ta.welford_update_batch(ts, torch.as_tensor(b))
        _close(ts.mean, js.mean)
        _close(ts.m2, js.m2)
        _close(ts.count, js.count)
    for reg in (True, False):
        _close(ta.welford_variance(ts, regularize=reg), ja.welford_variance(js, regularize=reg))
    # merging two accumulators equals folding all draws into one
    other = ta.welford_update_batch(ta.welford_init(3, torch.float64),
                                    torch.as_tensor(np.concatenate(batches[:2])))
    merged = ta.welford_merge(other, ta.welford_update_batch(
        ta.welford_init(3, torch.float64), torch.as_tensor(np.concatenate(batches[2:]))))
    jm = ja.welford_merge(
        ja.welford_update_batch(ja.welford_init(3, jnp.float64), jnp.asarray(np.concatenate(batches[:2]))),
        ja.welford_update_batch(ja.welford_init(3, jnp.float64), jnp.asarray(np.concatenate(batches[2:]))))
    _close(merged.mean, jm.mean)
    _close(merged.m2, jm.m2)
    _close(merged.mean, js.mean)
    _close(merged.m2, js.m2)


def _buffers(init_buffer, first_window, term_buffer):
    return dict(init_buffer=init_buffer, first_window=first_window, term_buffer=term_buffer)


# (num_warmup, buffers): the defaults, then explicit buffers: config #5's
# cell (60 = 10 / 40 / 10), the CPU tests' (40 = 5 / 10 / 5), the cell's
# fallback (100 = 15 / 60 / 25), one step short of a window (59), and a
# long warmup of several doubling windows
SCHEDULES = ([pytest.param(n, {}, id=str(n)) for n in (0, 100, 150, 500, 1000)]
             + [pytest.param(n, _buffers(*b), id=f"{n}-{b[0]}-{b[1]}-{b[2]}")
                for n, b in ((60, (10, 40, 10)), (40, (5, 10, 5)), (100, (15, 60, 25)),
                             (59, (10, 40, 10)), (500, (30, 20, 40)))])


@pytest.mark.parametrize("num_warmup,buffers", SCHEDULES)
def test_warmup_schedule_matches_jax(num_warmup, buffers):
    got = ta.build_warmup_schedule(num_warmup, **buffers)
    want = ja.build_warmup_schedule(num_warmup, **buffers)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def _move(z, grad, step_size, inv_mass, xp):
    """The stand-in for a NUTS transition: a contraction of the position
    towards its chain's starting gradient, scaled by the inverse mass, and
    an acceptance that falls with the step size."""
    z = 0.5 * z + 0.3 * grad * xp.sqrt(inv_mass) + 0.1 * xp.sin(z)
    return z, 1.0 / (1.0 + step_size * (z * z).sum(-1))


def _jax_transition(log_prob_fn, cs, key, step_size, inv_mass, max_depth, max_delta_energy):
    z, accept = _move(cs.z, cs.grad, step_size, inv_mass, jnp)
    zero = jnp.zeros_like(accept)
    return jnuts.ChainState(z, cs.logp, cs.grad), jnuts.TransitionInfo(accept, *[zero] * 5)


def _torch_transition(log_density, chains, generator, step_size, inv_mass, max_depth,
                      max_delta_energy):
    z, accept = _move(chains.z, chains.grad, step_size, inv_mass, torch)
    zero = torch.zeros_like(accept)
    return tnuts.ChainState(z, chains.logp, chains.grad), tnuts.TransitionInfo(accept, *[zero] * 5)


@pytest.mark.parametrize("num_warmup,buffers", [
    pytest.param(150, {}, id="150-defaults"),
    pytest.param(60, _buffers(10, 40, 10), id="60-10-40-10"),
    pytest.param(40, _buffers(5, 10, 5), id="40-5-10-5"),
])
def test_buffered_warmup_adapts_as_the_jax_warmup_step(monkeypatch, num_warmup, buffers):
    monkeypatch.setattr(jnuts, "nuts_transition", _jax_transition)
    monkeypatch.setattr(tnuts, "nuts_transition", _torch_transition)
    init = np.random.default_rng(2).normal(0.0, 1.0, (16, 3))

    def logp(z, xp):
        return -0.5 * (((z - 0.4) / xp.asarray([1.0, 2.0, 0.5])) ** 2).sum(-1)

    js = jnuts.init_sampler_state(lambda z: logp(z, jnp), jnp.asarray(init),
                                  jax.random.PRNGKey(0), init_step_size=0.2)
    flags = ja.build_warmup_schedule(num_warmup, **buffers)
    assert bool(np.asarray(flags["window_end"]).any())
    t_init, t_logp = torch.as_tensor(init), lambda z: logp(z, torch)
    mesh = tpar.make_chain_mesh(device="cpu")
    ts = tnuts.init_sampler_state(t_logp, t_init, None, init_step_size=0.2)
    ss = tpar.init_nuts_sharded(t_logp, t_init, torch.Generator().manual_seed(0), mesh=mesh,
                                init_step_size=0.2)
    jax_step = jax.jit(lambda s, f: jnuts.warmup_step(None, s, f)[0])
    for step in range(num_warmup):
        js = jax_step(js, jax.tree.map(lambda a: a[step], flags))
        ts = tnuts.continue_warmup(None, ts, num_warmup, start=step, stop=step + 1, **buffers)
        ss = tpar.warmup_nuts_sharded(None, ss, num_warmup, mesh=mesh, start=step,
                                      stop=step + 1, **buffers)
        for got in (ts, ss):
            _close(got.chains.z, js.chains.z)
            for field in ("log_step", "log_avg_step", "avg_error", "mu"):
                _close(getattr(got.da, field), getattr(js.da, field))
            assert got.da.count == int(js.da.count), step
            _close(got.welford.mean, js.welford.mean)
            _close(got.welford.m2, js.welford.m2)
            _close(got.welford.count, js.welford.count)
            _close(got.inv_mass, js.inv_mass)
            _close(got.step_size, js.step_size)
    assert not np.allclose(np.asarray(js.inv_mass), 1.0)  # a window refreshed the mass
