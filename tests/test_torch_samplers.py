"""Port samplers (inference/nuts.py, inference/chees.py) against the JAX
package and against analytic targets.

The helpers the two packages share (leapfrog, kinetic energy, U-turn
criterion, ChEES's NaN-safe gradient) agree with the JAX functions chain by
chain on the same inputs, float64, to 1e-12.  The port draws its random
numbers from a ``torch.Generator`` (the JAX package splits keys), so whole
runs are held to the target instead: the mean and covariance of a
correlated 2-D Gaussian within 4 Monte-Carlo standard errors over 8 chains,
a learned mass matrix, determinism under a seeded generator, and a
divergent step that leaves the state finite.  A NUTS leaf evaluates the log
density on its live chains alone: on config #3's posterior a transition is
bit for bit the one that evaluates every chain at every leaf, and the log
density sees exactly the rows of the chains' leapfrogs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_processes_tpu.inference import chees as jchees
from gaussian_processes_tpu.inference import nuts as jnuts
from gaussian_processes_tpu_torch import GaussianKernel
from gaussian_processes_tpu_torch.inference import chees as tchees
from gaussian_processes_tpu_torch.inference import diagnostics as td
from gaussian_processes_tpu_torch.inference import make_log_posterior
from gaussian_processes_tpu_torch.inference import nuts as tnuts
from gaussian_processes_tpu_torch.utils.config import DataConfig, make_data
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

MEAN = np.array([1.0, -2.0])
COV = np.array([[1.0, 0.8], [0.8, 2.0]])
PREC = np.linalg.inv(COV)


def _logp_torch(z):
    d = z - torch.as_tensor(MEAN)
    return -0.5 * torch.einsum("ci,ij,cj->c", d, torch.as_tensor(PREC), d)


def _logp_jax(z):
    d = z - MEAN
    return -0.5 * d @ PREC @ d


def _chains(C=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (C, 2)), rng.normal(0, 1, (C, 2)), rng.uniform(0.5, 2.0, 2)


def test_leapfrog_kinetic_and_uturn_match_jax():
    z, r, inv_mass = _chains()
    vg = tnuts.value_and_grad_fn(_logp_torch)
    _, grad = vg(torch.as_tensor(z))
    got = tnuts._leapfrog(vg, torch.as_tensor(z), torch.as_tensor(r), grad, 0.3,
                          torch.as_tensor(inv_mass))
    kin = tnuts._kinetic(torch.as_tensor(r), torch.as_tensor(inv_mass))
    dz = np.random.default_rng(1).normal(0, 1, z.shape)
    turn = tnuts._uturn(torch.as_tensor(dz), torch.as_tensor(r), torch.as_tensor(-r[::-1].copy()),
                        torch.as_tensor(inv_mass))
    for c in range(z.shape[0]):
        g = jax.grad(_logp_jax)(jnp.asarray(z[c]))
        want = jnuts._leapfrog(_logp_jax, jnp.asarray(z[c]), jnp.asarray(r[c]), g, 0.3,
                               jnp.asarray(inv_mass))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[c].numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(kin[c]), float(jnuts._kinetic(r[c], inv_mass)),
                                   rtol=1e-12)
        assert bool(turn[c]) == bool(jnuts._uturn(dz[c], r[c], -r[::-1][c], inv_mass))


def test_chees_nan_safe_gradient_matches_jax():
    rng = np.random.default_rng(2)
    z0, z1, v1 = (rng.normal(0, 1, (8, 3)) for _ in range(3))
    accept = rng.uniform(0, 1, 8)
    z1[3, 1] = np.nan  # a blown-up lane contributes zero
    v1[5, 0] = np.inf
    accept[3] = accept[5] = 0.0
    got = tchees._chees_grad(*(torch.as_tensor(a) for a in (z0, z1, v1, accept)),
                             torch.tensor(0.37, dtype=torch.float64))
    want = jchees._chees_grad(z0, z1, v1, accept, 0.37, jnp.mean,
                              lambda x: jnp.mean(x, axis=0))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    # an all-NaN batch gives 0, not NaN
    got = tchees._chees_grad(*(torch.as_tensor(a) for a in (z0, np.full_like(z1, np.nan), v1,
                                                            np.zeros(8))),
                             torch.tensor(0.5, dtype=torch.float64))
    assert float(got) == 0.0


def _transition(seed):
    z = torch.as_tensor(_chains(seed=3)[0])
    state = tnuts.init_chain(_logp_torch, z)
    return tnuts.nuts_transition(_logp_torch, state, torch.Generator().manual_seed(seed), 0.4,
                                 torch.ones(2, dtype=torch.float64), max_depth=6)


def test_nuts_transition_is_deterministic_under_a_seeded_generator():
    (s1, i1), (s2, i2), (s3, _) = _transition(5), _transition(5), _transition(6)
    for a, b in zip(s1 + i1, s2 + i2):
        assert torch.equal(a, b)
    assert not torch.equal(s1.z, s3.z)
    assert bool((i1.num_leapfrog >= 1).all()) and bool((i1.depth >= 1).all())
    assert bool(((i1.accept_prob >= 0) & (i1.accept_prob <= 1)).all())


def test_huge_step_diverges_and_keeps_the_state_finite():
    z = torch.as_tensor(_chains(seed=4)[0])
    state = tnuts.init_chain(_logp_torch, z)
    new, info = tnuts.nuts_transition(_logp_torch, state, torch.Generator().manual_seed(0),
                                      1e4, torch.ones(2, dtype=torch.float64))
    assert bool(info.diverging.all())
    assert torch.equal(new.z, z) and bool(torch.isfinite(new.logp).all())
    assert bool((info.num_leapfrog == 1).all())


def _moments_within_mc_error(positions):
    draws = positions.numpy()
    flat = draws.reshape(-1, 2)
    ess = td.ess(draws)
    assert np.all(td.split_rhat(draws) < 1.05)
    se_mean = np.sqrt(np.diag(COV) / ess)
    assert np.all(np.abs(flat.mean(0) - MEAN) < 4 * se_mean), (flat.mean(0), se_mean)
    cov = np.cov(flat.T)
    n = ess.min()
    se_cov = np.sqrt((np.outer(np.diag(COV), np.diag(COV)) + COV ** 2) / n)
    assert np.all(np.abs(cov - COV) < 4 * se_cov), (cov, se_cov)


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_samplers_reproduce_a_correlated_gaussian(sampler):
    init = torch.as_tensor(np.random.default_rng(5).normal(0, 1, (8, 2)))
    gen = torch.Generator().manual_seed(11)
    if sampler == "nuts":
        res = tnuts.sample_nuts(_logp_torch, init, gen, num_warmup=200, num_samples=400,
                                max_depth=6)
        assert res.num_leapfrog.shape == (400, 8)
    else:
        res = tchees.sample_chees(_logp_torch, init, gen, num_warmup=200, num_samples=400)
        assert res.num_leapfrog.shape == (400,) and float(res.traj_length) > 0
    assert res.positions.shape == (400, 8, 2) and not bool(res.diverging.any())
    _moments_within_mc_error(res.positions)


def test_warmup_learns_the_mass_matrix():
    scales = np.array([0.1, 10.0])

    def logp(z):
        return -0.5 * torch.sum((z / torch.as_tensor(scales)) ** 2, dim=-1)

    init = torch.as_tensor(np.random.default_rng(6).normal(0, 1, (8, 2)) * scales)
    state = tnuts.warmup(logp, init, torch.Generator().manual_seed(1), num_warmup=200,
                         max_depth=8)
    ratio = state.inv_mass.numpy() / scales ** 2
    assert np.all((ratio > 0.5) & (ratio < 2.0)), ratio
    assert float(state.step_size) > 0.1  # a unit-scale step once the metric is learned


#: config #3's posterior at its warmed-up inverse mass, and a step at which
#: 12 chains started near its mode build trees of depths 1 to 4
CONFIG3_INV_MASS = (0.17172, 0.022151, 0.0010110)
CONFIG3_MODE = (1.73089, 1.16281, 0.0938252)


def _config3_transition(seed, density=None):
    """(state, info) of one float64 NUTS transition of 12 chains on config
    #3's posterior (``density`` in its place if given), max_depth 6."""
    x, y, _ = make_data(DataConfig(n=500))
    lp = make_log_posterior(GaussianKernel(1.0, 1.0, dtype=torch.float64), torch.as_tensor(x),
                            torch.as_tensor(y), prior_std=1.5, jitter=1e-6)
    inv_mass = torch.tensor(CONFIG3_INV_MASS, dtype=torch.float64)
    gen = torch.Generator().manual_seed(seed)
    z = (torch.log(torch.tensor(CONFIG3_MODE, dtype=torch.float64))
         + torch.randn((12, 3), generator=gen, dtype=torch.float64) * inv_mass.sqrt())
    density = lp if density is None else density(lp)
    return tnuts.nuts_transition(density, tnuts.init_chain(lp, z), gen, 0.3, inv_mass,
                                 max_depth=6)


class _RowSpy:
    """A log density that keeps every batch of positions it is handed."""

    def __init__(self, density):
        self.density, self.batches = density, []

    def value_and_grad(self, u):
        self.batches.append(u.clone())
        return self.density.value_and_grad(u)


@pytest.mark.parametrize("seed", [0, 1])
def test_live_chain_leaves_match_full_width_leaves_bit_for_bit(monkeypatch, seed):
    state, info = _config3_transition(seed)
    assert int(info.num_leapfrog.min()) < int(info.num_leapfrog.max())  # trees end apart
    monkeypatch.setattr(tnuts, "_live_value_and_grad", lambda vg, z, *_: vg(z))
    full_state, full_info = _config3_transition(seed)
    for a, b in zip(state + info, full_state + full_info):
        assert torch.equal(a, b)


def _ordered_rows_of(sub, full) -> bool:
    """Whether the rows of ``sub`` are rows of ``full``, in the same order."""
    j = 0
    for row in sub:
        while j < len(full) and not torch.equal(full[j], row):
            j += 1
        if j == len(full):
            return False
        j += 1
    return True


def test_a_leaf_hands_the_log_density_only_its_live_chains(monkeypatch):
    spies = []

    def spy(density):
        spies.append(_RowSpy(density))
        return spies[-1]

    _, info = _config3_transition(1, spy)
    monkeypatch.setattr(tnuts, "_live_value_and_grad", lambda vg, z, *_: vg(z))
    _config3_transition(1, spy)
    live, full = spies[0].batches, spies[1].batches
    C = info.num_leapfrog.shape[0]
    assert sum(b.shape[0] for b in live) == int(info.num_leapfrog.sum()) < C * len(live)
    assert len(live) == len(full) and torch.equal(live[0], full[0]) and live[0].shape[0] == C
    assert all(_ordered_rows_of(a, b) for a, b in zip(live, full))
