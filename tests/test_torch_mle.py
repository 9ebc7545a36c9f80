"""Port type-II MLE (inference/mle.py) against the JAX package.

Same numpy-seeded data (tests/test_mle.py's SE problem), float64 on the CPU.
Adam is the same algorithm in torch and optax (epsilon outside the square
root), and the two gradients agree to round-off, so the loss traces agree
step by step (1e-8 relative).  The L-BFGS line searches differ (torch's
strong Wolfe, optax's zoom), so the comparison there is of the optimum: u
to 1e-4 absolute and the log marginal to 1e-7 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.inference import fit_mle as jfit_mle
from gaussian_processes_tpu.utils import testing as tu
from gaussian_processes_tpu_torch.inference import gp_model as tgm
from gaussian_processes_tpu_torch.inference import mle as tmle
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)


def _data(periodic=False, n=40, seed=0):
    x, y = tu.make_xy(np.random.default_rng(seed), n=n, periodic=periodic)
    return x, y, torch.as_tensor(x), torch.as_tensor(y)


def test_adam_trace_matches_optax_step_by_step():
    x, y, xt, yt = _data()
    jres = jfit_mle(gpt.GaussianKernel(h=jnp.asarray(0.5), w=jnp.asarray(1.5)), x, y, 0.5,
                    num_steps=25, method="adam", learning_rate=0.05)
    tres = tmle.fit_mle(gpx.GaussianKernel(0.5, 1.5, dtype=torch.float64), xt, yt, 0.5,
                        num_steps=25, method="adam", learning_rate=0.05)
    assert tres.losses.shape == (25,)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-8)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=1e-8)
    np.testing.assert_allclose(float(tres.log_marginal), float(jres.log_marginal), rtol=1e-8)


def test_lbfgs_finds_the_jax_optimum():
    x, y, xt, yt = _data()
    jres = jfit_mle(gpt.GaussianKernel(h=jnp.asarray(0.7), w=jnp.asarray(0.4)), x, y, 0.3,
                    num_steps=60)
    tres = tmle.fit_mle(gpx.GaussianKernel(0.7, 0.4, dtype=torch.float64), xt, yt, 0.3,
                        num_steps=60)
    assert tres.losses.shape == (60,) and bool(tres.converged)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tres.log_marginal), float(jres.log_marginal), rtol=1e-7)
    np.testing.assert_allclose(tres.kernel.params.numpy(), np.exp(tres.u.numpy()[:2]),
                               rtol=1e-14)
    np.testing.assert_allclose(float(tres.noise), np.exp(float(tres.u[2])), rtol=1e-14)
    # the optimum's log marginal is the objective there
    lml = tgm.make_log_likelihood(tres.kernel, xt, yt).value_and_grad(tres.u)[0]
    np.testing.assert_allclose(float(tres.log_marginal), float(lml), rtol=1e-14)


def test_restarts_return_the_best_restart():
    x, y, xt, yt = _data(periodic=True, n=60, seed=1)
    k0 = gpx.PeriodicKernel(1.0, 1.0, 3.14159265, dtype=torch.float64)
    kw = dict(num_steps=15, method="lbfgs")
    best = tmle.fit_mle_restarts(k0, xt, yt, 0.1, torch.Generator().manual_seed(2),
                                 n_restarts=3, spread=1.0, **kw)
    # the same jittered starts, exp(u0 + spread N(0, 1)), one by one
    eps = torch.randn((3, 4), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    inits = torch.exp(tgm.pack(k0, 0.1)[None] + eps)
    runs = [tmle.fit_mle(k0.with_params(t[:3]), xt, yt, t[3], **kw) for t in inits]
    lmls = [float(r.log_marginal) for r in runs]
    assert float(best.log_marginal) == max(lmls)
    assert torch.equal(best.u, runs[int(np.argmax(lmls))].u)


def test_sgpr_objective_matches_jax():
    x, y, xt, yt = _data(n=60)
    z = np.linspace(-2.5, 2.5, 10)
    opts = dict(num_steps=12, method="adam", learning_rate=0.05, objective="sgpr", inducing=z)
    jres = jfit_mle(gpt.GaussianKernel(h=jnp.asarray(0.8), w=jnp.asarray(0.9)), x, y, 0.3,
                    **opts)
    tres = tmle.fit_mle(gpx.GaussianKernel(0.8, 0.9, dtype=torch.float64), xt, yt, 0.3,
                        **{**opts, "inducing": torch.as_tensor(z)})
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-8)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=1e-8)
    np.testing.assert_allclose(float(tres.log_marginal), float(jres.log_marginal), rtol=1e-8)
    with pytest.raises(ValueError, match="requires inducing"):
        tmle.fit_mle(gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64), xt, yt, 0.1,
                     objective="sgpr")
    with pytest.raises(ValueError, match="unknown method"):
        tmle.fit_mle(gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64), xt, yt, 0.1,
                     method="sgd")


def test_whittle_objective_matches_jax():
    n = 256
    x = np.arange(n) * (2 * np.pi / n) - np.pi
    y = np.sin(2 * x) + 0.1 * np.random.default_rng(1).standard_normal(n)
    opts = dict(num_steps=15, method="adam", learning_rate=0.05, objective="whittle")
    jres = jfit_mle(gpt.GaussianKernel(h=jnp.asarray(0.8), w=jnp.asarray(0.7)), x, y, 0.3,
                    **opts)
    tres = tmle.fit_mle(gpx.GaussianKernel(0.8, 0.7, dtype=torch.float64), torch.as_tensor(x),
                        torch.as_tensor(y), 0.3, **opts)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-8)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=1e-8)
    np.testing.assert_allclose(float(tres.log_marginal), float(jres.log_marginal), rtol=1e-8)


def test_lbfgs_steps_back_from_a_non_finite_objective():
    # a quadratic whose value is NaN past u0 = 1, with its minimum at u0 = 2:
    # the optimizer must walk up to the wall and stop there, never NaN
    target = torch.tensor([2.0, -1.0], dtype=torch.float64)

    def loss_and_grad(u):
        if float(u[0]) > 1.0:
            return torch.tensor(float("nan"), dtype=u.dtype), torch.full_like(u, float("nan"))
        return torch.sum((u - target) ** 2), 2 * (u - target)

    u0 = torch.zeros(2, dtype=torch.float64)
    best_u, best_loss, losses = tmle._run_opt(loss_and_grad, u0, "lbfgs", 0.05, 30)
    assert losses.shape == (30,) and bool(torch.isfinite(best_loss))
    assert bool(torch.isfinite(best_u).all()) and 0.99 <= float(best_u[0]) <= 1.0
    assert bool(torch.isfinite(losses).all())  # every iterate is a finite point
    assert float(best_loss) < float(loss_and_grad(u0)[0])


def test_lbfgs_stays_at_a_stationary_start():
    # a zero gradient at the start: no step, no division by its norm
    def loss_and_grad(u):
        return torch.sum(u ** 2), 2 * u

    u0 = torch.zeros(3, dtype=torch.float64)
    best_u, best_loss, losses = tmle._run_opt(loss_and_grad, u0, "lbfgs", 0.05, 4)
    assert torch.equal(best_u, u0) and float(best_loss) == 0.0
    assert torch.equal(losses, torch.zeros(4, dtype=torch.float64))
