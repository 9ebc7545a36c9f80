"""Port Laplace classification and count regression (models/classify.py)
against the JAX package.

Same numpy-seeded data, float64 on the CPU: logistic labels sign(sin 2x)
with flips, Poisson counts of a smooth rate.  The mode and
``predict_laplace`` (to 1e-7 of each vector's largest entry: at the mode
the ladder compares values equal to round-off), the evidence and its
gradient (autograd through the 20
unrolled Newton steps, against ``jax.grad`` through JAX's scan) agree to
1e-7; ``fit_laplace_mle``'s Adam trace agrees with optax's step by step to
1e-7 (the two evidences' gradients differ at round-off, which Adam's
normalised steps carry forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import classify as jc
from gaussian_processes_tpu_torch.convert import laplace_posterior_from_numpy
from gaussian_processes_tpu_torch.models import classify as tc
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

F64 = jnp.float64
RTOL = 1e-7


def _problem(kind, n=80, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    if kind == "logistic":
        y = np.sign(np.sin(2 * x))
        y[rng.random(n) < 0.1] *= -1.0
        return x, y, jc.LogisticLikelihood(), tc.LogisticLikelihood()
    y = rng.poisson(0.5 * np.exp(np.sin(x) + 1.0)).astype(np.float64)
    return x, y, jc.PoissonLikelihood(0.5), tc.PoissonLikelihood(0.5)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["logistic", "poisson"])
def test_fit_predict_and_evidence_gradient_match_jax(kind):
    x, y, jlik, tlik = _problem(kind)
    xo = np.linspace(-3, 3, 17)
    jk = gpt.GaussianKernel(F64(1.2), F64(0.8))
    tk = gpx.GaussianKernel(1.2, 0.8, dtype=torch.float64)
    jpost = jc.fit_laplace(jk, x, y, likelihood=jlik)
    X, Y = torch.as_tensor(x), torch.as_tensor(y)
    tpost = tc.fit_laplace(tk, X, Y, likelihood=tlik)
    # at the mode the ladder's comparisons are at round-off, so the last
    # step taken may differ: the mode to 1e-7 of its scale
    for got, want in ((tpost.f_hat, jpost.f_hat), (tpost.a_hat, jpost.a_hat)):
        _close(got, want, RTOL, RTOL * float(np.abs(want).max()))
    _close(tpost.log_marginal, jpost.log_marginal)
    assert tpost.newton_deltas.shape == (20,) and bool((tpost.newton_deltas >= 0).all())
    for got, want in zip(tc.predict_laplace(tpost, torch.as_tensor(xo)),
                         jc.predict_laplace(jpost, xo)):
        _close(got, want, RTOL, RTOL * float(np.abs(want).max()))
    # the JAX posterior's arrays carried across predict alike
    carried = laplace_posterior_from_numpy(
        "se", [1.2, 0.8], tlik, x, y, jpost.f_hat, jpost.sqrt_w, jpost.L_B, jpost.a_hat,
        jpost.grad_lik, jpost.log_marginal, jpost.newton_deltas)
    _close(tc.predict_laplace(carried, torch.as_tensor(xo))[0], jc.predict_laplace(jpost, xo)[0],
           1e-12, 1e-14)

    want = jax.grad(lambda u: jc.log_marginal_laplace(jk.with_params(jnp.exp(u)), x, y,
                                                      likelihood=jlik))(jnp.log(jk.params))
    u = torch.log(tk.params).requires_grad_()
    (got,) = torch.autograd.grad(
        tc.log_marginal_laplace(tk.with_params(torch.exp(u)), X, Y, likelihood=tlik), u)
    _close(got, want)


@pytest.mark.parametrize("kind", ["logistic", "poisson"])
def test_fit_laplace_mle_adam_trace_matches_optax(kind):
    x, y, jlik, tlik = _problem(kind, n=50, seed=1)
    opts = dict(num_steps=6, learning_rate=0.05, newton_iters=12)
    jpost, jlosses = jc.fit_laplace_mle(gpt.GaussianKernel(F64(0.9), F64(1.1)), x, y,
                                        likelihood=jlik, **opts)
    tpost, tlosses = tc.fit_laplace_mle(gpx.GaussianKernel(0.9, 1.1, dtype=torch.float64),
                                        torch.as_tensor(x), torch.as_tensor(y),
                                        likelihood=tlik, **opts)
    assert tlosses.shape == (6,)
    _close(tlosses, jlosses)
    _close(tpost.kernel.params, jpost.kernel.params)
    _close(tpost.log_marginal, jpost.log_marginal)
