"""Port SGPR (models/sgpr.py) against the JAX package.

Same numpy-seeded data, float64 on the CPU, inducing points spread so that
Kuu is well conditioned (cond ~ 3e3; on a near-singular Kuu the truncated
pseudo-inverse amplifies round-off of either package's eigh to far above
these tolerances).  The eigenvectors of ``SGPRPosterior`` are fixed only up
to sign and order on ties, so the posterior is compared by its invariants:
the bound, the trace gap, predictions, T^T T and T^T V diag(lam) V^T T,
each at 1e-9.  The bound from ``elbo_sgpr`` and its gradient (theta, noise, z)
against ``jax.grad`` at 1e-7; ``psd_pinv``'s backward against JAX's custom
VJP at 1e-9, also on a degenerate Kuu; k-means from the JAX package's own
starting subset (``record_draws``) at 1e-10; the Adam trace of
``fit_sgpr_mle`` against optax step by step at 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import sgpr as js
from gaussian_processes_tpu_torch.convert import sgpr_posterior_from_numpy
from gaussian_processes_tpu_torch.inference import gp_model as tgm
from gaussian_processes_tpu_torch.models import sgpr as ts
from test_torch_pathwise import Replay, _ard, record_draws
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

F64 = jnp.float64
NOISE = 0.15


def _data(ard=False, n=200, m=12, seed=0):
    rng = np.random.default_rng(seed)
    if ard:
        x = rng.uniform(-2, 2, (n, 2))
        y = np.sin(2 * x[:, 0]) + 0.5 * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
        g = np.linspace(-1.8, 1.8, 4)
        z = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2) + 0.05 * rng.standard_normal((16, 2))
        return x, y, z, rng.uniform(-2, 2, (21, 2))
    x = np.sort(rng.uniform(-2, 2, n))
    y = np.sin(3 * x) + 0.5 * x + 0.1 * rng.standard_normal(n)
    z = np.linspace(-2, 2, m) + 0.05 * rng.standard_normal(m)
    return x, y, z, np.linspace(-2, 2, 31)


def _kernels(ard):
    if ard:
        return _ard()
    return gpt.GaussianKernel(F64(1.1), F64(0.5)), ts_kernel(1.1, 0.5)


def ts_kernel(h, w):
    return gpx.GaussianKernel(h, w, dtype=torch.float64)


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("ard", [False, True], ids=["se", "ard"])
def test_fit_predict_and_covariance_match_jax(ard):
    x, y, z, xo = _data(ard)
    jk, tk = _kernels(ard)
    jpost = js.fit_sgpr(jk, x, y, NOISE, z, block_size=64)
    X, Y, Z, XO = _t(x, y, z, xo)
    tpost = ts.fit_sgpr(tk, X, Y, NOISE, Z, block_size=64)
    _close(tpost.log_marginal, jpost.log_marginal, 1e-9)
    _close(tpost.trace_gap, jpost.trace_gap, 1e-9)
    # the invariants of the sign- and order-free eigenvectors
    _close(tpost.T_uu.T @ tpost.T_uu, jpost.T_uu.T @ jpost.T_uu, 1e-9, 1e-9)
    # V diag(lam) V^T is the whitened A A^T, T C T^T / s^2: carried back by T
    want = jpost.T_uu.T @ jpost.V_B @ jnp.diag(jpost.lam_B) @ jpost.V_B.T @ jpost.T_uu
    got = tpost.T_uu.T @ tpost.V_B @ torch.diag(tpost.lam_B) @ tpost.V_B.T @ tpost.T_uu
    _close(got, want, 1e-9, 1e-9 * float(np.abs(want).max()))
    for got, want in zip(ts.predict_sgpr(tpost, XO), js.predict_sgpr(jpost, xo)):
        _close(got, want, 1e-9, 1e-12)
    for got, want in zip(ts.predict_sgpr_cov(tpost, XO), js.predict_sgpr_cov(jpost, xo)):
        _close(got, want, 1e-9, 1e-12)
    # the JAX posterior's own arrays carried across predict alike
    carried = sgpr_posterior_from_numpy(
        "ard" if ard else "se", np.asarray(jk.params), z, jpost.T_uu, jpost.V_B, jpost.lam_B,
        jpost.c, NOISE, jpost.log_marginal, jpost.trace_gap)
    _close(ts.predict_sgpr(carried, XO)[0], js.predict_sgpr(jpost, xo)[0], 1e-12, 1e-14)


def test_sample_sgpr_posterior_matches_jax():
    x, y, z, xo = _data()
    jk, tk = _kernels(False)
    jpost = js.fit_sgpr(jk, x, y, NOISE, z)
    tpost = ts.fit_sgpr(tk, *_t(x, y), NOISE, *_t(z))
    with record_draws() as drawn:
        want = js.sample_sgpr_posterior(jpost, xo, jax.random.PRNGKey(2), 4)
    got = ts.sample_sgpr_posterior(tpost, *_t(xo), Replay(drawn), 4)
    _close(got, want, 1e-7, 1e-9)


@pytest.mark.parametrize("ard", [False, True], ids=["se", "ard"])
def test_elbo_value_and_gradient_match_jax(ard):
    x, y, z, _ = _data(ard)
    jk, tk = _kernels(ard)
    jfit = js.fit_sgpr(jk, x, y, NOISE, z, block_size=64)
    X, Y, Z = _t(x, y, z)
    tval = ts.elbo_sgpr(tk, X, Y, NOISE, Z, block_size=64)
    _close(tval, jfit.log_marginal, 1e-7)
    _close(tval, js.elbo_sgpr(jk, x, y, NOISE, z, block_size=64), 1e-9)

    u0 = np.log(np.concatenate([np.asarray(jk.params), [NOISE]]))
    P = u0.shape[0] - 1

    def jax_bound(u, zz):
        return js.elbo_sgpr(jk.with_params(jnp.exp(u[:P])), x, y, jnp.exp(u[P]), zz,
                            block_size=64)

    want_u, want_z = jax.grad(jax_bound, argnums=(0, 1))(jnp.asarray(u0), jnp.asarray(z))
    u = torch.as_tensor(u0).requires_grad_()
    zz = Z.clone().requires_grad_()
    kern, noise = tgm.unpack(tk, u)
    got_u, got_z = torch.autograd.grad(ts.elbo_sgpr(kern, X, Y, noise, zz, block_size=64),
                                       [u, zz])
    _close(got_u, want_u, 1e-7)
    _close(got_z, want_z, 1e-7, 1e-7 * float(np.abs(want_z).max()))


@pytest.mark.parametrize("degenerate", [False, True], ids=["regular", "degenerate"])
def test_psd_pinv_vjp_matches_jax(degenerate):
    x, _, z, _ = _data()
    if degenerate:  # duplicated inducing points: a tied, truncated null space
        z = np.concatenate([z[:8], z[:4]])
    jk, tk = _kernels(False)
    A = np.array(jk(z, z))
    G = np.random.default_rng(5).standard_normal(A.shape)
    tol = js._default_rank_tol(F64)
    P, vjp = jax.vjp(lambda a: js.psd_pinv(a, 0.0, tol), jnp.asarray(A))
    want = vjp(jnp.asarray(G))[0]
    At = torch.as_tensor(A).requires_grad_()
    Pt = ts.psd_pinv(At, 0.0, ts._default_rank_tol(torch.float64))
    (got,) = torch.autograd.grad(Pt, At, torch.as_tensor(G))
    scale = float(np.abs(want).max())
    _close(Pt.detach(), P, 1e-9, 1e-9 * float(np.abs(P).max()))
    _close(got, want, 1e-9, 1e-9 * scale)
    assert np.isfinite(got.numpy()).all()


def test_kmeans_from_the_jax_start():
    rng = np.random.default_rng(8)
    x = rng.uniform(-3, 3, 700)  # continuous draws: no equidistant ties
    key = jax.random.PRNGKey(11)
    with record_draws() as drawn:
        want = js.kmeans_inducing(key, x, 24, iters=6, block_size=128)
    got = ts.kmeans_inducing(Replay(drawn), torch.as_tensor(x), 24, iters=6, block_size=128)
    _close(got, want, 1e-10, 1e-12)
    X2 = rng.uniform(-2, 2, (300, 2))
    with record_draws() as drawn:
        want = js.kmeans_inducing(key, X2, 9, iters=4, block_size=64)
    _close(ts.kmeans_inducing(Replay(drawn), torch.as_tensor(X2), 9, iters=4, block_size=64),
           want, 1e-10, 1e-12)


def test_select_inducing_dispatch():
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 2, 100))
    g = torch.Generator().manual_seed(0)
    sub = ts.select_inducing(g, x, 7, "subset")
    assert sub.shape == (7,) and all(bool((x == v).any()) for v in sub)
    assert len(set(sub.tolist())) == 7
    grid = ts.select_inducing(g, x, 5, "grid")
    _close(grid, np.linspace(float(x.min()), float(x.max()), 5), 1e-14)
    assert ts.select_inducing(g, x, 6, "kmeans").shape == (6,)
    with pytest.raises(ValueError, match="unknown inducing"):
        ts.select_inducing(g, x, 6, "nope")
    with pytest.raises(ValueError, match="1-D"):
        ts.inducing_grid(torch.zeros((4, 2)), 3)


@pytest.mark.parametrize("learn_inducing", [False, True], ids=["theta", "theta_and_z"])
def test_fit_sgpr_mle_adam_trace_matches_optax(learn_inducing):
    x, y, z, _ = _data(n=120, m=8)
    jk, tk = gpt.GaussianKernel(F64(0.8), F64(0.7)), ts_kernel(0.8, 0.7)
    opts = dict(learn_inducing=learn_inducing, num_steps=8, learning_rate=0.05,
                block_size=64)
    jpost, jlosses = js.fit_sgpr_mle(jk, x, y, 0.3, z, **opts)
    tpost, tlosses = ts.fit_sgpr_mle(tk, *_t(x, y), 0.3, *_t(z), **opts)
    assert tlosses.shape == (8,)
    _close(tlosses, jlosses, 1e-8)
    _close(tpost.log_marginal, jpost.log_marginal, 1e-8)
    _close(tpost.z, jpost.z, 1e-8)


def test_log_posterior_sgpr_on_a_chain_stack_matches_jax_row_by_row():
    x, y, z, _ = _data(n=120, m=8)
    jk, tk = gpt.GaussianKernel(F64(1.0), F64(0.6)), ts_kernel(1.0, 0.6)
    U = np.log([[1.0, 0.6, 0.2], [1.3, 0.5, 0.15], [0.8, 0.8, 0.3]])
    jlp = js.make_log_posterior_sgpr(jk, x, y, z, prior_std=1.5)
    tlp = ts.make_log_posterior_sgpr(tk, *_t(x, y, z), prior_std=1.5)
    values, grads = tlp.value_and_grad(torch.as_tensor(U))
    for c in range(3):
        v, g = jax.value_and_grad(jlp)(jnp.asarray(U[c]))
        _close(values[c], v, 1e-9)
        _close(grads[c], g, 1e-7)
    # one position, and the autograd entry point
    u = torch.as_tensor(U[1]).requires_grad_()
    (g1,) = torch.autograd.grad(tlp(u), u)
    _close(g1, grads[1], 1e-14)
