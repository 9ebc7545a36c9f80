"""Port matrix-free GP layer (models/iterative_gp.py) against the JAX package.

Both packages get the same numpy-seeded data, float64 on the CPU, and the
port gets the JAX package's own random draws, recomputed here from the same
key sequence (``Replay``), so the two compute the same arithmetic.  The
iterative results agree to rtol 1e-6: both solve to tol 1e-10 or better, so
what is left is round-off carried through the CG recurrences (a column that
crosses tol one iteration apart in the two libraries would change its
Lanczos coefficients, which the problems here stay clear of).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import iterative_gp as jit_gp
from gaussian_processes_tpu_torch.convert import iterative_posterior_from_numpy
from gaussian_processes_tpu_torch.models import iterative_gp as tit_gp
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-6
F64 = jnp.float64


class Replay:
    """Hands out recorded draws in order, as ``krylov.Draws`` would draw them."""

    def __init__(self, *arrays):
        self.arrays = list(arrays)

    def _next(self, shape, dtype, device):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    rademacher = normal = _next


def _problem(n=120, seed=0, family="se"):
    rng = np.random.default_rng(seed)
    if family == "ard":
        x = rng.uniform(-2, 2, (n, 2))
        y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
        w = np.array([0.8, 1.4])
        return (gpt.ARDGaussianKernel(h=F64(1.0), w=jnp.asarray(w)),
                gpx.ARDGaussianKernel(1.0, torch.as_tensor(w)), x, y)
    x = np.sort(rng.uniform(-3, 3, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    return (gpt.GaussianKernel(h=F64(1.2), w=F64(0.6)),
            gpx.GaussianKernel(1.2, 0.6, dtype=torch.float64), x, y)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _rademacher(key, n, r):
    return np.asarray(jax.random.rademacher(key, (n, r), dtype=F64))


def _precond_normals(key, k, n, r):
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    return (np.asarray(jax.random.normal(k1, (k, r), F64)),
            np.asarray(jax.random.normal(k2, (n, r), F64)))


NOISE = 0.3
PLAIN = dict(num_probes=6, num_iters=120, tol=1e-10, block_size=64)
PRECOND = dict(num_probes=6, num_iters=60, tol=1e-10, block_size=64, precond_rank=40)


@pytest.mark.parametrize("family", ["se", "ard"])
def test_fit_iterative_plain_matches_jax(family):
    jk, tk, x, y = _problem(family=family)
    key = jax.random.key(0)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, **PLAIN)
    tp = tit_gp.fit_iterative(tk, _t(x), _t(y), NOISE, Replay(_rademacher(key, 120, 6)),
                              **PLAIN)
    _close(tp.alpha, jp.alpha)
    _close(tp.log_marginal, jp.log_marginal)
    assert float(tp.solve_residual) < 1e-10
    xo = (np.random.default_rng(7).uniform(-2, 2, (9, 2)) if family == "ard"
          else np.linspace(-3.3, 3.3, 9))
    _close(tit_gp.predict_mean_iterative(tp, _t(xo), block_size=4),
           jit_gp.predict_mean_iterative(jp, xo, block_size=4))


def test_fit_iterative_preconditioned_matches_jax():
    jk, tk, x, y = _problem(seed=1)
    key = jax.random.key(1)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, **PRECOND)
    tp = tit_gp.fit_iterative(tk, _t(x), _t(y), NOISE, Replay(*_precond_normals(key, 40, 120, 6)),
                              **PRECOND)
    _close(tp.alpha, jp.alpha)
    _close(tp.log_marginal, jp.log_marginal)
    _close(tp.solve_residual, jp.solve_residual, atol=1e-13)


@pytest.mark.parametrize("precond_rank", [0, 40])
def test_predict_diag_iterative_matches_jax(precond_rank):
    jk, tk, x, y = _problem(seed=2)
    key = jax.random.key(2)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, **PLAIN)
    tp = tit_gp.fit_iterative(tk, _t(x), _t(y), NOISE, Replay(_rademacher(key, 120, 6)),
                              **PLAIN)
    xo = np.linspace(-3.3, 3.3, 11)
    opts = dict(num_iters=120, tol=1e-10, precond_rank=precond_rank)
    jm, jv = jit_gp.predict_diag_iterative(jp, xo, **opts)
    tm, tv = tit_gp.predict_diag_iterative(tp, _t(xo), **opts)
    _close(tm, jm)
    _close(tv, jv, atol=1e-10)


@pytest.mark.parametrize("precond_rank", [0, 40])
def test_value_and_grad_iterative_matches_jax(precond_rank):
    jk, tk, x, y = _problem(n=100, seed=3)
    key = jax.random.key(3)
    opts = dict(num_probes=6, num_iters=100, tol=1e-10, block_size=32,
                precond_rank=precond_rank)
    jl, jg = jit_gp.log_marginal_value_and_grad_iterative(jk, x, y, NOISE, key, **opts)
    draws = [_rademacher(key, 100, 6)]
    if precond_rank:
        draws += _precond_normals(key, 40, 100, 6)
    tl, tg = tit_gp.log_marginal_value_and_grad_iterative(tk, _t(x), _t(y), NOISE,
                                                          Replay(*draws), **opts)
    _close(tl, jl)
    _close(tg, jg)


def test_estimate_terms_reproduce_the_estimate():
    _, tk, x, y = _problem(n=90, seed=4)
    est = tit_gp.log_marginal_estimate_iterative(
        tk, _t(x), _t(y), NOISE, torch.Generator().manual_seed(1), num_probes=5,
        num_iters=90, tol=1e-10, precond_rank=30)
    lml, grad = tit_gp.log_marginal_value_and_grad_iterative(
        tk, _t(x), _t(y), NOISE, torch.Generator().manual_seed(1), num_probes=5,
        num_iters=90, tol=1e-10, precond_rank=30)
    assert est.logdet_terms.shape == (5,) and est.trace_terms.shape == (3, 5)
    np.testing.assert_array_equal(est.lml.numpy(), lml.numpy())
    np.testing.assert_array_equal(est.grad.numpy(), grad.numpy())


def test_fit_mle_iterative_matches_jax():
    jk, tk, x, y = _problem(n=80, seed=5)
    jk0 = jk.with_params(jnp.asarray([0.7, 1.1]))
    tk0 = tk.with_params(torch.tensor([0.7, 1.1], dtype=torch.float64))
    opts = dict(num_steps=3, num_probes=4, num_iters=80, tol=1e-10, block_size=32)
    key = jax.random.key(0)
    jkf, jnf, jlast, jtrace = jit_gp.fit_mle_iterative(jk0, x, y, 0.4, key, **opts)
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(_rademacher(sub, 80, 4))
    tkf, tnf, tlast, ttrace = tit_gp.fit_mle_iterative(tk0, _t(x), _t(y), 0.4,
                                                       Replay(*draws), **opts)
    _close(ttrace, jtrace)
    _close(tkf.params, jkf.params)
    _close(tnf, jnf)
    assert tlast == ttrace[-1]


def test_one_adam_step_matches_optax():
    u0 = np.array([0.3, -0.2, 0.05])
    grads = [np.array([1.5, -0.25, 4.0]), np.array([-0.5, 0.75, 3.0])]
    opt = optax.adam(0.05)
    u, state = jnp.asarray(u0), opt.init(jnp.asarray(u0))
    ut = torch.tensor(u0, requires_grad=True)
    topt = torch.optim.Adam([ut], lr=0.05)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, u)
        u = optax.apply_updates(u, upd)
        ut.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(ut.detach().numpy(), np.asarray(u), rtol=1e-13)


def test_structures_of_slice_3_run_and_others_raise():
    jk, tk, _, _ = _problem(n=20)
    x = np.arange(64) * (6.0 / 64) - 3.0
    y = np.sin(2 * x)
    key = jax.random.key(0)
    opts = dict(num_probes=3, num_iters=64, tol=1e-10, structure="toeplitz")
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, **opts)
    normals = np.asarray(jax.random.normal(jax.random.split(key)[0], (64, 3), F64))
    tp = tit_gp.fit_iterative(tk, _t(x), _t(y), NOISE, Replay(normals), **opts)
    _close(tp.alpha, jp.alpha)
    _close(tp.log_marginal, jp.log_marginal)
    with pytest.raises(ValueError, match="unknown structure"):
        tit_gp.fit_iterative(tk, _t(x), _t(y), NOISE, structure=object())
    with pytest.raises(ValueError, match="unknown structure"):
        tit_gp.fit_iterative(tk, _t(x), _t(y), NOISE, structure="dense")


def test_iterative_posterior_from_jax_predicts_the_same():
    jk, _, x, y = _problem(seed=6)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, jax.random.key(4), **PLAIN)
    tp = iterative_posterior_from_numpy(
        "se", np.asarray(jk.params), jp.x, jp.y, jp.noise, jp.alpha, jp.log_marginal,
        jp.solve_residual, jp.num_probes, jp.num_iters)
    assert isinstance(tp, gpx.IterativePosterior) and tp.num_probes == 6
    xo = np.linspace(-3, 3, 13)
    _close(tit_gp.predict_mean_iterative(tp, _t(xo)),
           jit_gp.predict_mean_iterative(jp, xo), rtol=1e-10)
