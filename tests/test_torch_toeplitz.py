"""Port Toeplitz layer (ops/toeplitz.py, structure="toeplitz") against the JAX package.

Both packages get the same numpy-seeded grid data in float64 on the CPU;
the port gets the JAX package's own random draws (``Replay``).  Columns,
matvecs, spectra and logdets agree to rel 1e-10; the iterative fits, whose
CG recurrences carry round-off, to rel 1e-8.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.models import composite as jcomp
from gaussian_processes_tpu.models import iterative_gp as jit_gp
from gaussian_processes_tpu.ops import toeplitz as jt
from gaussian_processes_tpu_torch.convert import kernel_from_spec
from gaussian_processes_tpu_torch.models import iterative_gp as tit_gp
from gaussian_processes_tpu_torch.ops import krylov as tkrylov
from gaussian_processes_tpu_torch.ops import toeplitz as tt
from test_torch_iterative import Replay
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL, FIT_RTOL = 1e-10, 1e-8
F64 = jnp.float64
LEAVES = {"se": gpt.GaussianKernel, "periodic": gpt.PeriodicKernel,
          "matern32": gpt.Matern32Kernel, "matern52": gpt.Matern52Kernel,
          "rq": gpt.RationalQuadraticKernel}
SPECS = {
    "se": ("se", (1.2, 0.3)),
    "matern32": ("matern32", (1.1, 0.4)),
    "matern52": ("matern52", (0.9, 0.5)),
    "periodic": ("periodic", (1.0, 0.9, 1.3)),
    "rq": ("rq", (1.0, 0.5, 1.5)),
    "sum": ("sum", ("se", (1.0, 0.3)), ("periodic", (0.7, 1.0, 2.0))),
    "quasi_periodic": ("prod", ("se", (1.0, 0.8)), ("periodic", (1.0, 1.0, 0.7))),
}


def jax_kernel(spec):
    if spec[0] in ("sum", "prod"):
        cls = jcomp.SumKernel if spec[0] == "sum" else jcomp.ProductKernel
        return cls(jax_kernel(spec[1]), jax_kernel(spec[2]))
    return LEAVES[spec[0]](*(F64(v) for v in spec[1]))


def pair(name):
    return jax_kernel(SPECS[name]), kernel_from_spec(SPECS[name])


def grid(n, lo=-np.pi, hi=np.pi, seed=0, freq=3.0):
    """Endpoint-exclusive grid and y = sin(freq x) + 0.1 eps."""
    x = np.arange(n) * ((hi - lo) / n) + lo
    y = np.sin(freq * x) + 0.1 * np.random.default_rng(seed).standard_normal(n)
    return x, y


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def test_is_uniform_grid_matches_jax():
    x, _ = grid(512)
    cases = [x, x.astype(np.float32), np.sort(np.random.default_rng(1).uniform(-1, 1, 64)),
             x[:1], np.zeros(4), np.linspace(0, 1, 2000).astype(np.float32)]
    for c in cases:
        assert tt.is_uniform_grid(c) == jt.is_uniform_grid(c)
        assert tt.is_uniform_grid(torch.as_tensor(c)) == jt.is_uniform_grid(c)


@pytest.mark.parametrize("name", ["se", "periodic", "matern52", "quasi_periodic"])
def test_columns_and_matvecs_match_jax(name):
    jk, tk = pair(name)
    x, _ = grid(300)
    v = np.random.default_rng(2).standard_normal((300, 3))
    close(tt.toeplitz_column(tk, t(x)), jt.toeplitz_column(jk, x))
    close(tt.jacobian_columns(tk, t(x)), jt.jacobian_columns(jk, x))
    col = np.asarray(jt.toeplitz_column(jk, x))
    close(tt.toeplitz_matvec(t(col), t(v), 0.07), jt.toeplitz_matvec(col, v, 0.07))
    close(tt.toeplitz_matvec(t(col), t(v[:, 0])), jt.toeplitz_matvec(col, v[:, 0]))
    close(tt.kernel_matvec_toeplitz(tk, t(x), t(v), 0.3, 1e-6),
          jt.kernel_matvec_toeplitz(jk, x, v, 0.3, 1e-6))


@pytest.mark.parametrize("spectrum", ["auto", "fft"])
@pytest.mark.parametrize("name", list(SPECS))
def test_spectra_match_jax(name, spectrum):
    jk, tk = pair(name)
    x, _ = grid(1024)
    close(tt.whittle_spectrum(tk, t(x), 0.1, 1e-6, spectrum),
          jt.whittle_spectrum(jk, x, 0.1, 1e-6, spectrum))
    analytic = jt.circulant_eigenvalues_analytic(jk, x, 0.01)
    got = tt.circulant_eigenvalues_analytic(tk, t(x), 0.01)
    assert (got is None) == (analytic is None)
    if analytic is not None:
        close(got, analytic)
    col = np.asarray(jt.toeplitz_column(jk, x))
    close(tt.circulant_eigenvalues(t(col), 0.01), jt.circulant_eigenvalues(col, 0.01))


def test_analytic_pieces_match_jax():
    x, _ = grid(2048)
    dx = x[1] - x[0]
    om = np.linspace(0.0, 40.0, 257)
    for name in ("se", "matern32", "matern52", "sum", "periodic"):
        jk, tk = pair(name)
        want = jt.spectral_density(jk, om)
        got = tt.spectral_density(tk, t(om))
        assert (got is None) == (want is None)
        if want is not None:
            close(got, want)
    jp, tp = pair("periodic")
    close(tt.periodic_line_bins(tp, 2048, t(dx), 128), jt.periodic_line_bins(jp, 2048, dx, 128))
    close(tt.periodic_line_bins(tp, 2047, t(dx)), jt.periodic_line_bins(jp, 2047, dx))
    jq, tq = pair("quasi_periodic")
    close(tt.quasi_periodic_bins(tq.k2, tq.k1, 2048, t(dx), torch.float64, 3, 64),
          jt.quasi_periodic_bins(jq.k2, jq.k1, 2048, dx, F64, 3, 64))


def test_circulant_precond_and_logdet_match_jax():
    jk, tk = pair("se")
    x, _ = grid(500)
    col = np.asarray(jt.toeplitz_column(jk, x))
    v = np.random.default_rng(3).standard_normal((500, 2))
    close(tt.strang_circulant_precond(t(col), 0.05)(t(v)),
          jt.strang_circulant_precond(col, 0.05)(v))
    for n in (500, 499):
        lam = np.asarray(jt.circulant_eigenvalues(col[:n], 0.05))
        close(tt.circulant_logdet(t(lam), n), jt.circulant_logdet(lam, n))


def test_slq_logdet_circulant_matches_jax():
    jk, tk = pair("se")
    x, _ = grid(400)
    col = np.asarray(jt.toeplitz_column(jk, x))
    shift = 0.09
    key = jax.random.key(5)
    want = jt.slq_logdet_circulant(lambda v: jt.toeplitz_matvec(col, v, shift), col, shift,
                                   key, 6, 40)
    u = np.asarray(jax.random.normal(key, (400, 6), F64))
    got = tt.slq_logdet_circulant(lambda v: tt.toeplitz_matvec(t(col), v, shift), t(col),
                                  shift, Replay(u), 6, 40)
    close(got, want, FIT_RTOL)


def test_whittle_spectrum_warns_without_an_analytic_density_at_scale():
    _, tk = pair("rq")
    x = torch.linspace(-1.0, 1.0, 100_001, dtype=torch.float64)
    with pytest.warns(UserWarning, match="FFT spectrum"):
        tt.whittle_spectrum(tk, x, 0.1)
    with pytest.raises(NotImplementedError, match="spectrum='fft'"):
        tt.whittle_spectrum(tk, x[:100], 0.1, spectrum="analytic")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt.whittle_spectrum(pair("se")[1], x, 0.1)


NOISE = 0.3
OPTS = dict(num_probes=6, num_iters=80, tol=1e-10, structure="toeplitz")


def _slq_normals(key, n, r):
    return np.asarray(jax.random.normal(jax.random.split(key)[0], (n, r), F64))


@pytest.mark.parametrize("name", ["se", "quasi_periodic"])
def test_fit_iterative_toeplitz_matches_jax(name):
    jk, tk = pair(name)
    x, y = grid(256, -3.0, 3.0, seed=1)
    key = jax.random.key(0)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, **OPTS)
    tp = tit_gp.fit_iterative(tk, t(x), t(y), NOISE, Replay(_slq_normals(key, 256, 6)), **OPTS)
    close(tp.alpha, jp.alpha, FIT_RTOL)
    close(tp.log_marginal, jp.log_marginal, FIT_RTOL)
    assert float(tp.solve_residual) < 1e-9
    xo = np.linspace(-3.2, 3.2, 9)
    close(tit_gp.predict_mean_iterative(tp, t(xo)), jit_gp.predict_mean_iterative(jp, xo),
          FIT_RTOL)
    dopts = dict(num_iters=80, tol=1e-10, structure="toeplitz")
    jm, jv = jit_gp.predict_diag_iterative(jp, xo, **dopts)
    tm, tv = tit_gp.predict_diag_iterative(tp, t(xo), **dopts)
    close(tm, jm, FIT_RTOL)
    close(tv, jv, FIT_RTOL)


@pytest.mark.parametrize("precond_rank", [0, 30])
def test_value_and_grad_toeplitz_matches_jax(precond_rank):
    jk, tk = pair("se")
    x, y = grid(200, -3.0, 3.0, seed=2)
    key = jax.random.key(3)
    opts = dict(OPTS, precond_rank=precond_rank)
    jl, jg = jit_gp.log_marginal_value_and_grad_iterative(jk, x, y, NOISE, key, **opts)
    draws = [np.asarray(jax.random.rademacher(key, (200, 6), dtype=F64))]
    if precond_rank:
        k1, k2 = jax.random.split(jax.random.split(key)[0])
        draws += [np.asarray(jax.random.normal(k1, (30, 6), F64)),
                  np.asarray(jax.random.normal(k2, (200, 6), F64))]
    else:
        draws.append(_slq_normals(key, 200, 6))
    tl, tg = tit_gp.log_marginal_value_and_grad_iterative(tk, t(x), t(y), NOISE,
                                                          Replay(*draws), **opts)
    close(tl, jl, FIT_RTOL)
    close(tg, jg, FIT_RTOL)


def test_toeplitz_path_builds_no_pivoted_cholesky(monkeypatch):
    _, tk = pair("se")
    x, y = grid(128)

    def forbidden(*args, **kwargs):
        raise AssertionError("the Strang preconditioner replaces the pivoted Cholesky")

    monkeypatch.setattr(tkrylov, "pivoted_cholesky", forbidden)
    post = tit_gp.fit_iterative(tk, t(x), t(y), NOISE, torch.Generator().manual_seed(0),
                                **OPTS)
    assert torch.isfinite(post.log_marginal)


def test_iterative_posterior_toeplitz_matches_jax():
    from gaussian_processes_tpu.inference import gp_model as jgm
    from gaussian_processes_tpu_torch.inference import gp_model as tgm

    jk, tk = pair("se")
    x, y = grid(128, -3.0, 3.0, seed=4)
    key = jax.random.key(6)
    opts = dict(num_probes=4, num_iters=128, tol=1e-10, structure="toeplitz")
    jf = jgm.make_log_posterior_iterative(jk, x, y, probe_key=key, prior_std=1.5, **opts)
    draws = Replay(np.asarray(jax.random.rademacher(key, (128, 4), dtype=F64)),
                   _slq_normals(key, 128, 4))
    tf = tgm.make_log_posterior_iterative(tk, t(x), t(y), probe_generator=draws,
                                          prior_std=1.5, **opts)
    us = np.log([[1.2, 0.3, 0.3], [0.9, 0.4, 0.25]])
    want = [jax.value_and_grad(jf)(jnp.asarray(u)) for u in us]
    got_v, got_g = tf.value_and_grad(t(us))
    close(got_v, [float(v) for v, _ in want], FIT_RTOL)
    close(got_g, np.stack([np.asarray(g) for _, g in want]), FIT_RTOL)
