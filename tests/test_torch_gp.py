"""Port GP layer (models/gp.py, models/gp_object.py) against the JAX package.

Every ported function gets the same numpy-seeded inputs in both packages,
float64 on the CPU, and agrees to rtol 1e-8 (the JAX package's own gate for
its blocked factorization, ops/blocked_cholesky.py:30-32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import gp as jgp
from gaussian_processes_tpu_torch.convert import posterior_from_numpy
from gaussian_processes_tpu_torch.models import gp as tgp
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-8

FAMILIES = {
    "se": (gpt.GaussianKernel, gpx.GaussianKernel, (1.4, 0.8)),
    "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, (1.1, 0.9, 1.6)),
}
NOISE = 0.2


def _pair(family):
    jcls, tcls, theta = FAMILIES[family]
    return jcls(*(jnp.asarray(v) for v in theta)), tcls(*theta, dtype=torch.float64)


def _data(n=60, seed=0, m=17):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    xo = np.linspace(-3.3, 3.3, m)
    return x, y, xo


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fit_matches_jax(family):
    jk, tk = _pair(family)
    x, y, _ = _data()
    jp = jgp.fit(jk, x, y, NOISE, jitter=1e-8)
    tp = tgp.fit(tk, _t(x), _t(y), NOISE, jitter=1e-8)
    _close(tp.L, jp.L, atol=1e-12)
    _close(tp.alpha, jp.alpha)
    _close(tp.log_marginal, jp.log_marginal)
    _close(tgp.build_kxx(tk, _t(x), NOISE, 1e-8), jgp.build_kxx(jk, x, NOISE, 1e-8))
    _close(tgp.log_marginal_likelihood(tk, _t(x), _t(y), NOISE, 1e-8),
           jgp.log_marginal_likelihood(jk, x, y, NOISE, 1e-8))


def test_fit_heteroscedastic_noise_matches_jax():
    jk, tk = _pair("se")
    x, y, xo = _data(seed=1)
    s = np.linspace(0.05, 0.4, x.size)
    jp = jgp.fit(jk, x, y, s)
    tp = tgp.fit(tk, _t(x), _t(y), _t(s))
    _close(tp.log_marginal, jp.log_marginal)
    _close(tgp.build_kxx(tk, _t(x), _t(s)), jgp.build_kxx(jk, x, s))
    _close(tgp.predict_diag(tp, _t(xo))[1], jgp.predict_diag(jp, xo)[1], atol=1e-12)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_predict_paths_match_jax(family):
    jk, tk = _pair(family)
    x, y, xo = _data(seed=2)
    jp = jgp.fit(jk, x, y, NOISE)
    tp = tgp.fit(tk, _t(x), _t(y), NOISE)
    jm, jc = jgp.predict(jp, xo)
    tm, tc = tgp.predict(tp, _t(xo))
    _close(tm, jm, atol=1e-12)
    _close(tc, jc, atol=1e-12)
    _close(tgp.predict_mean(tp, _t(xo)), jgp.predict_mean(jp, xo), atol=1e-12)
    dm, dv = tgp.predict_diag(tp, _t(xo))
    jdm, jdv = jgp.predict_diag(jp, xo)
    _close(dm, jdm, atol=1e-12)
    _close(dv, jdv, atol=1e-12)
    _close(dv, torch.diagonal(tc), atol=1e-12)


def test_predict_on_converted_posterior():
    """A JAX posterior carried over by ``convert`` predicts the same."""
    jk, _ = _pair("periodic")
    x, y, xo = _data(seed=3)
    jp = jgp.fit(jk, x, y, NOISE)
    tp = posterior_from_numpy("periodic", np.asarray(jp.kernel.params), jp.x, jp.y,
                              jp.noise, jp.L, jp.alpha, jp.log_marginal)
    _close(tgp.predict_diag(tp, _t(xo))[1], jgp.predict_diag(jp, xo)[1], atol=1e-12)
    _close(tp.log_marginal, jp.log_marginal)


def test_log_predictive_density_matches_jax():
    jk, tk = _pair("se")
    x, y, xo = _data(seed=4)
    yo = np.sin(2 * xo)
    jp = jgp.fit(jk, x, y, NOISE)
    tp = tgp.fit(tk, _t(x), _t(y), NOISE)
    _close(tgp.log_predictive_density(tp, _t(xo), _t(yo)),
           jgp.log_predictive_density(jp, xo, yo))


def test_sample_posterior_moments_match_jax():
    """Generators differ from keys, so draws are compared in distribution:
    sample mean and covariance against JAX's predictive moments within
    Monte-Carlo error."""
    jk, tk = _pair("se")
    x, y, _ = _data(n=40, seed=5)
    xo = np.linspace(-2.5, 2.5, 6)
    jp = jgp.fit(jk, x, y, 0.3)
    tp = tgp.fit(tk, _t(x), _t(y), 0.3)
    gen = torch.Generator().manual_seed(0)
    draws = tgp.sample_posterior(tp, _t(xo), gen, n_samples=20000).numpy()
    assert draws.shape == (20000, 6)
    jm, jc = jgp.predict(jp, xo)
    jm, jc = np.asarray(jm), np.asarray(jc)
    sd = np.sqrt(np.diag(jc))
    assert np.all(np.abs(draws.mean(0) - jm) < 5 * sd / np.sqrt(20000))
    np.testing.assert_allclose(np.cov(draws.T), jc, atol=5 * sd.max() ** 2 * np.sqrt(2 / 20000))
    jdraws = np.asarray(jgp.sample_posterior(jp, xo, jax.random.key(0), n_samples=4))
    assert jdraws.shape == (4, 6)
    again = tgp.sample_posterior(tp, _t(xo), torch.Generator().manual_seed(0), n_samples=20000)
    np.testing.assert_array_equal(again.numpy(), draws)


def test_loo_matches_jax():
    jk, tk = _pair("periodic")
    x, y, _ = _data(seed=6)
    jp = jgp.fit(jk, x, y, NOISE)
    tp = tgp.fit(tk, _t(x), _t(y), NOISE)
    for got, want in zip(tgp.loo_predictive(tp), jgp.loo_predictive(jp)):
        _close(got, want)


def test_extend_posterior_matches_jax():
    jk, tk = _pair("se")
    x, y, _ = _data(n=70, seed=7)
    jp = jgp.extend_posterior(jgp.fit(jk, x[:50], y[:50], NOISE), x[50:], y[50:], 1e-8)
    tp = tgp.extend_posterior(tgp.fit(tk, _t(x[:50]), _t(y[:50]), NOISE),
                              _t(x[50:]), _t(y[50:]), 1e-8)
    _close(tp.L, jp.L, atol=1e-12)
    _close(tp.alpha, jp.alpha)
    _close(tp.log_marginal, jp.log_marginal)
    _close(tp.x, jp.x)
    with pytest.raises(ValueError, match="scalar noise"):
        tgp.extend_posterior(tgp.fit(tk, _t(x), _t(y), _t(np.full(70, 0.2))), _t(x[:2]), _t(y[:2]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_value_and_grad_matches_jax(family):
    jk, tk = _pair(family)
    x, y, _ = _data(seed=8)
    jl, jg = jgp.log_marginal_value_and_grad(jk, x, y, NOISE)
    tl, tg = tgp.log_marginal_value_and_grad(tk, _t(x), _t(y), NOISE)
    _close(tl, jl)
    _close(tg, jg)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hessian_and_all_match_jax(family):
    jk, tk = _pair(family)
    x, y, _ = _data(n=80, seed=9)
    _close(tgp.log_marginal_hessian(tk, _t(x), _t(y), NOISE),
           jgp.log_marginal_hessian(jk, x, y, NOISE))
    for got, want in zip(tgp.log_marginal_all(tk, _t(x), _t(y), NOISE),
                         jgp.log_marginal_all(jk, x, y, NOISE)):
        _close(got, want)
    for got, want in zip(tgp.likelihood_value_grad_hessian(tk, _t(x), _t(y), NOISE),
                         jgp.likelihood_value_grad_hessian(jk, x, y, NOISE)):
        _close(got, want)


def test_chunked_hessian_matches_jax_at_2048():
    """n >= 2048 streams one hessian_pair plane at a time in both packages."""
    jk, tk = _pair("se")
    x, y, _ = _data(n=2048, seed=10)
    assert x.size >= tgp._HESSIAN_CHUNK_N == jgp._HESSIAN_CHUNK_N
    _close(tgp.log_marginal_hessian(tk, _t(x), _t(y), 0.3, 1e-6),
           jgp.log_marginal_hessian(jk, x, y, 0.3, 1e-6))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_equals_dense_assembly(family, monkeypatch):
    _, tk = _pair(family)
    x, y, _ = _data(n=90, seed=11)
    dense = tgp.log_marginal_hessian(tk, _t(x), _t(y), NOISE)
    monkeypatch.setattr(tgp, "_HESSIAN_CHUNK_N", 10)
    chunked = tgp.log_marginal_hessian(tk, _t(x), _t(y), NOISE)
    _close(chunked, dense, rtol=1e-10)


# -- the memoizing GP facade ---------------------------------------------------


def _gps(seed=12):
    jk, tk = _pair("se")
    x, y, xo = _data(n=45, seed=seed)
    return gpt.GP(jk, x, y, NOISE), gpx.GP(tk, _t(x), _t(y), NOISE), xo


def test_gp_object_properties_match_jax():
    jg, tg, xo = _gps()
    for name in ("Kxx", "Lxx", "inv_Lxx", "inv_Kxx", "inv_Kxx_y", "log_lh", "lh",
                 "dloglh_dtheta", "dlh_dtheta", "d2loglh_dtheta2", "d2lh_dtheta2"):
        _close(getattr(tg, name), getattr(jg, name), atol=1e-10)
    for got, want in zip(tg.loo, jg.loo):
        _close(got, want)
    _close(tg.mean(_t(xo)), jg.mean(xo), atol=1e-12)
    _close(tg.cov(_t(xo)), jg.cov(xo), atol=1e-12)
    _close(tg.Kxoxo(_t(xo)), jg.Kxoxo(xo))
    _close(tg.Kxxo(_t(xo)), jg.Kxxo(xo))
    _close(tg.Kxox(_t(xo)), jg.Kxox(xo))
    _close(tg.params, jg.params)


def test_gp_object_memo_and_invalidation():
    jg, tg, _ = _gps(13)
    L = tg.Lxx
    assert tg.Lxx is L and "Lxx" in tg._memo
    _ = tg.d2loglh_dtheta2
    assert "dloglh_dtheta" in tg._memo  # gradient cached as a side effect
    theta = np.array([1.1, 0.6, 0.3])
    tg.params = _t(theta)
    jg.params = jnp.asarray(theta)
    assert tg._memo == {}
    _close(tg.params, theta)
    _close(tg.log_lh, jg.log_lh)
    for attr, value in (("s", 0.25), ("y", np.asarray(jg.y) * 0.5), ("x", np.asarray(jg.x) + 0.01)):
        _ = tg.log_lh
        setattr(tg, attr, _t(value))
        setattr(jg, attr, jnp.asarray(value))
        assert tg._memo == {}
        _close(tg.log_lh, jg.log_lh)
    tg.K = tg.K.with_params(_t([1.2, 0.9]))
    jg.K = jg.K.with_params(jnp.asarray([1.2, 0.9]))
    assert tg._memo == {}
    _close(tg.dloglh_dtheta, jg.dloglh_dtheta)


def test_gp_object_copy_is_independent():
    _, tg, _ = _gps(14)
    lml = tg.log_lh
    cp = tg.copy()
    cp.params = _t([2.0, 0.5, 0.4])
    assert tg._memo["log_lh"] is lml
    assert float(cp.log_lh) != float(lml)


def test_gp_posterior_is_frozen():
    _, tk = _pair("se")
    x, y, _ = _data(n=20)
    post = tgp.fit(tk, _t(x), _t(y), NOISE)
    with pytest.raises(dataclasses.FrozenInstanceError):
        post.alpha = post.alpha
