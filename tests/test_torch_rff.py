"""Port random-feature regression (models/rff.py) against the JAX package.

The port gets the JAX package's own feature draws (``record_draws`` and
``Replay`` of tests/test_torch_pathwise.py), float64 on the CPU; the lml,
predictions and posterior draws then agree to 1e-9 (the F x F Cholesky is
LAPACK's in both).  The periodic kernel takes the exact harmonic map (no
draws), ARD its (F, D) frequencies.
"""

import jax
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.models import rff as jrff
from gaussian_processes_tpu_torch.convert import kernel_from_spec
from gaussian_processes_tpu_torch.models import rff as trff
from test_torch_pathwise import SPECS, Replay, _ard, jax_kernel, record_draws
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-9


def _data(ard=False, n=150, seed=2):
    rng = np.random.default_rng(seed)
    if ard:
        x = rng.uniform(-2, 2, (n, 2))
        return x, np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n), rng.uniform(-2, 2, (19, 2))
    x = np.sort(rng.uniform(-3, 3, n))
    return x, np.sin(2 * x) + 0.1 * rng.standard_normal(n), np.linspace(-3, 3, 19)


@pytest.mark.parametrize("name", ["se", "periodic", "matern52", "ard"])
def test_fit_predict_and_draws_match_jax(name):
    x, y, xo = _data(ard=name == "ard")
    if name == "ard":
        jk, tk = _ard()
    else:
        jk, tk = jax_kernel(SPECS[name]), kernel_from_spec(SPECS[name])
    opts = dict(num_features=96, block_size=64, jitter=1e-6)
    with record_draws() as drawn:
        jpost = jrff.fit_rff(jk, x, y, 0.15, jax.random.PRNGKey(4), **opts)
    tpost = trff.fit_rff(tk, torch.as_tensor(x), torch.as_tensor(y), 0.15, Replay(drawn), **opts)
    np.testing.assert_allclose(float(tpost.log_marginal), float(jpost.log_marginal), rtol=RTOL)
    np.testing.assert_allclose(tpost.w_mean.numpy(), np.asarray(jpost.w_mean), rtol=RTOL,
                               atol=1e-12)
    for got, want in zip(trff.predict_rff(tpost, torch.as_tensor(xo)), jrff.predict_rff(jpost, xo)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)
    with record_draws() as drawn:
        want = jrff.sample_rff_posterior(jpost, xo, jax.random.PRNGKey(9), 5)
    got = trff.sample_rff_posterior(tpost, torch.as_tensor(xo), Replay(drawn), 5)
    assert got.shape == (5, xo.shape[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-11)
    if name == "periodic":  # the harmonic map: 2 * 47 + 1 features, no draws
        assert tpost.feats.num_features == 95


def test_rff_lml_approaches_the_exact_lml():
    x, y, _ = _data(n=120)
    k = kernel_from_spec(SPECS["se"])
    exact = float(gpt.log_marginal_likelihood(jax_kernel(SPECS["se"]), x, y, 0.15))
    post = trff.fit_rff(k, torch.as_tensor(x), torch.as_tensor(y), 0.15,
                        torch.Generator().manual_seed(0), num_features=2048)
    assert abs(float(post.log_marginal) - exact) < 0.05 * abs(exact)
