"""Port MCMC diagnostics (the port's own copy of inference/diagnostics.py)
against the JAX package's on the same numpy draws: split-R-hat, ESS and the
summary agree to 1e-12."""

import numpy as np
import pytest

from gaussian_processes_tpu.inference import diagnostics as jd
from gaussian_processes_tpu_torch.inference import diagnostics as td
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)


def _draws(S, C, D, seed=0, rho=0.6):
    """AR(1) chains with per-chain offsets: correlated, slightly unmixed."""
    rng = np.random.default_rng(seed)
    x = np.zeros((S, C, D))
    e = rng.standard_normal((S, C, D))
    for t in range(1, S):
        x[t] = rho * x[t - 1] + e[t]
    return x + 0.1 * rng.standard_normal((1, C, D))


@pytest.mark.parametrize("shape", [(200, 4, 3), (101, 1, 2), (64, 8, 1)])
def test_rhat_ess_summary_match_jax(shape):
    d = _draws(*shape)
    np.testing.assert_allclose(td.split_rhat(d), jd.split_rhat(d), rtol=1e-12)
    np.testing.assert_allclose(td.ess(d), jd.ess(d), rtol=1e-12)
    got, want = td.summarize(d, wall_s=2.5), jd.summarize(d, wall_s=2.5)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


def test_constant_chains_give_the_same_non_finite_answers():
    d = np.ones((50, 4, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(np.isnan(td.split_rhat(d)), np.isnan(jd.split_rhat(d)))
    np.testing.assert_array_equal(np.isnan(td.ess(d)), np.isnan(jd.ess(d)))
