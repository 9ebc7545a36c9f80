"""Port warmup adaptation (inference/adaptation.py) against the JAX package:
dual averaging, Welford (batch and merge) and the warmup schedule on the
same inputs, float64, to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_processes_tpu.inference import adaptation as ja
from gaussian_processes_tpu_torch.inference import adaptation as ta

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


@pytest.mark.parametrize("num_warmup", [0, 100, 150, 500, 1000])
def test_warmup_schedule_matches_jax(num_warmup):
    got, want = ta.build_warmup_schedule(num_warmup), ja.build_warmup_schedule(num_warmup)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
