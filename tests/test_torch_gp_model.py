"""Port hyperparameter posterior builders (inference/gp_model.py) against
the JAX package.

Same numpy-seeded data, float64 on the CPU.  The exact builders' values and
gradients (the port's analytic gradient through its autograd rule, JAX's
``jax.grad``) agree to 1e-10 relative; the iterative builder gets the JAX
package's probe draws, replayed (``Replay``), and agrees to the iterative
layer's 1e-6 (tests/test_torch_iterative.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.inference import gp_model as jgm
from gaussian_processes_tpu_torch.inference import gp_model as tgm
from test_torch_iterative import Replay, _precond_normals, _rademacher
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

FAMILIES = {"se": (gpt.GaussianKernel, gpx.GaussianKernel, (1.2, 0.6)),
            "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, (1.1, 0.8, 2.2))}


def _problem(family, n=40, seed=0):
    jcls, tcls, theta = FAMILIES[family]
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    return (jcls(*(jnp.asarray(v) for v in theta)), tcls(*theta, dtype=torch.float64), x, y)


def _points(P, seed=1):
    """Three points in u around log(theta) = 0."""
    return np.random.default_rng(seed).normal(0.0, 0.4, (3, P + 1))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pack_unpack_n_hypers_round_trip(family):
    jk, tk, _, _ = _problem(family)
    assert tgm.n_hypers(tk) == jgm.n_hypers(jk) == tk.n_params + 1
    u = tgm.pack(tk, 0.25)
    np.testing.assert_allclose(u.numpy(), np.asarray(jgm.pack(jk, 0.25)), rtol=1e-15)
    kernel, noise = tgm.unpack(tk, u)
    np.testing.assert_allclose(kernel.params.numpy(), tk.params.numpy(), rtol=1e-15)
    np.testing.assert_allclose(float(noise), 0.25, rtol=1e-15)
    assert type(kernel) is type(tk)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("builder", ["posterior", "likelihood"])
def test_exact_builders_value_and_autograd_match_jax(family, builder):
    jk, tk, x, y = _problem(family)
    if builder == "posterior":
        jf = jgm.make_log_posterior(jk, x, y, prior_mean=0.1, prior_std=1.5, jitter=1e-6)
        tf = tgm.make_log_posterior(tk, _t(x), _t(y), prior_mean=0.1, prior_std=1.5,
                                    jitter=1e-6)
    else:
        jf = jgm.make_log_likelihood(jk, x, y, jitter=1e-6)
        tf = tgm.make_log_likelihood(tk, _t(x), _t(y), jitter=1e-6)
    us = _points(tk.n_params)
    jvg = jax.value_and_grad(jf)
    for u in us:
        want_v, want_g = jvg(jnp.asarray(u))
        ut = _t(u).requires_grad_(True)
        value = tf(ut)
        (grad,) = torch.autograd.grad(value, ut)
        assert value.shape == ()
        np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=1e-10)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-10)
    # the chains form: (C, D) -> (C,), and value_and_grad without a graph
    values, grads = tf.value_and_grad(_t(us))
    assert values.shape == (3,) and grads.shape == us.shape and not values.requires_grad
    for c, u in enumerate(us):
        want_v, want_g = jvg(jnp.asarray(u))
        np.testing.assert_allclose(float(values[c]), float(want_v), rtol=1e-10)
        np.testing.assert_allclose(grads[c].numpy(), np.asarray(want_g), rtol=1e-10)
    # autograd through the chains form weighs each chain by its cotangent
    ut = _t(us).requires_grad_(True)
    w = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    (g,) = torch.autograd.grad((tf(ut) * w).sum(), ut)
    np.testing.assert_allclose(g.numpy(), (w[:, None] * grads).numpy(), rtol=1e-14)


@pytest.mark.parametrize("precond_rank", [0, 30])
def test_iterative_posterior_matches_jax_with_frozen_probes(precond_rank):
    jk, tk, x, y = _problem("se", n=70, seed=3)
    key = jax.random.key(5)
    opts = dict(num_probes=4, num_iters=70, tol=1e-10, block_size=32,
                precond_rank=precond_rank)
    jf = jgm.make_log_posterior_iterative(jk, x, y, probe_key=key, prior_std=1.5, **opts)
    draws = [_rademacher(key, 70, 4)]
    if precond_rank:
        draws += _precond_normals(key, precond_rank, 70, 4)
    tf = tgm.make_log_posterior_iterative(tk, _t(x), _t(y), probe_generator=Replay(*draws),
                                          prior_std=1.5, **opts)
    jvg = jax.value_and_grad(jf)
    # every evaluation reuses the first one's draws (Replay holds one set)
    us = _points(2, seed=4)
    for u in us:
        want_v, want_g = jvg(jnp.asarray(u))
        ut = _t(u).requires_grad_(True)
        value = tf(ut)
        (grad,) = torch.autograd.grad(value, ut)
        np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-6)
    values, _ = tf.value_and_grad(_t(us))
    np.testing.assert_allclose(values.numpy(), [float(jf(jnp.asarray(u))) for u in us],
                               rtol=1e-6)


def test_iterative_posterior_default_probes_are_frozen():
    _, tk, x, y = _problem("se", n=50, seed=6)
    tf = tgm.make_log_posterior_iterative(tk, _t(x), _t(y), num_probes=3, num_iters=50,
                                          tol=1e-10, block_size=32)
    u = _t(_points(2)[0])
    first = tf.value_and_grad(u)
    tf.value_and_grad(u + 0.1)
    again = tf.value_and_grad(u)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_init_positions_draws_by_the_jax_law():
    _, tk, _, _ = _problem("periodic")
    u = tgm.init_positions(tk, 0.1, torch.Generator().manual_seed(3), n_chains=6, spread=0.2)
    eps = torch.randn((6, 4), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    np.testing.assert_allclose(u.numpy(), (tgm.pack(tk, 0.1)[None] + 0.2 * eps).numpy(),
                               rtol=1e-15)
    u32 = tgm.init_positions(tk, 0.1, torch.Generator(), 2, dtype=torch.float32)
    assert u32.dtype == torch.float32 and u32.shape == (2, 4)


def test_whittle_builders_match_jax():
    jk, tk, _, _ = _problem("se")
    n = 128
    x = np.arange(n) * (6.0 / n) - 3.0
    y = np.sin(2 * x) + 0.1 * np.random.default_rng(3).standard_normal(n)
    u = _points(2)
    jlp = jgm.make_log_posterior_whittle(jk, x, y, prior_std=1.5)
    tlp = tgm.make_log_posterior_whittle(tk, _t(x), _t(y), prior_std=1.5)
    jv, jg = jax.vmap(jax.value_and_grad(jlp))(jnp.asarray(u))
    tv, tg = tlp.value_and_grad(_t(u))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)
    ard_j = gpt.ARDGaussianKernel(jnp.float64(1.0), jnp.asarray([0.5, 0.7]))
    ard_t = gpx.ARDGaussianKernel(1.0, torch.tensor([0.5, 0.7], dtype=torch.float64))
    from gaussian_processes_tpu.ops.kronecker import KronOperator
    from gaussian_processes_tpu_torch.convert import kron_operator_from_numpy

    g = np.arange(16) / 16.0
    y2 = np.sin(2 * np.pi * np.add.outer(g, g)).reshape(-1)
    jk2 = jgm.make_log_posterior_whittle_kron(ard_j, KronOperator(axes=(jnp.asarray(g),) * 2),
                                              jnp.asarray(y2))
    tk2 = tgm.make_log_posterior_whittle_kron(ard_t, kron_operator_from_numpy((g, g)), _t(y2))
    u2 = np.log(np.array([1.0, 0.5, 0.7, 0.2]))
    jv2, jg2 = jax.value_and_grad(jk2)(jnp.asarray(u2))
    tv2, tg2 = tk2.value_and_grad(_t(u2))
    np.testing.assert_allclose(float(tv2), float(jv2), rtol=1e-10)
    np.testing.assert_allclose(tg2.numpy(), np.asarray(jg2), rtol=1e-10, atol=1e-10)
