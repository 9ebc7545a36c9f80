"""Port kernels (gaussian_processes_tpu_torch.models) against the JAX classes.

Same numpy-seeded inputs through both packages in float64 on the CPU; the
closed forms are the same expressions, so values agree to rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu_torch.convert import kernel_from_numpy
from gaussian_processes_tpu_torch.models.base import tri_index
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-12

FAMILIES = {
    "se": (gpt.GaussianKernel, gpx.GaussianKernel, (1.3, 0.7)),
    "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, (0.9, 1.1, 2.0)),
}


def _pair(family):
    jcls, tcls, theta = FAMILIES[family]
    return jcls(*(jnp.asarray(v) for v in theta)), tcls(*theta, dtype=torch.float64)


def _inputs(seed=0, n=40, m=30):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(-3, 3, n)), np.sort(rng.uniform(-3, 3, m))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_K_matches_jax(family):
    jk, tk = _pair(family)
    x1, x2 = _inputs()
    np.testing.assert_allclose(tk(_t(x1), _t(x2)).numpy(),
                               np.asarray(jk(x1, x2)), rtol=RTOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jacobian_matches_jax(family):
    jk, tk = _pair(family)
    x1, x2 = _inputs(1)
    got = tk.jacobian(_t(x1), _t(x2))
    assert got.shape == (tk.n_params, x1.size, x2.size)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.jacobian(x1, x2)), rtol=RTOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hessian_matches_jax(family):
    jk, tk = _pair(family)
    x1, x2 = _inputs(2)
    got = tk.hessian(_t(x1), _t(x2))
    P = tk.n_params
    assert got.shape == (P, P, x1.size, x2.size)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.hessian(x1, x2)), rtol=RTOL)
    np.testing.assert_array_equal(got.numpy(), got.transpose(0, 1).numpy())


@pytest.mark.parametrize(
    "family,p,q",
    [("se", p, q) for p in range(2) for q in range(2)]
    + [("periodic", p, q) for p in range(3) for q in range(3)],
)
def test_hessian_pair_matches_jax(family, p, q):
    jk, tk = _pair(family)
    x1, x2 = _inputs(3)
    got = tk.hessian_pair(_t(x1), _t(x2), p, q)
    assert got.shape == (x1.size, x2.size)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.hessian_pair(x1, x2, p, q)),
                               rtol=RTOL)


def test_tri_index_matches_jax_formula():
    for P in (1, 2, 3, 4):
        order = [(i, j) for i in range(P) for j in range(i, P)]
        for t, (i, j) in enumerate(order):
            assert tri_index(i, j, P) == t == tri_index(j, i, P)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kdiag_params_with_params(family):
    jk, tk = _pair(family)
    xo = np.linspace(-2, 2, 7)
    np.testing.assert_allclose(tk.kdiag(_t(xo)).numpy(), np.asarray(jk.kdiag(xo)), rtol=RTOL)
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    assert tk.n_params == jk.n_params
    theta = np.asarray(jk.params) * 1.25
    tk2, jk2 = tk.with_params(torch.as_tensor(theta)), jk.with_params(jnp.asarray(theta))
    np.testing.assert_array_equal(tk2.params.numpy(), np.asarray(jk2.params))
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))  # unchanged
    x1, x2 = _inputs(4)
    np.testing.assert_allclose(tk2(_t(x1), _t(x2)).numpy(), np.asarray(jk2(x1, x2)),
                               rtol=RTOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_round_trip(family):
    jk, _ = _pair(family)
    tk = kernel_from_numpy(family, np.asarray(jk.params))
    assert tk.params.dtype == torch.float64
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    back = jk.with_params(jnp.asarray(tk.params.numpy()))
    np.testing.assert_array_equal(np.asarray(back.params), np.asarray(jk.params))
    x1, x2 = _inputs(5)
    np.testing.assert_allclose(tk(_t(x1), _t(x2)).numpy(), np.asarray(jk(x1, x2)), rtol=RTOL)


def test_convert_rejects_unknown_family():
    with pytest.raises(ValueError, match="unknown kernel family"):
        kernel_from_numpy("laplace", np.ones(2))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hyperparameters_are_buffers(family):
    _, tk = _pair(family)
    assert [name for name, _ in tk.named_buffers()] == list(tk.param_names)
    assert list(tk.parameters()) == []
    k32 = tk.to(dtype=torch.float32)
    assert all(b.dtype == torch.float32 for b in k32.buffers())
    cp = tk.copy()
    cp.h.fill_(9.0)
    assert float(tk.h) != 9.0


def test_with_params_wrong_length_raises():
    _, tk = _pair("se")
    with pytest.raises(TypeError):
        tk.with_params(torch.ones(3, dtype=torch.float64))
