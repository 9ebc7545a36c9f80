"""Port ARD kernel (models/ard.py) and kernel B6 against the JAX package.

The kernel's K, dK/dtheta and d2K/dtheta2 agree with the JAX class to
rtol 1e-12 (atol 1e-12 of the largest value on Hessian planes, whose
d2K/dw_d^2 term cancels); B6's plain twin agrees with the JAX Pallas ARD
builder in interpret mode at block (128, 128) to rtol 1e-10; the exact fit
over (n, D) inputs agrees with the JAX fit to rtol 1e-10.  Float64 on the
CPU, numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import gp as jgp
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.convert import kernel_from_numpy
from gaussian_processes_tpu_torch.models import gp as tgp
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

H = 1.3
W = {2: np.array([0.8, 1.7]), 3: np.array([0.7, 1.2, 2.1])}


def _pair(D):
    return (gpt.ARDGaussianKernel(h=jnp.float64(H), w=jnp.asarray(W[D])),
            gpx.ARDGaussianKernel(H, torch.as_tensor(W[D])))


def _x(n, D, seed=0):
    return np.random.default_rng(seed).uniform(-2, 2, (n, D))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("D", [2, 3])
def test_kernel_matches_jax(D):
    jk, tk = _pair(D)
    x1, x2 = _x(30, D), _x(20, D, seed=1)
    _close(tk(_t(x1), _t(x2)), jk(x1, x2))
    _close(tk.jacobian(_t(x1), _t(x2)), jk.jacobian(x1, x2))
    H_want = np.asarray(jk.hessian(x1, x2))
    atol = 1e-12 * np.abs(H_want).max()
    _close(tk.hessian(_t(x1), _t(x2)), H_want, atol=atol)
    for p in range(1 + D):
        for q in range(1 + D):
            _close(tk.hessian_pair(_t(x1), _t(x2), p, q), jk.hessian_pair(x1, x2, p, q),
                   atol=atol)


def test_parameter_interface_matches_jax():
    jk, tk = _pair(3)
    assert tk.n_params == jk.n_params == 4
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    theta = np.asarray(jk.params) * 1.5
    np.testing.assert_array_equal(tk.with_params(_t(theta)).params.numpy(),
                                  np.asarray(jk.with_params(jnp.asarray(theta)).params))
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))  # unchanged
    xo = _x(7, 3)
    _close(tk.kdiag(_t(xo)), jk.kdiag(xo))
    assert [name for name, _ in tk.named_buffers()] == ["h", "w"]
    assert all(b.dtype == torch.float32 for b in tk.to(dtype=torch.float32).buffers())
    cp = tk.copy()
    cp.w.fill_(9.0)
    assert float(tk.w[0]) != 9.0
    with pytest.raises(ValueError, match="vector"):
        gpx.ARDGaussianKernel(1.0, 2.0)


def test_convert_ard_round_trip():
    jk, _ = _pair(2)
    tk = kernel_from_numpy("ard", np.asarray(jk.params))
    assert isinstance(tk, gpx.ARDGaussianKernel) and tk.params.dtype == torch.float64
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    x = _x(9, 2)
    _close(tk(_t(x), _t(x)), jk(x, x))


@pytest.mark.parametrize("noise", [None, 0.3])
def test_b6_twin_matches_pallas(noise):
    jk, tk = _pair(3)
    x1, x2 = _x(129, 3, seed=2), _x(257, 3, seed=3)
    x2 = x1 if noise is not None else x2
    want = jpw.pairwise_matrix_ard(jk, x1, x2, noise=noise, jitter=1e-6, block=(128, 128),
                                   interpret=True)
    got = tpw.pairwise_matrix_ard_reference(tk, _t(x1), _t(x2), noise=noise, jitter=1e-6)
    _close(got, want, rtol=1e-10)
    # the wrapper takes the twin for CPU tensors, and launches nothing
    before = dict(_build.launch_counts)
    np.testing.assert_array_equal(
        tpw.pairwise_matrix_ard(tk, _t(x1), _t(x2), noise=noise, jitter=1e-6).numpy(),
        got.numpy())
    assert dict(_build.launch_counts) == before


def test_b6_inputs_are_checked():
    _, tk = _pair(2)
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        tpw.pairwise_matrix_ard(tk, _t(_x(5, 3)), _t(_x(5, 3)))
    with pytest.raises(TypeError, match="ARDGaussianKernel"):
        tpw.pairwise_matrix_ard(gpx.GaussianKernel(1.0, 1.0), _t(_x(5, 2)), _t(_x(5, 2)))
    with pytest.raises(TypeError, match="float32"):
        tpw.pairwise_matrix_ard(tk, _t(_x(5, 2)), _t(_x(5, 2)).float())


def test_exact_fit_with_ard_matches_jax():
    jk, tk = _pair(2)
    rng = np.random.default_rng(4)
    x = _x(80, 2, seed=5)
    y = np.sin(2 * x[:, 0]) + 0.5 * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(80)
    xo = _x(15, 2, seed=6)
    jp = jgp.fit(jk, x, y, 0.2, jitter=1e-8)
    tp = tgp.fit(tk, _t(x), _t(y), 0.2, jitter=1e-8)
    _close(tgp.build_kxx(tk, _t(x), 0.2, 1e-8), jgp.build_kxx(jk, x, 0.2, 1e-8), rtol=1e-10)
    _close(tp.alpha, jp.alpha, rtol=1e-10)
    _close(tp.log_marginal, jp.log_marginal, rtol=1e-10)
    jm, jv = jgp.predict_diag(jp, xo)
    tm, tv = tgp.predict_diag(tp, _t(xo))
    _close(tm, jm, rtol=1e-10)
    _close(tv, jv, rtol=1e-10, atol=1e-12)
    jl, jg = jgp.log_marginal_value_and_grad(jk, x, y, 0.2, 1e-8)
    tl, tg = tgp.log_marginal_value_and_grad(tk, _t(x), _t(y), 0.2, 1e-8)
    _close(tg, jg, rtol=1e-10)
    # heteroscedastic noise goes through the same builder
    s = np.linspace(0.1, 0.3, 80)
    _close(tgp.build_kxx(tk, _t(x), _t(s)), jgp.build_kxx(jk, x, s), rtol=1e-10)
