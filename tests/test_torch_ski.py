"""Port SKI layer (ops/ski.py, 1-D and N-D, with ski_kron_refine) against the JAX package.

float64 on the CPU on numpy-seeded scattered inputs; the port gets the JAX
package's own operators (``convert``) and random draws (``Replay``).  The
interpolation products agree to rel 1e-10, the iterative fits to rel 1e-8.
The port's scatter W^T v sums each grid point's taps as one segment of the
taps sorted by grid point, in a fixed order, so it repeats bit for bit, and
its tables are O(n * taps) however the inputs cluster.  ``ski_kron_refine`` (float64 residual here, two-float
in the JAX package) runs in float32 as the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.models import iterative_gp as jit_gp
from gaussian_processes_tpu.ops import kronecker as jkron
from gaussian_processes_tpu.ops import ski as jski
from gaussian_processes_tpu_torch import ARDGaussianKernel
from gaussian_processes_tpu_torch.convert import (
    ski_kron_operator_from_numpy,
    ski_operator_from_numpy,
)
from gaussian_processes_tpu_torch.models import iterative_gp as tit_gp
from gaussian_processes_tpu_torch.ops import ski as tski
from test_torch_iterative import Replay
from test_torch_toeplitz import FIT_RTOL, close, pair, t
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

F64 = jnp.float64
NOISE = 0.3


def _scattered(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    return x, np.sin(2 * x) + 0.1 * rng.standard_normal(n)


def _ops(x, m=64):
    jop = jski.interpolation_weights(jnp.asarray(x), jski.make_grid(jnp.asarray(x), m))
    return jop, ski_operator_from_numpy(jop.grid, jop.idx, jop.w)


def test_geometry_matches_jax():
    x, _ = _scattered()
    jg = jski.make_grid(jnp.asarray(x), 64)
    close(tski.make_grid(t(x), 64), jg)
    xo = np.concatenate([x[:5], [-10.0, 10.0]])  # out-of-range points snap to the edge
    jop = jski.interpolation_weights(jnp.asarray(xo), jg)
    top = tski.interpolation_weights(t(xo), t(jg))
    np.testing.assert_array_equal(top.idx.numpy(), np.asarray(jop.idx))
    close(top.w, jop.w)
    close(tski._cubic_weights(t(np.linspace(0, 1, 11))),
          jski._cubic_weights(jnp.linspace(0, 1, 11)))
    with pytest.raises(ValueError, match=">= 8"):
        tski.make_grid(t(x), 7)


@pytest.mark.parametrize("name", ["se", "matern52"])
def test_interpolation_products_match_jax(name):
    jk, tk = pair(name)
    x, _ = _scattered(seed=1)
    jop, top = _ops(x)
    rng = np.random.default_rng(2)
    vg, vn = rng.standard_normal((64, 3)), rng.standard_normal((300, 3))
    close(tski.interp_matvec(top, t(vg)), jski.interp_matvec(jop, vg))
    close(tski.interp_rmatvec(top, t(vn)), jski.interp_rmatvec(jop, vn))
    close(tski.interp_rmatvec(top, t(vn[:, 0])), jski.interp_rmatvec(jop, vn[:, 0]))
    close(tski.kernel_matvec_ski(tk, top, t(vn), NOISE, 1e-6),
          jski.kernel_matvec_ski(jk, jop, vn, NOISE, 1e-6))
    close(tski.ski_dense(tk, top), jski.ski_dense(jk, jop))
    # the fixed-order scatter repeats bit for bit
    a = tski.interp_rmatvec(top, t(vn))
    assert torch.equal(a, tski.interp_rmatvec(top, t(vn)))


@pytest.mark.parametrize("ndim", [1, 2])
def test_clustered_scatter_is_linear_in_n_and_repeats(ndim):
    # 3/4 of the inputs inside one grid cell: that cell's grid points carry
    # ~n taps each, where a table padded to the busiest point would be m x n
    rng = np.random.default_rng(10)
    n, m1 = 2000, 24
    x = rng.uniform(-1, 1, (n, ndim))
    x[: 3 * n // 4] = 0.013 + 1e-3 * rng.standard_normal((3 * n // 4, ndim))
    xj = jnp.asarray(x)
    if ndim == 1:
        jop = jski.interpolation_weights(xj[:, 0], jski.make_grid(xj[:, 0], m1))
        top = ski_operator_from_numpy(jop.grid, jop.idx, jop.w)
        jrm, trm, m = jski.interp_rmatvec, tski.interp_rmatvec, m1
    else:
        jop = jski.interpolation_weights_nd(xj, tuple(jski.make_grid(xj[:, d], m1)
                                                      for d in range(ndim)))
        top = ski_kron_operator_from_numpy(jop.kron.axes, jop.idx, jop.w)
        jrm, trm, m = jski.interp_rmatvec_nd, tski.interp_rmatvec_nd, m1 ** ndim
    taps = n * 4 ** ndim
    assert int(top.seg_len.max()) >= 3 * n // 4
    assert top.seg_pts.numel() == top.seg_w.numel() == int(top.seg_len.sum()) == taps
    assert top.seg_len.numel() == m
    vn = rng.standard_normal((n, 3))
    got = trm(top, t(vn))
    close(got, jrm(jop, vn))
    assert torch.equal(got, trm(top, t(vn)))
    close(trm(top, t(vn[:, 1])), jrm(jop, vn[:, 1]))


def _nd_problem(n=256, m1=12, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    xj = jnp.asarray(x)
    g = jski.make_grid(xj[:, 0], m1), jski.make_grid(xj[:, 1], m1)
    jop = jski.interpolation_weights_nd(xj, g)
    top = ski_kron_operator_from_numpy(jop.kron.axes, jop.idx, jop.w)
    jk = gpt.ARDGaussianKernel(F64(1.0), jnp.asarray([0.4, 0.5]))
    tk = ARDGaussianKernel(1.0, torch.tensor([0.4, 0.5], dtype=torch.float64))
    return jk, tk, jop, top, x, y


def test_nd_interpolation_matches_jax():
    jk, tk, jop, top, x, y = _nd_problem()
    xo = np.random.default_rng(4).uniform(-1, 1, (9, 2))
    built = tski.interpolation_weights_nd(t(xo), top.kron.axes)
    jb = jski.interpolation_weights_nd(jnp.asarray(xo), jop.kron.axes)
    np.testing.assert_array_equal(built.idx.numpy(), np.asarray(jb.idx))
    close(built.w, jb.w)
    rows, wts = tski._nd_taps(top)
    jrows, jwts = jski._nd_taps(jop)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    close(wts, jwts)
    rng = np.random.default_rng(5)
    vg, vn = rng.standard_normal((144, 2)), rng.standard_normal((256, 2))
    close(tski.interp_matvec_nd(top, t(vg)), jski.interp_matvec_nd(jop, vg))
    close(tski.interp_rmatvec_nd(top, t(vn)), jski.interp_rmatvec_nd(jop, vn))
    jc = [np.asarray(c) for c in jkron.kron_columns(jk, jop.kron)]
    close(tski.ski_kron_matvec(top, [t(c) for c in jc], t(vn), 0.1),
          jski.ski_kron_matvec(jop, jc, vn, 0.1))
    close(tski.ski_kron_dense(tk, top), jski.ski_kron_dense(jk, jop))


def _rademacher(key, n, r):
    return np.asarray(jax.random.rademacher(key, (n, r), dtype=F64))


@pytest.mark.parametrize("precond_rank", [0, 30])
def test_fit_predict_and_grad_ski_match_jax(precond_rank):
    jk, tk = pair("se")
    x, y = _scattered(n=200, seed=6)
    jop, top = _ops(x, m=48)
    key = jax.random.key(0)
    opts = dict(num_probes=4, num_iters=100, tol=1e-10, precond_rank=precond_rank)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, structure=jop, **opts)
    if precond_rank:
        k1, k2 = jax.random.split(jax.random.split(key)[0])
        draws = [np.asarray(jax.random.normal(k1, (30, 4), F64)),
                 np.asarray(jax.random.normal(k2, (200, 4), F64))]
    else:
        draws = [_rademacher(key, 200, 4)]
    tp = tit_gp.fit_iterative(tk, t(x), t(y), NOISE, Replay(*draws), structure=top, **opts)
    close(tp.alpha, jp.alpha, FIT_RTOL)
    close(tp.log_marginal, jp.log_marginal, FIT_RTOL)
    xo = np.linspace(-2.9, 2.9, 7)
    close(tit_gp.predict_mean_iterative(tp, t(xo), structure=top),
          jit_gp.predict_mean_iterative(jp, xo, structure=jop), FIT_RTOL)
    jl, jg = jit_gp.log_marginal_value_and_grad_iterative(jk, x, y, NOISE, key, structure=jop,
                                                          **opts)
    tl, tg = tit_gp.log_marginal_value_and_grad_iterative(
        tk, t(x), t(y), NOISE, Replay(_rademacher(key, 200, 4), *draws[:2 if precond_rank else 0]),
        structure=top, **opts)
    close(tl, jl, FIT_RTOL)
    close(tg, jg, FIT_RTOL)


def test_fit_predict_and_grad_ski_kron_match_jax():
    jk, tk, jop, top, x, y = _nd_problem(seed=7)
    key = jax.random.key(1)
    opts = dict(num_probes=4, num_iters=120, tol=1e-10)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, structure=jop, **opts)
    tp = tit_gp.fit_iterative(tk, t(x), t(y), NOISE, Replay(_rademacher(key, 256, 4)),
                              structure=top, **opts)
    close(tp.alpha, jp.alpha, FIT_RTOL)
    close(tp.log_marginal, jp.log_marginal, FIT_RTOL)
    xo = np.random.default_rng(8).uniform(-0.9, 0.9, (6, 2))
    close(tit_gp.predict_mean_iterative(tp, t(xo), structure=top),
          jit_gp.predict_mean_iterative(jp, xo, structure=jop), FIT_RTOL)
    jl, jg = jit_gp.log_marginal_value_and_grad_iterative(jk, x, y, NOISE, key, structure=jop,
                                                          **opts)
    tl, tg = tit_gp.log_marginal_value_and_grad_iterative(
        tk, t(x), t(y), NOISE, Replay(_rademacher(key, 256, 4)), structure=top, **opts)
    close(tl, jl, FIT_RTOL)
    close(tg, jg, FIT_RTOL)


def test_ski_kron_refine_matches_jax():
    rng = np.random.default_rng(9)
    n = 400
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.1 * rng.standard_normal(n)).astype(
        np.float32)
    xj = jnp.asarray(x)
    jop = jski.interpolation_weights_nd(xj, (jski.make_grid(xj[:, 0], 16),
                                             jski.make_grid(xj[:, 1], 16)))
    jk = gpt.ARDGaussianKernel(jnp.float32(1.0), jnp.asarray([0.3, 0.3], jnp.float32))
    opts = dict(jitter=1e-4, rounds=2, num_iters=60)
    jp = jit_gp.fit_iterative(jk, xj, jnp.asarray(y), 0.1, jax.random.key(0), num_probes=2,
                              num_iters=60, tol=1e-7, jitter=1e-4, precond_rank=64,
                              structure=jop, replace_every=10)
    alpha = np.asarray(jp.alpha)  # the fit's float32 solution, refined by both
    (jh, jl), jrel = jski.ski_kron_refine(jk, jop, x, jnp.asarray(alpha), jnp.asarray(y), 0.1,
                                          precond_rank=64, **opts)
    top = ski_kron_operator_from_numpy(jop.kron.axes, jop.idx, jop.w, dtype=torch.float32)
    tk = ARDGaussianKernel(1.0, torch.tensor([0.3, 0.3]))
    (th, tl), trel = tski.ski_kron_refine(tk, top, t(x), t(alpha), t(y), 0.1, precond_rank=64,
                                          **opts)
    want = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    got = th.double().numpy() + tl.double().numpy()
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    assert float(trel) <= float(jrel)
    assert th.dtype == tl.dtype == torch.float32
    with pytest.raises(ValueError, match="plan"):
        tski.ski_kron_refine(tk, top, t(x), t(alpha), t(y), 0.1, plan=object())
