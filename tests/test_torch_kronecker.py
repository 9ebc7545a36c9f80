"""Port Kronecker layer (ops/kronecker.py, structure=KronOperator) against the JAX package.

float64 on the CPU on a 2-D Cartesian grid with numpy-seeded data; the port
gets the JAX package's random draws (``Replay``).  Columns, matvecs, spectra
and logdets agree to rel 1e-10, the iterative fits to rel 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.models import iterative_gp as jit_gp
from gaussian_processes_tpu.ops import kronecker as jkron
from gaussian_processes_tpu_torch import ARDGaussianKernel, GaussianKernel
from gaussian_processes_tpu_torch.convert import kron_operator_from_numpy
from gaussian_processes_tpu_torch.models import iterative_gp as tit_gp
from gaussian_processes_tpu_torch.ops import kronecker as tkron
from test_torch_iterative import Replay
from test_torch_toeplitz import FIT_RTOL, close, t
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

F64 = jnp.float64
W = (0.15, 0.25)


def _problem(n1=16, n2=12, seed=0):
    g1 = np.arange(n1) * (2.0 / n1) - 1.0
    g2 = np.arange(n2) * (1.5 / n2)
    jop = jkron.KronOperator(axes=(jnp.asarray(g1), jnp.asarray(g2)))
    top = kron_operator_from_numpy((g1, g2))
    x = np.asarray(jkron.kron_inputs(jop.axes))
    rng = np.random.default_rng(seed)
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.1 * rng.standard_normal(x.shape[0])
    jk = gpt.ARDGaussianKernel(F64(1.2), jnp.asarray(W))
    tk = ARDGaussianKernel(1.2, torch.tensor(W, dtype=torch.float64))
    return jk, tk, jop, top, x, y


def test_columns_matvecs_and_spectra_match_jax():
    jk, tk, jop, top, x, y = _problem()
    assert top.shape == jop.shape and top.n == jop.n and top.ndim == jop.ndim
    close(tkron.kron_inputs(top.axes), jkron.kron_inputs(jop.axes))
    tcols, jcols = tkron.kron_columns(tk, top), jkron.kron_columns(jk, jop)
    for a, b in zip(tcols, jcols):
        close(a, b)
    for tc, jc in zip(tkron.kron_jacobian_columns(tk, top), jkron.kron_jacobian_columns(jk, jop)):
        for a, b in zip(tc, jc):
            close(a, b)
    v = np.random.default_rng(1).standard_normal((jop.n, 3))
    jc = [np.asarray(c) for c in jcols]
    close(tkron.kron_matvec([t(c) for c in jc], t(v), 0.05), jkron.kron_matvec(jc, v, 0.05))
    close(tkron.kernel_matvec_kron(tk, top, t(v[:, 0]), 0.3, 1e-6),
          jkron.kernel_matvec_kron(jk, jop, v[:, 0], 0.3, 1e-6))
    close(tkron.kron_circulant_spectrum([t(c) for c in jc], 0.05),
          jkron.kron_circulant_spectrum(jc, 0.05))
    close(tkron.kron_circulant_spectrum_analytic(tk, top, 0.05),
          jkron.kron_circulant_spectrum_analytic(jk, jop, 0.05))
    close(tkron.kron_circulant_precond([t(c) for c in jc], 0.05)(t(v)),
          jkron.kron_circulant_precond(jc, 0.05)(v))
    # the dense Kronecker product is the kernel matrix on the grid
    K = tk(t(x), t(x)).numpy()
    close(tkron.kron_matvec(tcols, t(v)), K @ v)


def test_slq_logdet_kron_circulant_matches_jax():
    jk, tk, jop, top, x, y = _problem()
    jc = [np.asarray(c) for c in jkron.kron_columns(jk, jop)]
    key = jax.random.key(2)
    want = jkron.slq_logdet_kron_circulant(lambda v: jkron.kron_matvec(jc, v, 0.09), jc, 0.09,
                                           key, 5, 40)
    u = np.asarray(jax.random.normal(key, (jop.n, 5), F64))
    got = tkron.slq_logdet_kron_circulant(lambda v: tkron.kron_matvec([t(c) for c in jc], v, 0.09),
                                          [t(c) for c in jc], 0.09, Replay(u), 5, 40)
    close(got, want, FIT_RTOL)


NOISE = 0.3


def _normals(key, n, r):
    return np.asarray(jax.random.normal(jax.random.split(key)[0], (n, r), F64))


def test_fit_and_predict_kron_match_jax():
    jk, tk, jop, top, x, y = _problem(seed=3)
    key = jax.random.key(0)
    opts = dict(num_probes=5, num_iters=100, tol=1e-10)
    jp = jit_gp.fit_iterative(jk, x, y, NOISE, key, structure=jop, **opts)
    tp = tit_gp.fit_iterative(tk, t(x), t(y), NOISE, Replay(_normals(key, jop.n, 5)),
                              structure=top, **opts)
    close(tp.alpha, jp.alpha, FIT_RTOL)
    close(tp.log_marginal, jp.log_marginal, FIT_RTOL)
    xo = np.random.default_rng(4).uniform(-1.0, 1.4, (7, 2))
    dopts = dict(num_iters=100, tol=1e-10)
    jm, jv = jit_gp.predict_diag_iterative(jp, xo, structure=jop, **dopts)
    tm, tv = tit_gp.predict_diag_iterative(tp, t(xo), structure=top, **dopts)
    close(tm, jm, FIT_RTOL)
    close(tv, jv, FIT_RTOL)


def test_value_and_grad_kron_matches_jax():
    jk, tk, jop, top, x, y = _problem(seed=5)
    key = jax.random.key(1)
    opts = dict(num_probes=4, num_iters=100, tol=1e-10)
    jl, jg = jit_gp.log_marginal_value_and_grad_iterative(jk, x, y, NOISE, key, structure=jop,
                                                          **opts)
    draws = Replay(np.asarray(jax.random.rademacher(key, (jop.n, 4), dtype=F64)),
                   _normals(key, jop.n, 4))
    tl, tg = tit_gp.log_marginal_value_and_grad_iterative(tk, t(x), t(y), NOISE, draws,
                                                          structure=top, **opts)
    close(tl, jl, FIT_RTOL)
    close(tg, jg, FIT_RTOL)


def test_kron_structure_needs_the_ard_kernel():
    _, _, _, top, x, y = _problem()
    with pytest.raises(NotImplementedError, match="ARDGaussianKernel"):
        tkron.kron_columns(GaussianKernel(1.0, 1.0, dtype=torch.float64), top)
    with pytest.raises(ValueError, match="lengthscales"):
        tkron.kron_columns(ARDGaussianKernel(1.0, torch.ones(3, dtype=torch.float64)), top)

