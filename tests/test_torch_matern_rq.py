"""Matérn 3/2, Matérn 5/2 and rational-quadratic kernels against the JAX
package.

Each leaf's closed forms (``k_fn``, ``jac_fn``, ``hess_fn``), its one-plane
Hessian (``hessian_pair``, and ``hessian_plane_folded``, kernel B2b's
arithmetic) and B4's and B5's folded arithmetic (``folded_values``) are held
against the JAX class's closed forms, rtol 1e-12 with an atol of 1e-12 of the
array's largest value (the Hessian planes cross zero, and RQ's a-derivative
z / (aB) - ln B cancels at small d, where a one-ulp difference is no longer
small relative to the value).  The plain versions of B1, B2a, B2b, B4 and B5
(the CPU path of each wrapper) are held against the JAX Pallas builders in
interpret mode, as tests/test_pairwise_pallas.py and
tests/test_iterative.py run them; the exact log marginal likelihood, its
gradient and Hessian (whole and pair at a time), the chain-table value and
gradient and the matrix-free stochastic gradient against the JAX functions.
float64 and numpy-seeded inputs throughout; float32 only where B4's and
B5's folded arithmetic is held to the float64 closed forms (1e-5 of the row
sums of absolute terms, the kernel tests' allowance).  The kernels
themselves run on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import iterative_gp as jit_gp
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu.utils import config as jconfig
from gaussian_processes_tpu_torch.convert import kernel_from_numpy, kernel_from_spec
from gaussian_processes_tpu_torch.models import gp as tgp
from gaussian_processes_tpu_torch.models import iterative_gp as tit_gp
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from gaussian_processes_tpu_torch.utils import config as tconfig
from test_torch_iterative import Replay, _precond_normals, _rademacher
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-12
BLOCK = (128, 128)
FAMILIES = {
    "matern32": (gpt.Matern32Kernel, gpx.Matern32Kernel, (1.3, 0.7)),
    "matern52": (gpt.Matern52Kernel, gpx.Matern52Kernel, (1.1, 0.9)),
    "rq": (gpt.RationalQuadraticKernel, gpx.RationalQuadraticKernel, (0.9, 1.1, 1.5)),
}


def _pair(family, theta=None):
    jcls, tcls, default = FAMILIES[family]
    theta = default if theta is None else theta
    return jcls(*(jnp.asarray(v) for v in theta)), tcls(*theta, dtype=torch.float64)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(-3, 3, n)), np.sort(rng.uniform(-3, 3, m))


# d from -4 to 4 with 0 and values around it, where |d| and the Matérn
# derivatives' u^2 are sharpest
D = np.concatenate([np.linspace(-4, 4, 81), [0.0, 1e-9, -1e-9, 1e-4, -3e-3]])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_closed_forms_match_jax(family):
    jk, tk = _pair(family)
    jp, tp = jk._param_values(), tk.params.unbind(0)
    jcls = type(jk)
    _close(type(tk).k_fn(_t(D), *tp), jcls.k_fn(jnp.asarray(D), *jp))
    for got, want in zip(type(tk).jac_fn(_t(D), *tp), jcls.jac_fn(jnp.asarray(D), *jp)):
        _close(got, want)
    got_h, want_h = type(tk).hess_fn(_t(D), *tp), jcls.hess_fn(jnp.asarray(D), *jp)
    assert len(got_h) == len(want_h) == tk.n_params * (tk.n_params + 1) // 2
    for got, want in zip(got_h, want_h):
        _close(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hessian_pairs_and_folded_planes_match_jax(family):
    jk, tk = _pair(family)
    x1, x2 = _inputs(40, 29, seed=1)
    P = tk.n_params
    for p in range(P):
        for q in range(P):
            want = jk.hessian_pair(x1, x2, p, q)
            _close(tk.hessian_pair(_t(x1), _t(x2), p, q), want)
            _close(tpw.hessian_plane_folded(tk, _t(x1), _t(x2), (p, q)), want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_folded_values_match_jax_closed_forms(family):
    """B4's and B5's planes times their row constants are k and dK/dtheta;
    at d = 0 the K plane is exactly 1 and a Matérn w-plane exactly 0."""
    jk, tk = _pair(family)
    x1, x2 = _inputs(50, 37, seed=2)
    planes, scale = tpw.folded_values(tk, _t(x1), _t(x2))
    _close(scale[0] * planes[0], jk(x1, x2))
    planes, scale = tpw.folded_values(tk, _t(x1), _t(x2), jac=True)
    for got_plane, c, want in zip(planes, scale, jk.jacobian(x1, x2)):
        _close(c * got_plane, want)
    for dtype in (torch.float32, torch.float64):
        x = _t(x1, dtype)
        planes, _ = tpw.folded_values(tk, x, x, jac=True)
        assert torch.equal(planes[0].diagonal(), torch.ones(50, dtype=dtype))
        if family != "rq":
            assert torch.equal(planes[1].diagonal(), torch.zeros(50, dtype=dtype))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n,m", [(64, 64), (300, 200), (129, 257)])
def test_pairwise_twins_match_pallas(family, n, m):
    jk, tk = _pair(family)
    x1, x2 = _inputs(n, m, seed=3)
    before = dict(_build.launch_counts)
    _close(tpw.pairwise_matrix(tk, _t(x1), _t(x2)),
           jpw.pairwise_matrix(jk, x1, x2, block=BLOCK, interpret=True))
    _close(tpw.pairwise_jacobian(tk, _t(x1), _t(x2)),
           jpw.pairwise_jacobian(jk, x1, x2, block=BLOCK, interpret=True))
    _close(tpw.pairwise_hessian(tk, _t(x1), _t(x2)),
           jpw.pairwise_hessian(jk, x1, x2, block=BLOCK, interpret=True))
    assert dict(_build.launch_counts) == before  # CPU tensors never launch


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pairwise_with_diag_matches_pallas(family):
    jk, tk = _pair(family)
    x1, _ = _inputs(200, 1, seed=4)
    _close(tpw.pairwise_matrix(tk, _t(x1), _t(x1), noise=0.3, jitter=1e-6),
           jpw.pairwise_matrix(jk, x1, x1, noise=0.3, jitter=1e-6, block=BLOCK,
                               interpret=True))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("r", [1, 9])
def test_product_twins_match_pallas(family, r):
    """B4's and B5's plain versions against the JAX fused matvec and
    Jacobian product at n = 300, not a tile multiple (rtol 1e-9, as
    tests/test_iterative.py holds the JAX package's own)."""
    jk, tk = _pair(family)
    x, _ = _inputs(300, 1, seed=5)
    v = np.random.default_rng(6).standard_normal((300, r))
    want = jpw.kernel_matvec_fused(jk, x, v, 0.2, 1e-8, block=BLOCK, interpret=True)
    for got in (tpw.kernel_matvec_fused(tk, _t(x), _t(v), 0.2, 1e-8),
                tpw.matvec_folded_reference(tk, _t(x), _t(v))
                + tpw._diag_term(0.2, 1e-8, _t(x)) * _t(v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-11)
    want = jpw.kernel_jacvec_fused(jk, x, v, block=BLOCK, interpret=True)
    for got in (tpw.kernel_jacvec_fused(tk, _t(x), _t(v)),
                tpw.jacvec_folded_reference(tk, _t(x), _t(v))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_folded_float32_products_hold_the_float64_closed_forms(family):
    """B4's and B5's float32 arithmetic (exp2 and log2 of the folded
    exponents) against float64 K and dK/dtheta of the same float32 inputs,
    within 1e-5 of the row sums of absolute terms."""
    _, tk = _pair(family)
    x, _ = _inputs(257, 1, seed=7)
    x32 = _t(x, torch.float32)
    v32 = _t(np.random.default_rng(8).standard_normal((257, 9)), torch.float32)
    x64, v64 = x32.double(), v32.double()
    k32 = tk.to(dtype=torch.float32)
    K = tpw.pairwise_matrix_reference(tk, x64, x64)
    got = tpw.matvec_folded_reference(k32, x32, v32).double()
    assert float(((got - K @ v64).abs() / (1e-5 * (K.abs() @ v64.abs()))).max()) <= 1.0
    J = tpw.pairwise_jacobian_reference(tk, x64, x64)
    got = tpw.jacvec_folded_reference(k32, x32, v32).double()
    assert float(((got - J @ v64).abs() / (1e-5 * (J.abs() @ v64.abs()))).max()) <= 1.0


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("chunked", [False, True])
def test_lml_grad_hessian_match_jax(family, chunked, monkeypatch):
    """The analytic gradient and Hessian; ``chunked`` takes the pair-at-a-time
    assembly (hessian_pair, B2b's one plane on a card) at this small n."""
    jk, tk = _pair(family)
    rng = np.random.default_rng(9)
    x = np.sort(rng.uniform(-3, 3, 60))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(60)
    if chunked:
        monkeypatch.setattr(tgp, "_HESSIAN_CHUNK_N", 16)
    jl, jg = gpt.log_marginal_value_and_grad(jk, x, y, 0.2, 1e-8)
    tl, tg = tgp.log_marginal_value_and_grad(tk, _t(x), _t(y), 0.2, 1e-8)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tgp.log_marginal_hessian(tk, _t(x), _t(y), 0.2, 1e-8).numpy(),
                               np.asarray(gpt.log_marginal_hessian(jk, x, y, 0.2, 1e-8)),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_value_and_grad_chains_match_jax_chain_by_chain(family):
    _, tk = _pair(family)
    P = tk.n_params
    rng = np.random.default_rng(10)
    x = np.sort(rng.uniform(-3, 3, 37))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(37)
    theta = rng.uniform(0.5, 1.6, (4, P + 1))
    lml, grad = tgp.log_marginal_value_and_grad_chains(tk, _t(x), _t(y), _t(theta), 1e-6)
    J = tpw.pairwise_jacobian_chains(tk, _t(x), _t(theta)[:, :P])
    for c in range(4):
        jk, _ = _pair(family, theta[c, :P])
        want_l, want_g = gpt.log_marginal_value_and_grad(jk, x, y, theta[c, P], 1e-6)
        np.testing.assert_allclose(float(lml[c]), float(want_l), rtol=1e-10)
        np.testing.assert_allclose(grad[c].numpy(), np.asarray(want_g), rtol=1e-9,
                                   atol=1e-10)
        _close(J[c], jpw.pairwise_jacobian(jk, x, x, block=BLOCK, interpret=True))


@pytest.mark.parametrize("family", ["matern52", "rq"])
def test_value_and_grad_iterative_matches_jax(family):
    """The matrix-free gradient, preconditioned: B1 pivot rows, B4 and B5's
    plain versions on the CPU, the JAX package's draws replayed."""
    jk, tk = _pair(family)
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(-3, 3, 100))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(100)
    key = jax.random.key(12)
    opts = dict(num_probes=6, num_iters=100, tol=1e-10, block_size=32, precond_rank=40)
    jl, jg = jit_gp.log_marginal_value_and_grad_iterative(jk, x, y, 0.3, key, **opts)
    draws = Replay(_rademacher(key, 100, 6), *_precond_normals(key, 40, 100, 6))
    tl, tg = tit_gp.log_marginal_value_and_grad_iterative(tk, _t(x), _t(y), 0.3, draws, **opts)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_make_kernel_and_convert_round_trip(family):
    kc = tconfig.KernelConfig(family=family, h=1.2, w=0.7, p=2.5)
    tk = tconfig.make_kernel(kc, dtype=torch.float64)
    jk = jconfig.make_kernel(kc)
    assert type(tk).__name__ == type(jk).__name__
    assert tk.param_names == jk.param_names
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    for back in (kernel_from_numpy(family, np.asarray(jk.params)),
                 kernel_from_spec((family, np.asarray(jk.params)))):
        assert type(back) is type(tk)
        np.testing.assert_array_equal(back.params.numpy(), np.asarray(jk.params))
