"""Sum/Product kernel trees against the JAX package.

The trees of tests/test_composite.py (sum, product, nested, and the nested
product of a sum) and one of the newer leaves (a sum of products of Matérn,
RQ and periodic kernels, depth 2) get the same numpy-seeded inputs in both
packages, float64 on the CPU: K (the plain version of kernel B1's tree body)
against the JAX composite and its fused Pallas tile body in interpret mode,
the matrix-level Jacobian, Hessian and every ``hessian_pair``, ``kdiag``,
B4's plain version against the JAX fused matvec at n = 300, the exact log
marginal likelihood with its gradient and Hessian, the chain-table value and
gradient, and the matrix-free stochastic gradient (strip Jacobians, B1 pivot
rows).  rtol 1e-12 for the elementwise arrays (atol 1e-12 of the largest
value), 1e-9 for the products and 1e-8 for the likelihood's derivatives, as
the leaf tests hold them.  Also the gates: B4 takes a tree of closed-form
leaves, B5 none (the counterpart of tests/test_iterative.py's
``test_fused_jacvec_gate_rejects_composites``), an ARD leaf raises
TypeError, and a tree of more than ``MAX_TREE_LEAVES`` leaves has no
program for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.models import composite as jcomp
from gaussian_processes_tpu.models import iterative_gp as jit_gp
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.convert import kernel_from_spec
from gaussian_processes_tpu_torch.models import gp as tgp
from gaussian_processes_tpu_torch.models import iterative_gp as tit_gp
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from test_torch_iterative import Replay, _precond_normals, _rademacher
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-12
BLOCK = (128, 128)
LEAVES = {"se": gpt.GaussianKernel, "periodic": gpt.PeriodicKernel,
          "matern32": gpt.Matern32Kernel, "matern52": gpt.Matern52Kernel,
          "rq": gpt.RationalQuadraticKernel}
SE, SE2, PER = ("se", (1.2, 0.8)), ("se", (0.5, 2.0)), ("periodic", (0.9, 1.1, 1.7))
TREES = {
    "sum": ("sum", SE, PER),
    "product": ("prod", SE, PER),
    "nested": ("sum", ("prod", SE, PER), SE2),
    "product_of_sum": ("prod", ("sum", SE, PER), SE),
    "sum_of_products": ("sum", ("prod", ("matern52", (1.0, 0.7)), ("rq", (1.0, 1.3, 0.7))),
                        ("prod", PER, ("matern32", (0.8, 2.0)))),
}


def _jax_kernel(spec):
    if spec[0] in ("sum", "prod"):
        cls = jcomp.SumKernel if spec[0] == "sum" else jcomp.ProductKernel
        return cls(_jax_kernel(spec[1]), _jax_kernel(spec[2]))
    return LEAVES[spec[0]](*(jnp.float64(v) for v in spec[1]))


def _pair(name):
    return _jax_kernel(TREES[name]), kernel_from_spec(TREES[name])


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(-3, 3, n)), np.sort(rng.uniform(-3, 3, m))


@pytest.mark.parametrize("name", list(TREES))
def test_params_round_trip(name):
    jk, tk = _pair(name)
    assert tk.param_names == jk.param_names
    assert tk.n_params == jk.n_params
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    theta = np.asarray(jk.params) * 1.1
    tk2 = tk.with_params(_t(theta))
    assert type(tk2) is type(tk) and type(tk2.k1) is type(tk.k1)
    np.testing.assert_array_equal(tk2.params.numpy(), np.asarray(jk.with_params(theta).params))
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))  # unchanged
    cp = tk.copy()
    np.testing.assert_array_equal(cp.params.numpy(), tk.params.numpy())
    assert list(tk.parameters()) == []
    assert tk.to(dtype=torch.float32).params.dtype == torch.float32


@pytest.mark.parametrize("name", list(TREES))
def test_k_and_kdiag_match_jax(name):
    jk, tk = _pair(name)
    x1, x2 = _inputs(100, 70, seed=1)
    want = jk(x1, x2)
    _close(tk(_t(x1), _t(x2)), want)
    _close(tpw.pairwise_matrix(tk, _t(x1), _t(x2)),
           jpw.pairwise_matrix(jk, x1, x2, block=BLOCK, interpret=True))
    _close(tpw.pairwise_matrix(tk, _t(x1), _t(x1), noise=0.3, jitter=1e-6),
           jpw.pairwise_matrix(jk, x1, x1, noise=0.3, jitter=1e-6, block=BLOCK, interpret=True))
    _close(tk.kdiag(_t(x1)), jk.kdiag(jnp.asarray(x1)))


@pytest.mark.parametrize("name", list(TREES))
def test_jacobian_hessian_and_pairs_match_jax(name):
    jk, tk = _pair(name)
    x1, x2 = _inputs(30, 23, seed=2)
    _close(tk.jacobian(_t(x1), _t(x2)), jk.jacobian(x1, x2))
    H = jk.hessian(x1, x2)
    _close(tk.hessian(_t(x1), _t(x2)), H)
    for p in range(tk.n_params):
        for q in range(tk.n_params):
            _close(tk.hessian_pair(_t(x1), _t(x2), p, q), jk.hessian_pair(x1, x2, p, q))


@pytest.mark.parametrize("name", ["product", "nested", "sum_of_products"])
def test_matvec_twins_match_pallas(name):
    """B4's plain versions (strips of the tree's K; ``folded_values``, the
    kernel's sum of products) against the JAX fused matvec's tree body at
    n = 300, as tests/test_iterative.py holds the JAX package's own."""
    jk, tk = _pair(name)
    x, _ = _inputs(300, 1, seed=3)
    v = np.random.default_rng(4).standard_normal((300, 3))
    want = jpw.kernel_matvec_fused(jk, x, v, 0.2, 1e-8, block=BLOCK, interpret=True)
    for got in (tpw.kernel_matvec_fused(tk, _t(x), _t(v), 0.2, 1e-8),
                tpw.matvec_folded_reference(tk, _t(x), _t(v))
                + tpw._diag_term(0.2, 1e-8, _t(x)) * _t(v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-11)
    got1 = tpw.kernel_matvec_fused(tk, _t(x), _t(v[:, 0]), 0.2, 1e-8)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want)[:, 0], rtol=1e-9, atol=1e-11)


def test_fused_gates_take_trees_to_b4_only():
    x = torch.linspace(-1.0, 1.0, 32, dtype=torch.float64)
    ksum = gpx.SumKernel(gpx.GaussianKernel(1.0, 0.5, dtype=torch.float64),
                         gpx.PeriodicKernel(1.0, 0.5, 1.0, dtype=torch.float64))
    assert tpw.supports_fused_jacvec(gpx.GaussianKernel(1.0, 0.5), x)
    assert not tpw.supports_fused_jacvec(ksum, x)
    assert tpw.supports_fused_matvec(ksum, x)
    assert not tpw.supports_fused_matvec(ksum, x[:, None])
    with pytest.raises(TypeError):
        tpw.kernel_jacvec_fused(ksum, x, torch.ones(32, 2, dtype=torch.float64))
    with pytest.raises(TypeError, match="tree"):
        tpw.pairwise_jacobian(ksum, x, x)


def test_ard_leaf_raises_type_error():
    tree = gpx.ProductKernel(gpx.GaussianKernel(1.0, 0.5, dtype=torch.float64),
                             gpx.ARDGaussianKernel(1.0, torch.ones(2, dtype=torch.float64)))
    x = torch.linspace(-1.0, 1.0, 8, dtype=torch.float64)
    with pytest.raises(TypeError, match="ARD"):
        tpw.pairwise_matrix(tree, x, x)
    assert not tpw.supports_fused_matvec(tree, x)


def test_tree_program_encoding_and_leaf_limit():
    """The sum of products the kernels take: leaves (family, first
    parameter) in k1-before-k2 order, then one bit mask per product, a
    product of sums multiplied out; up to MAX_TREE_LEAVES leaves."""
    tk = kernel_from_spec(TREES["nested"])
    code = list(tpw._tree_program(tpw._tree_structure(tk)))
    assert code == [3, 0, 0, 1, 2, 0, 5, 2, 0b011, 0b100]
    code = list(tpw._tree_program(tpw._tree_structure(kernel_from_spec(TREES["product_of_sum"]))))
    assert code == [3, 0, 0, 1, 2, 0, 5, 2, 0b101, 0b110]
    leaf = ("matern52", (1.0, 1.0))
    spec = leaf
    for _ in range(tpw.MAX_TREE_LEAVES - 1):
        spec = ("prod", spec, leaf)
    big = kernel_from_spec(spec)
    code = list(tpw._tree_program(tpw._tree_structure(big)))
    assert code[0] == tpw.MAX_TREE_LEAVES and code[-2:] == [1, 2 ** tpw.MAX_TREE_LEAVES - 1]
    with pytest.raises(ValueError, match="at most"):
        tpw._tree_program(tpw._tree_structure(kernel_from_spec(("sum", spec, leaf))))
    # the plain version has no leaf limit, as the JAX package has none
    x = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    assert tpw.pairwise_matrix(kernel_from_spec(("sum", spec, leaf)), x, x).shape == (5, 5)


@pytest.mark.parametrize("name", ["product", "sum_of_products"])
@pytest.mark.parametrize("chunked", [False, True])
def test_lml_grad_hessian_match_jax(name, chunked, monkeypatch):
    jk, tk = _pair(name)
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(-3, 3, 50))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(50)
    if chunked:
        monkeypatch.setattr(tgp, "_HESSIAN_CHUNK_N", 16)
    jl, jg = gpt.log_marginal_value_and_grad(jk, x, y, 0.2, 1e-8)
    tl, tg = tgp.log_marginal_value_and_grad(tk, _t(x), _t(y), 0.2, 1e-8)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tgp.log_marginal_hessian(tk, _t(x), _t(y), 0.2, 1e-8).numpy(),
                               np.asarray(gpt.log_marginal_hessian(jk, x, y, 0.2, 1e-8)),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("name", ["product", "nested"])
def test_value_and_grad_chains_match_jax_chain_by_chain(name):
    """The chain table for a tree: K from B1's tree body, dK/dtheta from the
    leaves' chain launches by the matrix-level rule, k1's columns first."""
    jk, tk = _pair(name)
    P = tk.n_params
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(-3, 3, 37))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(37)
    theta = rng.uniform(0.5, 1.6, (4, P + 1))
    lml, grad = tgp.log_marginal_value_and_grad_chains(tk, _t(x), _t(y), _t(theta), 1e-6)
    K = tpw.pairwise_matrix_chains(tk, _t(x), _t(theta)[:, :P], _t(theta[:, P] ** 2))
    J = tpw.pairwise_jacobian_chains(tk, _t(x), _t(theta)[:, :P])
    assert J.shape == (4, P, 37, 37)
    for c in range(4):
        jc = jk.with_params(jnp.asarray(theta[c, :P]))
        want_l, want_g = gpt.log_marginal_value_and_grad(jc, x, y, theta[c, P], 1e-6)
        np.testing.assert_allclose(float(lml[c]), float(want_l), rtol=1e-10)
        np.testing.assert_allclose(grad[c].numpy(), np.asarray(want_g), rtol=1e-9, atol=1e-10)
        _close(K[c], jpw.pairwise_matrix(jc, x, x, noise=theta[c, P], block=BLOCK,
                                         interpret=True))
        _close(J[c], jc.jacobian(x, x))


def test_value_and_grad_iterative_matches_jax():
    """The quasi-periodic tree on the matrix-free path: pivot rows and
    kdiag of the tree, B4's plain version for the solves, the strip
    Jacobian for the gradient; the JAX package's draws replayed."""
    jk, tk = _pair("product")
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(-3, 3, 100))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(100)
    key = jax.random.key(8)
    opts = dict(num_probes=6, num_iters=100, tol=1e-10, block_size=32, precond_rank=40)
    jl, jg = jit_gp.log_marginal_value_and_grad_iterative(jk, x, y, 0.3, key, **opts)
    draws = Replay(_rademacher(key, 100, 6), *_precond_normals(key, 40, 100, 6))
    tl, tg = tit_gp.log_marginal_value_and_grad_iterative(tk, _t(x), _t(y), 0.3, draws, **opts)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
