"""Chain-batched value and gradient (kernels B1, B2a over a parameter table,
B2a contracted, the batched blocked Cholesky over B3) against the JAX
package, chain by chain.

The JAX package gets C chains by ``vmap`` over its Pallas calls; the port
takes a (C, P) table.  Here the port's plain versions (the CPU path of each
wrapper) are held against the JAX builders run chain by chain in interpret
mode, on the same numpy-seeded inputs in float64: the K and dK/dtheta tables
to 1e-12 absolute (entries are at most h^2 ~ 2), the value and gradient to
1e-10 relative.  B2a contracted's twin is held to the two contractions it
replaces, 1/2 (alpha^T K_p alpha - tr(K^-1 K_p)), for every leaf family,
and the value+grad takes it for a leaf and never for a tree.  The kernels
themselves run on the card (chip_smoke.py, tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.models import gp as tgp
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from gaussian_processes_tpu_torch.utils.profiling import counts
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

FAMILIES = {"se": (gpt.GaussianKernel, gpx.GaussianKernel, 2),
            "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, 3)}
C, N, JITTER = 5, 37, 1e-6


def _problem(family, seed=0):
    jcls, tcls, P = FAMILIES[family]
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, N))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(N)
    theta = rng.uniform(0.4, 1.6, (C, P + 1))
    if family == "periodic":
        theta[:, 2] += 1.0  # periods 1.4-2.6 on the span of 6
    template = tcls(*([1.0] * P), dtype=torch.float64)
    return jcls, template, x, y, theta, P


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chain_tables_match_pallas_chain_by_chain(family):
    jcls, template, x, _, theta, P = _problem(family)
    diag = theta[:, P] ** 2 + JITTER
    K = tpw.pairwise_matrix_chains_reference(template, _t(x), _t(theta[:, :P]), _t(diag))
    J = tpw.pairwise_jacobian_chains_reference(template, _t(x), _t(theta[:, :P]))
    assert K.shape == (C, N, N) and J.shape == (C, P, N, N)
    for c in range(C):
        jk = jcls(*(jnp.asarray(v) for v in theta[c, :P]))
        want_k = jpw.pairwise_matrix(jk, x, x, noise=theta[c, P], jitter=JITTER,
                                     block=(128, 128), interpret=True)
        want_j = jpw.pairwise_jacobian(jk, x, x, block=(128, 128), interpret=True)
        np.testing.assert_allclose(K[c].numpy(), np.asarray(want_k), rtol=0, atol=1e-12)
        np.testing.assert_allclose(J[c].numpy(), np.asarray(want_j), rtol=0, atol=1e-12)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chain_wrappers_take_their_twins_on_the_cpu(family):
    _, template, x, _, theta, P = _problem(family, seed=1)
    diag = _t(theta[:, P] ** 2 + JITTER)
    params = _t(theta)[:, :P]  # a strided view, as the value+grad passes it
    before = dict(_build.launch_counts)
    got = tpw.pairwise_matrix_chains(template, _t(x), params, diag)
    assert torch.equal(got, tpw.pairwise_matrix_chains_reference(template, _t(x), params, diag))
    got = tpw.pairwise_jacobian_chains(template, _t(x), params)
    assert torch.equal(got, tpw.pairwise_jacobian_chains_reference(template, _t(x), params))
    assert dict(_build.launch_counts) == before  # CPU tensors never launch


def test_chain_wrappers_check_their_shapes():
    _, template, x, _, theta, P = _problem("se")
    with pytest.raises(ValueError, match=r"\(C, 2\)"):
        tpw.pairwise_matrix_chains(template, _t(x), _t(theta), _t(theta[:, 0]))
    with pytest.raises(ValueError, match="diag must be"):
        tpw.pairwise_matrix_chains(template, _t(x), _t(theta[:, :P]), _t(theta[:2, 0]))
    with pytest.raises(ValueError, match="1-D inputs"):
        tpw.pairwise_jacobian_chains(template, _t(np.zeros((N, 2))), _t(theta[:, :P]))


def test_batched_blocked_cholesky_nan_only_in_the_bad_chain():
    rng = np.random.default_rng(3)
    n = 300  # three panels, the last one ragged
    A = []
    for _ in range(4):
        B = rng.standard_normal((n, n))
        A.append(B @ B.T / n + np.eye(n))
    A = _t(np.stack(A))
    A[2, 200, 200] = -5.0  # not positive definite: its third panel fails
    L = bc.cholesky_blocked(A)
    assert L.shape == (4, n, n)
    nan = [bool(torch.isnan(L[c]).any()) for c in range(4)]
    assert nan == [False, False, True, False]
    for c in (0, 1, 3):
        np.testing.assert_allclose(L[c].numpy(), torch.linalg.cholesky(A[c]).numpy(),
                                   rtol=0, atol=1e-12)
        assert torch.equal(L[c], bc.cholesky_blocked(A[c]))  # the 2-D path, same panels
        assert float(torch.triu(L[c], 1).abs().max()) == 0.0
    # the panels before the failed tile stay finite, as in the 2-D factor
    assert bool(torch.isfinite(L[2, :128, :128]).all())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_value_and_grad_chains_matches_jax_chain_by_chain(family):
    jcls, template, x, y, theta, P = _problem(family, seed=2)
    lml, grad = tgp.log_marginal_value_and_grad_chains(template, _t(x), _t(y), _t(theta),
                                                        JITTER)
    assert lml.shape == (C,) and grad.shape == (C, P + 1)
    for c in range(C):
        jk = jcls(*(jnp.asarray(v) for v in theta[c, :P]))
        want_l, want_g = gpt.log_marginal_value_and_grad(jk, x, y, theta[c, P], JITTER)
        np.testing.assert_allclose(float(lml[c]), float(want_l), rtol=1e-10)
        np.testing.assert_allclose(grad[c].numpy(), np.asarray(want_g), rtol=1e-10)


def test_value_and_grad_chains_keeps_a_bad_chain_to_itself():
    _, template, x, y, theta, _ = _problem("se", seed=4)
    theta[1, 0] = np.nan
    lml, grad = tgp.log_marginal_value_and_grad_chains(template, _t(x), _t(y), _t(theta),
                                                        JITTER)
    finite = [bool(torch.isfinite(lml[c]) and torch.isfinite(grad[c]).all()) for c in range(C)]
    assert finite == [True, False, True, True, True]
    one, _ = tgp.log_marginal_value_and_grad_chains(template, _t(x), _t(y), _t(theta[2:3]),
                                                     JITTER)
    np.testing.assert_allclose(float(one[0]), float(lml[2]), rtol=1e-13)


# every leaf family of the port, for B2a contracted
LEAVES = {"se": lambda: gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64),
          "periodic": lambda: gpx.PeriodicKernel(1.0, 1.0, 2.0, dtype=torch.float64),
          "matern32": lambda: gpx.Matern32Kernel(1.0, 1.0, dtype=torch.float64),
          "matern52": lambda: gpx.Matern52Kernel(1.0, 1.0, dtype=torch.float64),
          "rq": lambda: gpx.RationalQuadraticKernel(1.0, 1.0, 1.5, dtype=torch.float64)}


def _grad_pieces(template, seed):
    """x, y, the (C, P + 1) table, alpha and K^-1 of a small chain problem."""
    P = template.n_params
    rng = np.random.default_rng(seed)
    x = _t(np.sort(rng.uniform(-3, 3, N)))
    y = torch.sin(2 * x) + 0.1 * _t(rng.standard_normal(N))
    theta = _t(rng.uniform(0.5, 1.6, (C, P + 1)))
    theta[:, P] *= 0.3
    K = tpw.pairwise_matrix_chains_reference(template, x, theta[:, :P], theta[:, P] ** 2 + JITTER)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y[None, :, None].expand(C, N, 1), L)[..., 0]
    inv_K = torch.cholesky_inverse(L)
    return x, y, theta, alpha, inv_K


@pytest.mark.parametrize("family", list(LEAVES))
def test_contract_twin_equals_quad_minus_trace(family):
    template = LEAVES[family]()
    x, _, theta, alpha, inv_K = _grad_pieces(template, seed=5)
    params = theta[:, :template.n_params]
    J = tpw.pairwise_jacobian_chains_reference(template, x, params)
    quad = torch.einsum("ci,cpij,cj->cp", alpha, J, alpha)
    trace = torch.einsum("cij,cpji->cp", inv_K, J)
    want = 0.5 * (quad - trace)
    got = tpw.jacobian_contract_chains_reference(template, x, params, alpha, inv_K)
    assert got.shape == (C, template.n_params)
    scale = 0.5 * (torch.einsum("ci,cpij,cj->cp", alpha.abs(), J.abs(), alpha.abs())
                   + torch.einsum("cij,cpji->cp", inv_K.abs(), J.abs()))
    assert float(((got - want).abs() / scale).max()) < 1e-12
    before = dict(_build.launch_counts)
    assert torch.equal(tpw.jacobian_contract_chains(template, x, params, alpha, inv_K), got)
    assert dict(_build.launch_counts) == before  # CPU tensors never launch


def test_contract_wrapper_checks_its_inputs():
    template = LEAVES["se"]()
    x, _, theta, alpha, inv_K = _grad_pieces(template, seed=6)
    with pytest.raises(ValueError, match="alpha and inv_K"):
        tpw.jacobian_contract_chains(template, x, theta[:, :2], alpha[:2], inv_K)
    tree = gpx.ProductKernel(LEAVES["se"](), LEAVES["periodic"]())
    with pytest.raises(TypeError, match="tree"):
        tpw.jacobian_contract_chains(tree, x, _t(np.ones((C, 5))), alpha, inv_K)


@pytest.mark.parametrize("kind", ["se", "rq", "tree"])
def test_value_and_grad_chains_contracts_every_leaf_and_no_tree(kind, monkeypatch):
    """A leaf family never builds its Jacobians and counts its C rows in
    ``core.grad_contracted``; a tree takes its leaves' Jacobians and counts
    nothing."""
    template = (gpx.ProductKernel(LEAVES["se"](), LEAVES["periodic"]()) if kind == "tree"
                else LEAVES[kind]())
    x, y, theta, _, _ = _grad_pieces(template, seed=7)
    calls = []
    real = tgp.pairwise_jacobian_chains

    def spy(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(tgp, "pairwise_jacobian_chains", spy)
    monkeypatch.setattr(tpw, "pairwise_jacobian_chains", spy)
    before = counts["core.grad_contracted"]
    lml, grad = tgp.log_marginal_value_and_grad_chains(template, x, y, theta, JITTER)
    assert lml.shape == (C,) and grad.shape == (C, template.n_params + 1)
    assert bool(torch.isfinite(grad).all())
    contracted = counts["core.grad_contracted"] - before
    if kind == "tree":
        assert contracted == 0 and calls
    else:
        assert contracted == C and not calls
