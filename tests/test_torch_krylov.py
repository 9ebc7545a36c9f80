"""Port Krylov layer (ops/krylov.py) and kernels B4/B5 against the JAX package.

The plain twins of B4 (SE, periodic, ARD) and B5 are held against the JAX
Pallas kernels in interpret mode at block (128, 128), on sizes that are not
tile multiples, rtol 1e-10.  The solvers and SLQ pieces get identical inputs
in both packages (the same dense operator, the same probes, the same factor)
and agree to rtol 1e-10; a preconditioner built from the same kernel agrees
to the same, with a small atol where a product cancels.  Float64 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_processes_tpu as gpt
import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu.ops import krylov as jkr
from gaussian_processes_tpu.ops import pairwise as jpw
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.ops import krylov as tkr
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-10
BLOCK = (128, 128)

FAMILIES = {
    "se": (gpt.GaussianKernel, gpx.GaussianKernel, (1.2, 0.6)),
    "periodic": (gpt.PeriodicKernel, gpx.PeriodicKernel, (1.1, 0.9, 2.3)),
}


def _pair(family):
    if family == "ard":
        h, w = 1.1, np.array([0.8, 1.7])
        return (gpt.ARDGaussianKernel(h=jnp.float64(h), w=jnp.asarray(w)),
                gpx.ARDGaussianKernel(h, torch.as_tensor(w)))
    jcls, tcls, theta = FAMILIES[family]
    return jcls(*(jnp.float64(v) for v in theta)), tcls(*theta, dtype=torch.float64)


def _x(family, n, seed=0):
    rng = np.random.default_rng(seed)
    if family == "ard":
        return rng.uniform(-2, 2, (n, 2))
    return np.sort(rng.uniform(-3, 3, n))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


class Replay:
    """Hands out recorded draws in order, as ``krylov.Draws`` would draw them."""

    def __init__(self, *arrays):
        self.arrays = list(arrays)

    def _next(self, shape, dtype, device):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    rademacher = normal = _next


# -- B4, B5 twins against the JAX Pallas kernels --------------------------------


@pytest.mark.parametrize("family", ["se", "periodic", "ard"])
@pytest.mark.parametrize("n", [137, 300])
def test_matvec_twin_matches_pallas(family, n):
    jk, tk = _pair(family)
    x = _x(family, n)
    v = np.random.default_rng(1).standard_normal((n, 3))
    want = jpw.kernel_matvec_fused(jk, x, v, 0.3, 1e-8, block=BLOCK, interpret=True)
    got = tpw.kernel_matvec_fused_reference(tk, _t(x), _t(v), 0.3, 1e-8, block_size=64)
    _close(got, want)
    want1 = jpw.kernel_matvec_fused(jk, x, v[:, 0], 0.3, 1e-8, block=BLOCK, interpret=True)
    got1 = tpw.kernel_matvec_fused(tk, _t(x), _t(v[:, 0]), 0.3, 1e-8)
    assert got1.shape == (n,)
    _close(got1, want1)


@pytest.mark.parametrize("family", ["se", "periodic"])
@pytest.mark.parametrize("n", [137, 300])
def test_jacvec_twin_matches_pallas(family, n):
    jk, tk = _pair(family)
    x = _x(family, n, seed=2)
    u = np.random.default_rng(3).standard_normal((n, 4))
    want = jpw.kernel_jacvec_fused(jk, x, u, block=BLOCK, interpret=True)
    got = tpw.kernel_jacvec_fused(tk, _t(x), _t(u))
    assert got.shape == (tk.n_params, n, 4)
    _close(got, want)
    _close(tpw.kernel_jacvec_fused_reference(tk, _t(x), _t(u), block_size=50), want)


def test_fused_gates_follow_the_class_level_form():
    _, se = _pair("se")
    _, ard = _pair("ard")
    x1, x2 = _t(np.linspace(-1, 1, 8)), _t(np.ones((8, 2)))
    assert tpw.supports_fused_matvec(se, x1) and tpw.supports_fused_jacvec(se, x1)
    assert tpw.supports_fused_matvec(ard, x2) and not tpw.supports_fused_jacvec(ard, x2)
    assert not tpw.supports_fused_matvec(se, x2)

    class ComposedKernel(gpx.GaussianKernel):
        # a family exposed as a property is truthy on the class, not a form
        cuda_family = property(lambda self: 0)

    comp = ComposedKernel(1.0, 0.5, dtype=torch.float64)
    assert not tpw.supports_fused_matvec(comp, x1)
    assert not tpw.supports_fused_jacvec(comp, x1)
    with pytest.raises(TypeError, match="closed-form"):
        tpw.kernel_jacvec_fused(comp, x1, x1[:, None])
    with pytest.raises(TypeError, match="1-D"):
        tpw.kernel_jacvec_fused(ard, x2, x1[:, None])
    with pytest.raises(TypeError, match="no fused matvec"):
        tpw.kernel_matvec_fused(comp, x1, x1, 0.1)


def test_cpu_products_launch_nothing():
    _, tk = _pair("periodic")
    x = _t(np.linspace(-1, 1, 33))
    before = dict(_build.launch_counts)
    tpw.kernel_matvec_fused(tk, x, x, 0.1)
    tpw.kernel_jacvec_fused(tk, x, x[:, None])
    tkr.kernel_matvec(tk, x, x, 0.1, impl="fused")
    assert dict(_build.launch_counts) == before


# -- kernel_matvec ----------------------------------------------------------------


@pytest.mark.parametrize("family", ["se", "ard"])
def test_kernel_matvec_strip_matches_jax(family):
    jk, tk = _pair(family)
    x = _x(family, 137, seed=4)
    v = np.random.default_rng(5).standard_normal((137, 3))
    want = jkr.kernel_matvec(jk, x, v, 0.3, jitter=1e-8, block_size=32)
    for impl in ("auto", "strip", "fused"):
        _close(tkr.kernel_matvec(tk, _t(x), _t(v), 0.3, jitter=1e-8, block_size=32,
                                 impl=impl), want)
    want1 = jkr.kernel_matvec(jk, x, v[:, 0], 0.3, jitter=1e-8, block_size=32)
    _close(tkr.kernel_matvec(tk, _t(x), _t(v[:, 0]), 0.3, jitter=1e-8, block_size=32), want1)


def test_kernel_matvec_rectangular_rows():
    jk, tk = _pair("se")
    x = _x("se", 137, seed=6)
    rows = x[20:70]
    v = np.random.default_rng(7).standard_normal((137, 2))
    want = jkr.kernel_matvec(jk, x, v, 0.3, block_size=40, x_rows=rows)
    got = tkr.kernel_matvec(tk, _t(x), _t(v), 0.3, block_size=40, x_rows=_t(rows))
    assert got.shape == (50, 2)
    _close(got, want)
    with pytest.raises(ValueError, match="x_rows"):
        tkr.kernel_matvec(tk, _t(x), _t(v), 0.3, impl="fused", x_rows=_t(rows))
    with pytest.raises(ValueError, match="unknown impl"):
        tkr.kernel_matvec(tk, _t(x), _t(v), 0.3, impl="dense")


# -- CG and SLQ on identical operators ----------------------------------------------


def _spd(n=137, noise=0.3, seed=8):
    jk, _ = _pair("se")
    x = _x("se", n, seed=seed)
    K = np.asarray(gpt.build_kxx(jk, jnp.asarray(x), noise))
    return x, K


def _operators(K):
    Kj, Kt = jnp.asarray(K), _t(K)
    return (lambda v: Kj @ v), (lambda v: Kt @ v)


def test_mbcg_matches_jax():
    # an operator with a spread spectrum: on a kernel matrix, whose small
    # eigenvalues cluster at the noise, CG's coefficients past the effective
    # rank are round-off driven and differ between libraries at any tolerance
    rng = np.random.default_rng(9)
    Q = np.linalg.qr(rng.standard_normal((60, 60)))[0]
    A = (Q * np.linspace(1.0, 50.0, 60)) @ Q.T
    rhs = np.concatenate([rng.standard_normal((60, 1)),
                          rng.choice([-1.0, 1.0], (60, 4))], axis=1)
    mvj, mvt = _operators(A)
    want = jkr.mbcg(mvj, jnp.asarray(rhs), num_iters=25, tol=1e-12)
    got = tkr.mbcg(mvt, _t(rhs), num_iters=25, tol=1e-12)
    for g, w in zip(got, want):
        _close(g, w)
    assert got.alphas.shape == (25, 5)


@pytest.mark.parametrize("replace_every", [0, 7])
def test_pcg_matches_jax(replace_every):
    x, K = _spd(noise=0.1)
    jk, tk = _pair("se")
    Lj = jkr.pivoted_cholesky(jk, jnp.asarray(x), 20)
    L = np.asarray(Lj)
    rhs = np.random.default_rng(10).standard_normal((137, 3))
    mvj, mvt = _operators(K)
    prej = jkr.woodbury_inverse_apply(jnp.asarray(L), 0.01)
    pret = tkr.woodbury_inverse_apply(_t(L), 0.01)
    want = jkr.pcg(mvj, prej, jnp.asarray(rhs), num_iters=30, tol=1e-12,
                   replace_every=replace_every)
    got = tkr.pcg(mvt, pret, _t(rhs), num_iters=30, tol=1e-12, replace_every=replace_every)
    # the Woodbury apply's one-time triangular inverse differs between the
    # libraries at round-off, which 30 preconditioned steps carry to ~1e-11;
    # the residual norms reach round-off (~1e-16), where only atol means much
    _close(got[0], want[0], atol=1e-10 * np.abs(np.asarray(want[0])).max())
    _close(got[1], want[1], atol=1e-13)
    if not replace_every:
        want = jkr.pcg(mvj, prej, jnp.asarray(rhs), num_iters=30, tol=1e-12,
                       return_tridiag=True)
        got = tkr.pcg(mvt, pret, _t(rhs), num_iters=30, tol=1e-12, return_tridiag=True)
        assert len(got) == 4
        _close(got[0], want[0], atol=1e-10 * np.abs(np.asarray(want[0])).max())
        _close(got[1], want[1], atol=1e-13)
        for g, w in zip(got[2:], want[2:]):
            _close(g, w, atol=1e-10 * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("replace_every", [0, 5])
def test_pcg_early_exit_is_bit_identical(replace_every):
    x, K = _spd(n=60, noise=0.5)
    mv = _operators(K)[1]
    pre = tkr.woodbury_inverse_apply(tkr.pivoted_cholesky(_pair("se")[1], _t(x), 8), 0.25)
    rhs = _t(np.random.default_rng(11).standard_normal((60, 3)))
    calls = []

    def counted(v):
        calls.append(1)
        return mv(v)

    x_scan, rn_scan = tkr.pcg(mv, pre, rhs, num_iters=200, tol=1e-9,
                              replace_every=replace_every)
    x_ee, rn_ee = tkr.pcg(counted, pre, rhs, num_iters=200, tol=1e-9, early_exit=True,
                          replace_every=replace_every)
    np.testing.assert_array_equal(x_ee.numpy(), x_scan.numpy())
    np.testing.assert_array_equal(rn_ee.numpy(), rn_scan.numpy())
    assert len(calls) < 100  # it stopped at convergence


def test_pcg_early_exit_terminates_on_breakdown():
    A = _t(np.diag(np.concatenate([np.ones(10), -np.ones(10)])))
    rhs = _t(np.random.default_rng(12).standard_normal((20, 3)))
    calls = []

    def mv(v):
        calls.append(1)
        return A @ v

    x_scan, rn_scan = tkr.pcg(lambda v: A @ v, lambda v: v, rhs, num_iters=50, tol=1e-10)
    x_ee, rn_ee = tkr.pcg(mv, lambda v: v, rhs, num_iters=50, tol=1e-10, early_exit=True)
    np.testing.assert_array_equal(x_ee.numpy(), x_scan.numpy())
    np.testing.assert_array_equal(rn_ee.numpy(), rn_scan.numpy())
    assert len(calls) < 50
    with pytest.raises(ValueError, match="tridiag"):
        tkr.pcg(mv, lambda v: v, rhs, 5, early_exit=True, return_tridiag=True)
    with pytest.raises(ValueError, match="tridiagonal"):
        tkr.pcg(mv, lambda v: v, rhs, 5, replace_every=2, return_tridiag=True)


def test_woodbury_and_precond_logdet_match_jax():
    rng = np.random.default_rng(13)
    L = rng.standard_normal((90, 12)) * 0.7
    v = rng.standard_normal((90, 2))
    for sigma2 in (0.05, 1e-9):  # the second takes the damped shift
        _close(tkr.effective_precond_shift(_t(L), sigma2),
               jkr.effective_precond_shift(jnp.asarray(L), sigma2))
        _close(tkr.woodbury_inverse_apply(_t(L), sigma2)(_t(v)),
               jkr.woodbury_inverse_apply(jnp.asarray(L), sigma2)(jnp.asarray(v)))
        _close(tkr.precond_logdet(_t(L), sigma2, 90),
               jkr.precond_logdet(jnp.asarray(L), sigma2, 90))


@pytest.mark.parametrize("family", ["se", "ard"])
def test_pivoted_cholesky_matches_jax(family):
    jk, tk = _pair(family)
    x = _x(family, 120, seed=14)
    # L itself at small rank (no near-tie pivots); L L^T at a larger one
    _close(tkr.pivoted_cholesky(tk, _t(x), 10), jkr.pivoted_cholesky(jk, jnp.asarray(x), 10),
           atol=1e-12)
    got = tkr.pivoted_cholesky(tk, _t(x), 40)
    want = np.asarray(jkr.pivoted_cholesky(jk, jnp.asarray(x), 40))
    _close(got @ got.T, want @ want.T, rtol=1e-8, atol=1e-12)


def _pivoted_cholesky_by_columns(kernel, x, rank, jitter=1e-6):
    """``krylov.pivoted_cholesky`` with each step's kernel column K[:, piv]
    where the port builds the row K[piv, :]."""
    n, dtype = x.shape[0], x.dtype
    d = kernel.kdiag(x).to(dtype)
    L = torch.zeros((n, rank), dtype=dtype)
    floor = torch.max(d) * (1e3 * torch.finfo(dtype).eps)
    for j in range(rank):
        piv = torch.argmax(d).reshape(1)
        c = kernel(x, x.index_select(0, piv))[:, 0]
        d_piv = d.index_select(0, piv)[0]
        col = (c - L @ L.index_select(0, piv)[0]) / torch.sqrt(torch.clamp_min(d_piv, jitter))
        L[:, j] = torch.where(d_piv > floor, col, torch.zeros_like(col))
        d = torch.clamp_min(d - L[:, j] * L[:, j], 0.0)
    return L


@pytest.mark.parametrize("family", ["se", "periodic", "ard"])
def test_pivoted_cholesky_rows_equal_columns(family):
    """The factor built from pivot rows is the factor built from pivot
    columns, bit for bit, in float64: x_piv - x_i only changes sign."""
    _, tk = _pair(family)
    x = _t(_x(family, 300, seed=17))
    assert torch.equal(tkr.pivoted_cholesky(tk, x, 40), _pivoted_cholesky_by_columns(tk, x, 40))


def test_pivoted_cholesky_over_rank_freezes_float32():
    _, tk = _pair("se")
    wide = tk.with_params(torch.tensor([1.3, 2.5], dtype=torch.float32))
    x = _t(_x("se", 200, seed=15)).float()
    L = tkr.pivoted_cholesky(wide, x, 150)
    assert L.dtype == torch.float32
    K = wide(x, x)
    assert float(torch.linalg.norm(K - L @ L.T) / torch.linalg.norm(K)) < 5e-4
    assert float(L[:, -20:].abs().max()) == 0.0


def test_lanczos_and_slq_from_cg_match_jax():
    _, K = _spd(n=80)
    probes = np.random.default_rng(16).choice([-1.0, 1.0], (80, 6))
    res = jkr.mbcg(_operators(K)[0], jnp.asarray(probes), num_iters=25, tol=1e-8)
    a, b = np.asarray(res.alphas), np.asarray(res.betas)
    assert (a == 0).any()  # some columns froze: zero rows in T
    _close(tkr.lanczos_tridiag_from_cg(_t(a), _t(b)), jkr.lanczos_tridiag_from_cg(a, b))
    norms = np.full(6, 80.0)
    _close(tkr.slq_logdet_from_cg(_t(a), _t(b), _t(norms), 80),
           jkr.slq_logdet_from_cg(jnp.asarray(a), jnp.asarray(b), jnp.asarray(norms), 80))


def _precond_draws(key, k, n, r):
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (k, r), jnp.float64)),
            np.asarray(jax.random.normal(k2, (n, r), jnp.float64)))


def test_precond_probes_and_slq_match_jax():
    x, K = _spd(noise=0.15)
    jk, _ = _pair("se")
    L = np.asarray(jkr.pivoted_cholesky(jk, jnp.asarray(x), 30))
    key = jax.random.key(3)
    draws = _precond_draws(key, 30, 137, 5)
    _close(tkr.sample_precond_probes(Replay(*draws), _t(L), 0.0225, 5),
           jkr.sample_precond_probes(key, jnp.asarray(L), 0.0225, 5))
    mvj, mvt = _operators(K)
    want = jkr.slq_logdet_preconditioned(mvj, jnp.asarray(L), 0.0225, key, 5, 40, 137)
    got = tkr.slq_logdet_preconditioned(mvt, _t(L), 0.0225, Replay(*draws), 5, 40, 137)
    _close(got, want)


def test_draws_are_seeded_and_signed():
    d1 = tkr.as_draws(torch.Generator().manual_seed(5))
    d2 = tkr.as_draws(torch.Generator().manual_seed(5))
    z1 = d1.rademacher((50, 3), torch.float64, "cpu")
    assert z1.dtype == torch.float64 and set(z1.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(z1, d2.rademacher((50, 3), torch.float64, "cpu"))
    assert torch.equal(tkr.as_draws(None).normal((4,), torch.float32, "cpu"),
                       tkr.as_draws(None).normal((4,), torch.float32, "cpu"))
    replay = Replay(np.ones(3))
    assert tkr.as_draws(replay) is replay
