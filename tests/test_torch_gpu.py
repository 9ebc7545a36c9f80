"""Kernels B1-B6 on the card against their plain PyTorch versions: every
leaf family (SE, periodic, Matérn 3/2 and 5/2, RQ) and, for B1 and B4,
Sum/Product trees; B2a contracted against its float64 twin within a share of
the sum's size before cancellation (1e-5 float32, 1e-12 float64).

Marked ``gpu``: each test skips without a CUDA device.  This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Float32 tolerances: B1/B2/B6 rtol 1e-5 with an atol of 1e-6 of the array's
largest value (the kernel contracts multiply-adds into FMAs, the plain
version rounds each operation; B1 is held to the plain version of its own
folded arithmetic, ``pairwise_matrix_folded``, whose ex2 and lg2 the card
approximates).  B3: relative Frobenius distance from the
plain factor 3e-5 (f32; two float32 factorizations of a tile with
condition number ~1e4 differ by up to ~1e-5) and 1e-12 (f64), and backward
error ||L L^T - A|| / ||A|| 1e-6 (f32) and 1e-13 (f64); B3's inverse within
3e-4 (f32) and 1e-11 (f64) of the plain one.
"""

import numpy as np
import pytest
import torch

import gaussian_processes_tpu_torch as gpx
from gaussian_processes_tpu_torch.ops import _build
from gaussian_processes_tpu_torch.ops import blocked_cholesky as tbc
from gaussian_processes_tpu_torch.ops import pairwise as tpw
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

pytestmark = pytest.mark.gpu

KERNELS = {
    "se": lambda dt, dev: gpx.GaussianKernel(1.3, 0.7, dtype=dt, device=dev),
    "periodic": lambda dt, dev: gpx.PeriodicKernel(0.9, 1.1, 2.0, dtype=dt, device=dev),
}
# the families ported after SE and periodic, and their launch counters' suffix
NEW_KERNELS = {
    "matern32": lambda dt, dev: gpx.Matern32Kernel(1.3, 0.7, dtype=dt, device=dev),
    "matern52": lambda dt, dev: gpx.Matern52Kernel(1.1, 0.9, dtype=dt, device=dev),
    "rq": lambda dt, dev: gpx.RationalQuadraticKernel(0.9, 1.1, 1.5, dtype=dt, device=dev),
}
ALL_KERNELS = {**KERNELS, **NEW_KERNELS}


def _tree(name, dt, dev):
    """The quasi-periodic product (depth 1), a sum of products over four
    families (depth 2) and a nested product of a sum."""
    se = gpx.GaussianKernel(1.2, 0.8, dtype=dt, device=dev)
    per = gpx.PeriodicKernel(0.9, 1.1, 1.7, dtype=dt, device=dev)
    if name == "product":
        return gpx.ProductKernel(se, per)
    if name == "sum_of_products":
        return gpx.SumKernel(
            gpx.ProductKernel(gpx.Matern52Kernel(1.0, 0.7, dtype=dt, device=dev),
                              gpx.RationalQuadraticKernel(1.0, 1.3, 0.7, dtype=dt, device=dev)),
            gpx.ProductKernel(per, gpx.Matern32Kernel(0.8, 2.0, dtype=dt, device=dev)))
    return gpx.ProductKernel(gpx.SumKernel(se, per), gpx.GaussianKernel(0.5, 2.0, dtype=dt,
                                                                        device=dev))


TREES = ["product", "sum_of_products", "product_of_sum"]
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 1e-13)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _x(n, seed, dtype, device):
    g = torch.Generator().manual_seed(seed)
    return torch.sort(torch.rand(n, generator=g, dtype=torch.float64) * 6 - 3)[0].to(
        device=device, dtype=dtype)


def _close(got, want, dtype):
    rtol, afrac = TOL[dtype]
    torch.testing.assert_close(got, want, rtol=rtol, atol=afrac * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", list(KERNELS))
@pytest.mark.parametrize("n,m", [(300, 300), (129, 257)])
def test_pairwise_kernels_match_plain(cuda, family, dtype, n, m):
    k = KERNELS[family](dtype, cuda)
    x1, x2 = _x(n, 0, dtype, cuda), _x(m, 1, dtype, cuda)
    before = dict(_build.launch_counts)
    _close(tpw.pairwise_matrix(k, x1, x2), tpw.pairwise_matrix_folded(k, x1, x2), dtype)
    _close(tpw.pairwise_matrix(k, x1, x1, noise=0.1, jitter=1e-6),
           tpw.pairwise_matrix_folded(k, x1, x1, noise=0.1, jitter=1e-6), dtype)
    _close(tpw.pairwise_jacobian(k, x1, x2), tpw.pairwise_jacobian_reference(k, x1, x2), dtype)
    _close(tpw.pairwise_hessian(k, x1, x2), tpw.pairwise_hessian_reference(k, x1, x2), dtype)
    _close(tpw.pairwise_hessian(k, x1, x2, pair=(1, 0)),
           tpw.pairwise_hessian_reference(k, x1, x2, pair=(1, 0)), dtype)
    torch.cuda.synchronize()
    after = _build.launch_counts
    assert after["pairwise_k"] - before.get("pairwise_k", 0) == 2
    assert after["pairwise_jac"] - before.get("pairwise_jac", 0) == 1
    assert after["pairwise_hess"] - before.get("pairwise_hess", 0) == 2


# autograd rules against the plain versions' autograd (float64 on the
# card): relative to the largest entry of each gradient
GRAD_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _grads_of_k(kernel, x1, x2, G, build, noise=None):
    """d <G, K> / d(theta, x1, x2[, noise]) through ``build``."""
    theta = kernel.params.detach().clone().requires_grad_()
    a, b = x1.detach().clone().requires_grad_(), x2.detach().clone().requires_grad_()
    leaves = [theta, a, b]
    kw = {}
    if noise is not None:
        s = torch.tensor(noise, dtype=x1.dtype, device=x1.device, requires_grad=True)
        leaves.append(s)
        kw = {"noise": s, "jitter": 1e-6}
    K = build(kernel.with_params(theta), a, b, **kw)
    return K.detach(), torch.autograd.grad(K, leaves, G)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["se", "rq", "product", "ard"])
def test_pairwise_grad_matches_plain_autograd(cuda, kind, dtype):
    """B1's (B6's) autograd rule: theta from B2a's planes (a tree's from its
    matrix-level Jacobian, ARD's from the plain element), the inputs from
    the plain element's autograd, the diagonal term tr(G)."""
    if kind == "ard":
        k = gpx.ARDGaussianKernel(1.1, torch.tensor([0.7, 1.3], dtype=dtype), device=cuda)
        g = torch.Generator().manual_seed(4)
        x1 = (torch.rand((300, 2), generator=g, dtype=torch.float64) * 4 - 2).to(cuda, dtype)
        x2 = (torch.rand((129, 2), generator=g, dtype=torch.float64) * 4 - 2).to(cuda, dtype)
        build, plain = tpw.pairwise_matrix_ard, tpw.pairwise_matrix_ard_reference
    else:
        k = ALL_KERNELS[kind](dtype, cuda) if kind != "product" else _tree(kind, dtype, cuda)
        x1, x2 = _x(300, 0, dtype, cuda), _x(129, 1, dtype, cuda)
        build, plain = tpw.pairwise_matrix, tpw.pairwise_matrix_reference
    G = torch.randn((300, 129), generator=torch.Generator(device=cuda).manual_seed(1),
                    dtype=dtype, device=cuda)
    before = dict(_build.launch_counts)
    K, got = _grads_of_k(k, x1, x2, G, build)
    k64 = k.with_params(k.params.double())
    _, want = _grads_of_k(k64, x1.double(), x2.double(), G.double(), plain)
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_.double(), w_, rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype] * float(w_.abs().max()))
    # with the diagonal term, on K(x, x)
    _, got = _grads_of_k(k, x1, x1, G[:, :1].expand(300, 300).contiguous(), build, noise=0.3)
    _, want = _grads_of_k(k64, x1.double(), x1.double(),
                          G[:, :1].expand(300, 300).double(), plain, noise=0.3)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.double(), w_, rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype] * float(w_.abs().max()))
    after = _build.launch_counts
    if kind == "ard":
        assert after["pairwise_ard"] - before.get("pairwise_ard", 0) == 2
    elif kind == "product":
        assert after["pairwise_k_tree"] - before.get("pairwise_k_tree", 0) == 2
        assert after["pairwise_jac"] - before.get("pairwise_jac", 0) == 4  # SE, periodic leaves
    else:
        suffix = "" if kind == "se" else f"_{kind}"
        assert after["pairwise_k" + suffix] - before.get("pairwise_k" + suffix, 0) == 2
        assert after["pairwise_jac" + suffix] - before.get("pairwise_jac" + suffix, 0) == 2
    # other wrappers keep refusing an input that requires grad
    xg = _x(64, 3, dtype, cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        tpw.kernel_matvec_fused(gpx.GaussianKernel(1.0, 1.0, dtype=dtype, device=cuda), xg,
                                torch.ones_like(xg), 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(300,), (5, 260)], ids=["matrix", "stack"])
def test_cholesky_blocked_grad_matches_plain_autograd(cuda, dtype, shape):
    """The blocked factor's autograd rule (the Cholesky VJP by two
    triangular solves) against ``torch.linalg.cholesky``'s autograd in
    float64; B3 runs forward, ``chol_tile`` itself keeps its raise."""
    n = shape[-1]
    k = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64)
    mats = [k(_x(n, 10 + c, torch.float64, "cpu"), _x(n, 10 + c, torch.float64, "cpu"))
            + 0.1 * torch.eye(n, dtype=torch.float64) for c in range(shape[0] if len(shape) > 1
                                                                       else 1)]
    A = (torch.stack(mats) if len(shape) > 1 else mats[0]).to(cuda)
    G = torch.randn(A.shape, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64).tril().to(cuda)
    a = A.to(dtype).requires_grad_()
    before = _build.launch_counts["chol_tile"]
    L = tbc.cholesky_blocked(a)
    (got,) = torch.autograd.grad(L, a, G.to(dtype))
    assert _build.launch_counts["chol_tile"] > before
    a64 = A.clone().requires_grad_()
    (want,) = torch.autograd.grad(torch.linalg.cholesky(a64), a64, G)
    tol = {torch.float32: 2e-2, torch.float64: 1e-8}[dtype]
    assert float(torch.linalg.norm(got.double() - want) / torch.linalg.norm(want)) < tol
    with pytest.raises(RuntimeError, match="autograd"):
        tbc.chol_tile(a[..., :128, :128].contiguous())


@pytest.mark.parametrize("dtype,rel,back", [(torch.float32, 3e-5, 1e-6),
                                            (torch.float64, 1e-12, 1e-13)])
def test_chol_tile_matches_plain(cuda, dtype, rel, back):
    x = _x(3 * 128, 3, torch.float64, "cpu")
    K = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64)(x, x) + 0.01 * torch.eye(384, dtype=torch.float64)
    tiles = torch.stack([K[i * 128:(i + 1) * 128, i * 128:(i + 1) * 128] for i in range(3)])
    tiles = tiles.to(device=cuda, dtype=dtype).contiguous()
    got = tbc.chol_tile(tiles)
    want = tbc.cholesky_reference(tiles)
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < rel
    A = tiles.double()
    LLt = got.double() @ got.double().mT
    assert float(torch.linalg.norm(LLt - A) / torch.linalg.norm(A)) < back
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


@pytest.mark.parametrize("dtype,rel,back,inv", [(torch.float32, 3e-5, 1e-6, 3e-4),
                                                (torch.float64, 1e-12, 1e-13, 1e-11)])
def test_chol_tile_batch_of_64_with_bad_tiles(cuda, dtype, rel, back, inv):
    """B3 with and without its inverse over 64 kernel tiles, four of them
    not positive definite and four holding a NaN.  The inverse is held to
    the plain one within ~kappa(L) u (float32 3e-4, float64 1e-11)."""
    k = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64)
    tiles = []
    for s in range(16):
        x = _x(512, 100 + s, torch.float64, "cpu")
        K = k(x, x) + 0.01 * torch.eye(512, dtype=torch.float64)
        tiles += [K[i:i + 128, i:i + 128] for i in range(0, 512, 128)]
    batch = torch.stack(tiles)
    not_pd, has_nan = [3, 17, 40, 63], [5, 22, 41, 58]
    for b in not_pd:
        batch[b, 60, 60] = -1.0
    for b in has_nan:
        batch[b, 90, 11] = batch[b, 11, 90] = float("nan")
    batch = batch.to(device=cuda, dtype=dtype).contiguous()
    good = [b for b in range(64) if b not in not_pd + has_nan]
    before = _build.launch_counts["chol_tile"]
    L = tbc.chol_tile(batch)
    L2, Linv = tbc.chol_tile_inv(batch)
    torch.cuda.synchronize()
    assert _build.launch_counts["chol_tile"] == before + 2
    Lr, Linv_r = tbc.chol_tile_inv_reference(batch)
    assert float(torch.linalg.norm(L[good] - Lr[good]) / torch.linalg.norm(Lr[good])) < rel
    A = batch[good].double()
    LLt = L[good].double() @ L[good].double().mT
    assert float(torch.linalg.norm(LLt - A) / torch.linalg.norm(A)) < back
    assert torch.equal(L[good], L2[good])
    assert float(torch.linalg.norm(Linv[good] - Linv_r[good])
                 / torch.linalg.norm(Linv_r[good])) < inv
    lower = torch.tril(torch.ones(128, 128, dtype=torch.bool, device=cuda))
    for t in (L, L2, Linv):
        assert all(torch.isnan(t[b][lower]).all() for b in not_pd + has_nan)
        assert (torch.triu(t, 1) == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_tile_takes_a_view_at_any_offset(cuda, dtype):
    """A contiguous view whose address is not a multiple of 16 bytes gives
    the same factor and inverse as an aligned copy of it."""
    x = _x(128, 12, torch.float64, "cpu")
    K = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64)(x, x) + 0.01 * torch.eye(128, dtype=torch.float64)
    buf = torch.empty(1 + 128 * 128, dtype=dtype, device=cuda)
    A = buf[1:].view(128, 128)
    A.copy_(K)
    assert A.is_contiguous() and A.data_ptr() % 16 != 0
    L, Linv = tbc.chol_tile_inv(A)
    torch.cuda.synchronize()
    assert torch.equal(L, tbc.chol_tile(A.clone()))
    L2, Linv2 = tbc.chol_tile_inv(A.clone())
    assert torch.equal(L, L2) and torch.equal(Linv, Linv2)


def test_chol_tile_non_pd_gives_nan(cuda):
    A = torch.eye(128, dtype=torch.float32, device=cuda)
    A[40, 40] = -1.0
    L = tbc.chol_tile(A)
    lower = torch.tril(torch.ones(128, 128, dtype=torch.bool, device=cuda))
    assert torch.isnan(L[lower]).all() and (L[~lower] == 0).all()


def test_fit_on_card_matches_cpu(cuda):
    x = _x(700, 4, torch.float64, "cpu")
    y = torch.sin(2 * x)
    k = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64)
    want = gpx.fit(k, x, y, 0.1, 1e-6)
    got = gpx.fit(k.to(cuda), x.to(cuda), y.to(cuda), 0.1, 1e-6)
    np.testing.assert_allclose(got.log_marginal.item(), want.log_marginal.item(), rtol=1e-10)
    np.testing.assert_allclose(got.alpha.cpu().numpy(), want.alpha.numpy(), rtol=1e-7, atol=1e-9)


# -- B4, B5, B6: matrix-free products and the ARD K ----------------------------
# B4/B5 sum n products per entry; the allowance is rtol (K|V|)_i with the
# row's sum of absolute terms (float32 1e-5, float64 1e-12), since the kernel
# accumulates a row's terms in another order than the plain strips.

PRODUCT_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _ard(dt, dev):
    return gpx.ARDGaussianKernel(1.1, torch.tensor([0.8, 1.4, 2.0], dtype=dt)).to(dev)


def _points(n, D, seed, dtype, device):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, D, generator=g, dtype=torch.float64) * 4 - 2).to(device=device,
                                                                           dtype=dtype)


def _within_row_sums(got, want, bound, dtype):
    assert float(((got - want).abs() / (PRODUCT_TOL[dtype] * bound + 1e-30)).max()) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", ["se", "periodic", "ard"])
@pytest.mark.parametrize("n,r", [(1000, 1), (777, 9), (777, 300)])
def test_matvec_kernel_matches_plain(cuda, family, dtype, n, r):
    if family == "ard":
        k, x = _ard(dtype, cuda), _points(n, 3, 5, dtype, cuda)
    else:
        k, x = KERNELS[family](dtype, cuda), _x(n, 5, dtype, cuda)
    g = torch.Generator().manual_seed(6)
    v = torch.randn(n, r, generator=g, dtype=torch.float64).to(device=cuda, dtype=dtype)
    key = "kernel_matvec_ard" if family == "ard" else "kernel_matvec"
    before = _build.launch_counts[key]
    got = tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
    torch.cuda.synchronize()
    assert _build.launch_counts[key] == before + 1
    want = tpw.kernel_matvec_fused_reference(k, x, v, 0.1, 1e-6)
    bound = tpw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
    _within_row_sums(got, want, bound, dtype)
    assert torch.equal(got, tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 8, 9, 64, 300])
@pytest.mark.parametrize("n", [129, 777, 1000])
@pytest.mark.parametrize("D", [1, 2, 3, 8, 16])
def test_ard_matvec_kernel_over_dims(cuda, D, n, r, dtype):
    """B4-ARD (one instantiation per D) against the plain product, and a
    repeat that must be bit-identical."""
    k = gpx.ARDGaussianKernel(1.1, torch.linspace(0.6, 2.4, D, dtype=torch.float64),
                              dtype=dtype, device=cuda)
    x = _points(n, D, 20 + D, dtype, cuda)
    g = torch.Generator().manual_seed(n + r)
    v = torch.randn(n, r, generator=g, dtype=torch.float64).to(device=cuda, dtype=dtype)
    before = _build.launch_counts["kernel_matvec_ard"]
    got = tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
    torch.cuda.synchronize()
    assert _build.launch_counts["kernel_matvec_ard"] == before + 1
    want = tpw.kernel_matvec_fused_reference(k, x, v, 0.1, 1e-6)
    bound = tpw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
    _within_row_sums(got, want, bound, dtype)
    assert torch.equal(got, tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 8, 9, 64, 300])
@pytest.mark.parametrize("n", [129, 777, 1000])
@pytest.mark.parametrize("family", list(KERNELS))
def test_jacvec_kernel_matches_plain(cuda, family, n, r, dtype):
    """B5 (one instantiation per chunk of right-hand sides) against the plain
    product, and a repeat that must be bit-identical."""
    k, x = KERNELS[family](dtype, cuda), _x(n, 7, dtype, cuda)
    g = torch.Generator().manual_seed(8 + n + r)
    u = torch.randn(n, r, generator=g, dtype=torch.float64).to(device=cuda, dtype=dtype)
    before = _build.launch_counts["kernel_jacvec"]
    got = tpw.kernel_jacvec_fused(k, x, u)
    torch.cuda.synchronize()
    assert _build.launch_counts["kernel_jacvec"] == before + 1
    want = tpw.kernel_jacvec_fused_reference(k, x, u)
    J = tpw.pairwise_jacobian_reference(k, x, x)
    _within_row_sums(got, want, J.abs() @ u.abs(), dtype)
    assert torch.equal(got, tpw.kernel_jacvec_fused(k, x, u))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", list(KERNELS))
def test_products_match_their_folded_arithmetic(cuda, family, dtype):
    """B4 and B5 against the plain versions of their own arithmetic."""
    k, x = KERNELS[family](dtype, cuda), _x(777, 9, dtype, cuda)
    g = torch.Generator().manual_seed(10)
    u = torch.randn(777, 9, generator=g, dtype=torch.float64).to(device=cuda, dtype=dtype)
    K_abs = tpw.pairwise_matrix_reference(k, x, x).abs()
    _within_row_sums(tpw.kernel_matvec_fused(k, x, u, 0.0), tpw.matvec_folded_reference(k, x, u),
                     K_abs @ u.abs(), dtype)
    J_abs = tpw.pairwise_jacobian_reference(k, x, x).abs()
    _within_row_sums(tpw.kernel_jacvec_fused(k, x, u), tpw.jacvec_folded_reference(k, x, u),
                     J_abs @ u.abs(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ard_pairwise_kernel_matches_plain(cuda, dtype):
    k = _ard(dtype, cuda)
    x1, x2 = _points(129, 3, 9, dtype, cuda), _points(257, 3, 10, dtype, cuda)
    _close(tpw.pairwise_matrix_ard(k, x1, x2), tpw.pairwise_matrix_ard_reference(k, x1, x2),
           dtype)
    _close(tpw.pairwise_matrix_ard(k, x1, x1, noise=0.1, jitter=1e-6),
           tpw.pairwise_matrix_ard_reference(k, x1, x1, noise=0.1, jitter=1e-6), dtype)


@pytest.mark.parametrize("with_diag", [False, True])
@pytest.mark.parametrize("n,m", [(777, 1234), (65536, 1), (1, 65536), (3, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [1, 3, 8, 16])
def test_ard_pairwise_kernel_over_dims_and_shapes(cuda, D, dtype, n, m, with_diag):
    """B6 (the tile layout at 777 x 1234, the flat one below 128 rows or
    columns) against the plain version of its own arithmetic and against
    the plain ARD K."""
    k = gpx.ARDGaussianKernel(1.1, torch.linspace(0.6, 2.4, D, dtype=torch.float64),
                              dtype=dtype, device=cuda)
    x1, x2 = _points(n, D, 30 + D, dtype, cuda), _points(m, D, 31 + D, dtype, cuda)
    diag = dict(noise=0.1, jitter=1e-6) if with_diag else {}
    before = _build.launch_counts["pairwise_ard"]
    got = tpw.pairwise_matrix_ard(k, x1, x2, **diag)
    torch.cuda.synchronize()
    assert _build.launch_counts["pairwise_ard"] == before + 1
    assert got.shape == (n, m) and got.dtype == dtype
    d = tpw._diag_term(0.1, 1e-6, x1) if with_diag else None
    _close(got, tpw.pairwise_ard_prescaled_reference(k.h, tpw.ard_prescale(k, x1),
                                                     tpw.ard_prescale(k, x2), diag=d), dtype)
    _close(got, tpw.pairwise_matrix_ard_reference(k, x1, x2, **diag), dtype)


@pytest.mark.parametrize("n", [100, 777])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [1, 3, 8, 16])
def test_ard_pairwise_symmetric_with_exact_diagonal(cuda, D, dtype, n):
    """K(x, x) from B6 is bitwise symmetric and its diagonal is exactly
    h^2 + (noise^2 + jitter), with and without the noise term."""
    k = gpx.ARDGaussianKernel(0.9, torch.linspace(0.5, 2.0, D, dtype=torch.float64),
                              dtype=dtype, device=cuda)
    x = _points(n, D, 40 + D, dtype, cuda)
    h2 = k.h.to(dtype) * k.h.to(dtype)
    for diag in ({}, dict(noise=0.2, jitter=1e-6)):
        K = tpw.pairwise_matrix_ard(k, x, x, **diag)
        assert torch.equal(K, K.T)
        want = h2 + tpw._diag_term(0.2, 1e-6, x) if diag else h2
        assert torch.equal(K.diagonal(), want.expand(n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family,pair", [("se", (0, 0)), ("se", (0, 1)), ("se", (1, 1)),
                                         ("periodic", (0, 0)), ("periodic", (0, 1)),
                                         ("periodic", (0, 2)), ("periodic", (1, 1)),
                                         ("periodic", (1, 2)), ("periodic", (2, 2))])
def test_hessian_plane_kernel_matches_plain(cuda, family, pair, dtype):
    """B2b's one-plane instantiations, each pair in both orders and on
    shapes that are not tile multiples, against the plain plane and the
    plain version of their own arithmetic; then every plane at once."""
    k = KERNELS[family](dtype, cuda)
    for n, m in ((129, 257), (300, 300), (1000, 1)):
        x1, x2 = _x(n, 50, dtype, cuda), _x(m, 51, dtype, cuda)
        for p, q in (pair, pair[::-1]):
            before = _build.launch_counts["pairwise_hess"]
            got = tpw.pairwise_hessian(k, x1, x2, pair=(p, q))
            torch.cuda.synchronize()
            assert _build.launch_counts["pairwise_hess"] == before + 1
            _close(got, tpw.pairwise_hessian_reference(k, x1, x2, pair=(p, q)), dtype)
            _close(got, tpw.hessian_plane_folded(k, x1, x2, (p, q)), dtype)
        _close(tpw.pairwise_hessian(k, x1, x2), tpw.pairwise_hessian_reference(k, x1, x2), dtype)
        _close(tpw.pairwise_jacobian(k, x1, x2), tpw.pairwise_jacobian_reference(k, x1, x2),
               dtype)


def test_fit_iterative_on_card_matches_cpu(cuda):
    x = _x(600, 11, torch.float64, "cpu")
    y = torch.sin(2 * x)
    k = gpx.GaussianKernel(1.0, 0.5, dtype=torch.float64)
    opts = dict(num_probes=4, num_iters=200, tol=1e-10, precond_rank=64)
    want = gpx.fit_iterative(k, x, y, 0.1, torch.Generator().manual_seed(0), **opts)
    got = gpx.fit_iterative(k.to(cuda), x.to(cuda), y.to(cuda), 0.1,
                            torch.Generator().manual_seed(0), **opts)
    np.testing.assert_allclose(got.alpha.cpu().numpy(), want.alpha.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got.log_marginal.item(), want.log_marginal.item(), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", list(KERNELS))
@pytest.mark.parametrize("chains,n", [(1, 300), (5, 37), (64, 500), (3, 129)])
def test_chain_tables_match_plain(cuda, family, dtype, chains, n):
    k = KERNELS[family](dtype, cuda)
    P = k.n_params
    x = _x(n, 2, dtype, cuda)
    g = torch.Generator().manual_seed(chains)
    theta = (0.5 + torch.rand(chains, P + 1, generator=g, dtype=torch.float64)).to(cuda, dtype)
    params, diag = theta[:, :P], theta[:, P] ** 2 + 1e-6  # params: a strided view
    before = dict(_build.launch_counts)
    _close(tpw.pairwise_matrix_chains(k, x, params, diag),
           tpw.pairwise_matrix_chains_folded(k, x, params, diag), dtype)
    _close(tpw.pairwise_jacobian_chains(k, x, params),
           tpw.pairwise_jacobian_chains_reference(k, x, params), dtype)
    for key in ("pairwise_k_chains", "pairwise_jac_chains"):
        assert _build.launch_counts[key] == before.get(key, 0) + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_blocked_factor_and_value_and_grad_on_card(cuda, dtype):
    from gaussian_processes_tpu_torch.models import gp

    k = gpx.GaussianKernel(1.0, 1.0, dtype=dtype, device=cuda)
    x = _x(300, 3, dtype, cuda)
    y = torch.sin(2 * x)
    g = torch.Generator().manual_seed(4)
    theta = (0.5 + torch.rand(6, 3, generator=g, dtype=torch.float64)).to(cuda, dtype)
    K = tpw.pairwise_matrix_chains(k, x, theta[:, :2], theta[:, 2] ** 2 + 1e-6)
    L = tbc.cholesky_blocked(K)
    back = (L.double() @ L.double().mT - K.double()).norm() / K.double().norm()
    assert float(back) < (1e-6 if dtype == torch.float32 else 1e-13)
    K[2, 200, 200] = -1.0
    nan = torch.isnan(tbc.cholesky_blocked(K)).flatten(1).any(1)
    assert nan.tolist() == [False, False, True, False, False, False]
    lml, grad = gp.log_marginal_value_and_grad_chains(k, x, y, theta, 1e-6)
    cpu = gp.log_marginal_value_and_grad_chains(gpx.GaussianKernel(1.0, 1.0, dtype=torch.float64),
                                                x.cpu().double(),
                                                y.cpu().double(), theta.cpu().double(), 1e-6)
    rel = 1e-3 if dtype == torch.float32 else 1e-9
    torch.testing.assert_close(lml.cpu().double(), cpu[0], rtol=rel, atol=0)
    torch.testing.assert_close(grad.cpu().double(), cpu[1], rtol=0,
                               atol=(2e-2 if dtype == torch.float32 else 1e-8) * cpu[1].abs().max())


# -- the families and trees ported after SE and periodic -----------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", list(NEW_KERNELS))
@pytest.mark.parametrize("n,m", [(300, 300), (129, 257), (1, 1000)])
def test_new_family_pairwise_kernels_match_plain(cuda, family, dtype, n, m):
    """B1 (with and without the diagonal), B2a, B2b's planes and each
    one-plane instantiation, the pair in both orders, and the folded plane."""
    k = NEW_KERNELS[family](dtype, cuda)
    x1, x2 = _x(n, 60, dtype, cuda), _x(m, 61, dtype, cuda)
    before = dict(_build.launch_counts)
    _close(tpw.pairwise_matrix(k, x1, x2), tpw.pairwise_matrix_folded(k, x1, x2), dtype)
    _close(tpw.pairwise_matrix(k, x2, x2, noise=0.1, jitter=1e-6),
           tpw.pairwise_matrix_folded(k, x2, x2, noise=0.1, jitter=1e-6), dtype)
    _close(tpw.pairwise_jacobian(k, x1, x2), tpw.pairwise_jacobian_reference(k, x1, x2), dtype)
    _close(tpw.pairwise_hessian(k, x1, x2), tpw.pairwise_hessian_reference(k, x1, x2), dtype)
    P = k.n_params
    for p in range(P):
        for q in range(P):
            got = tpw.pairwise_hessian(k, x1, x2, pair=(p, q))
            _close(got, tpw.pairwise_hessian_reference(k, x1, x2, pair=(p, q)), dtype)
            _close(got, tpw.hessian_plane_folded(k, x1, x2, (p, q)), dtype)
    torch.cuda.synchronize()
    after = _build.launch_counts
    for key, count in (("pairwise_k", 2), ("pairwise_jac", 1), ("pairwise_hess", 1 + P * P)):
        key += "_" + family
        assert after[key] - before.get(key, 0) == count


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", list(NEW_KERNELS))
def test_new_family_exact_diagonal(cuda, family, dtype):
    """k(0) = h^2 on the diagonal of K(x, x), and a Matérn dK/dw is 0 there."""
    k = NEW_KERNELS[family](dtype, cuda)
    x = _x(200, 62, dtype, cuda)
    h2 = k.h.to(dtype) * k.h.to(dtype)
    assert torch.equal(tpw.pairwise_matrix(k, x, x).diagonal(), h2.expand(200))
    if family != "rq":
        assert torch.equal(tpw.pairwise_jacobian(k, x, x)[1].diagonal(),
                           torch.zeros(200, dtype=dtype, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 4, 8, 9, 16, 300])
@pytest.mark.parametrize("n", [129, 777])
@pytest.mark.parametrize("family", list(NEW_KERNELS))
def test_new_family_products_match_plain(cuda, family, n, r, dtype):
    """B4 and B5 against the plain products and the plain versions of their
    folded arithmetic, with a repeat that must be bit-identical."""
    k, x = NEW_KERNELS[family](dtype, cuda), _x(n, 63, dtype, cuda)
    g = torch.Generator().manual_seed(64 + n + r)
    v = torch.randn(n, r, generator=g, dtype=torch.float64).to(device=cuda, dtype=dtype)
    before = dict(_build.launch_counts)
    got = tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
    gotj = tpw.kernel_jacvec_fused(k, x, v)
    torch.cuda.synchronize()
    for key in ("kernel_matvec_" + family, "kernel_jacvec_" + family):
        assert _build.launch_counts[key] == before.get(key, 0) + 1
    bound = tpw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
    _within_row_sums(got, tpw.kernel_matvec_fused_reference(k, x, v, 0.1, 1e-6), bound, dtype)
    _within_row_sums(got, tpw.matvec_folded_reference(k, x, v)
                     + tpw._diag_term(0.1, 1e-6, x) * v, bound, dtype)
    J_abs = tpw.pairwise_jacobian_reference(k, x, x).abs() @ v.abs()
    _within_row_sums(gotj, tpw.kernel_jacvec_fused_reference(k, x, v), J_abs, dtype)
    _within_row_sums(gotj, tpw.jacvec_folded_reference(k, x, v), J_abs, dtype)
    assert torch.equal(got, tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))
    assert torch.equal(gotj, tpw.kernel_jacvec_fused(k, x, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tree", TREES)
def test_tree_bodies_match_plain(cuda, tree, dtype):
    """B1's tree body (ragged, with the diagonal, a pivot row) and B4's at
    r = 1, 9, 300, with bit-identical repeats."""
    k = _tree(tree, dtype, cuda)
    x1, x2 = _x(129, 65, dtype, cuda), _x(257, 66, dtype, cuda)
    before = dict(_build.launch_counts)
    _close(tpw.pairwise_matrix(k, x1, x2), tpw.pairwise_matrix_folded(k, x1, x2), dtype)
    _close(tpw.pairwise_matrix(k, x1, x1, noise=0.1, jitter=1e-6),
           tpw.pairwise_matrix_folded(k, x1, x1, noise=0.1, jitter=1e-6), dtype)
    _close(tpw.pairwise_matrix(k, x1[:1], x2), tpw.pairwise_matrix_folded(k, x1[:1], x2),
           dtype)
    for n, r in ((777, 1), (777, 9), (300, 300)):
        x = _x(n, 67, dtype, cuda)
        g = torch.Generator().manual_seed(r)
        v = torch.randn(n, r, generator=g, dtype=torch.float64).to(device=cuda, dtype=dtype)
        got = tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
        bound = tpw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
        _within_row_sums(got, tpw.kernel_matvec_fused_reference(k, x, v, 0.1, 1e-6), bound,
                         dtype)
        _within_row_sums(got, tpw.matvec_folded_reference(k, x, v)
                         + tpw._diag_term(0.1, 1e-6, x) * v, bound, dtype)
        assert torch.equal(got, tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))
    torch.cuda.synchronize()
    after = _build.launch_counts
    assert after["pairwise_k_tree"] - before.get("pairwise_k_tree", 0) == 3
    assert after["kernel_matvec_tree"] - before.get("kernel_matvec_tree", 0) == 6


def test_tree_limits_raise_on_the_card(cuda):
    """A tree past the leaf limit and a tree with an ARD leaf raise, and a
    tree never reaches B5 or B2: nothing falls back to the plain version."""
    leaf = gpx.Matern52Kernel(1.0, 1.0, device=cuda)
    big = leaf
    for _ in range(tpw.MAX_TREE_LEAVES):
        big = gpx.ProductKernel(big, leaf)
    x = _x(64, 68, torch.float32, cuda)
    with pytest.raises(ValueError, match="at most"):
        tpw.pairwise_matrix(big, x, x)
    with pytest.raises(ValueError, match="at most"):
        tpw.kernel_matvec_fused(big, x, torch.ones(64, 1, device=cuda), 0.1)
    ard = gpx.ProductKernel(leaf, gpx.ARDGaussianKernel(1.0, torch.ones(2), device=cuda))
    with pytest.raises(TypeError):
        tpw.pairwise_matrix(ard, x, x)
    tree = _tree("product", torch.float32, cuda)
    with pytest.raises(TypeError):
        tpw.kernel_jacvec_fused(tree, x, torch.ones(64, 1, device=cuda))
    with pytest.raises(TypeError):
        tpw.pairwise_jacobian(tree, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", [*NEW_KERNELS, *TREES])
@pytest.mark.parametrize("chains,n", [(1, 300), (64, 500), (3, 129)])
def test_new_chain_tables_match_plain(cuda, kind, dtype, chains, n):
    """B1 and B2a over the chain table for the new families, and a tree's
    (B1's tree body; dK/dtheta from its leaves' launches)."""
    k = NEW_KERNELS[kind](dtype, cuda) if kind in NEW_KERNELS else _tree(kind, dtype, cuda)
    P = k.n_params
    x = _x(n, 69, dtype, cuda)
    g = torch.Generator().manual_seed(chains + n)
    theta = (0.5 + torch.rand(chains, P + 1, generator=g, dtype=torch.float64)).to(cuda, dtype)
    params, diag = theta[:, :P], theta[:, P] ** 2 + 1e-6
    before = dict(_build.launch_counts)
    _close(tpw.pairwise_matrix_chains(k, x, params, diag),
           tpw.pairwise_matrix_chains_folded(k, x, params, diag), dtype)
    _close(tpw.pairwise_jacobian_chains(k, x, params),
           tpw.pairwise_jacobian_chains_reference(k, x, params), dtype)
    torch.cuda.synchronize()
    suffix = "_tree" if kind in TREES else "_" + kind
    key = "pairwise_k_chains" + suffix
    # a product's dK/dtheta takes its children's K: one more tree launch for
    # the product of a sum
    assert _build.launch_counts[key] == before.get(key, 0) + 1 + (kind == "product_of_sum")
    if kind in NEW_KERNELS:
        key = "pairwise_jac_chains" + suffix
        assert _build.launch_counts[key] == before.get(key, 0) + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tree_value_and_grad_chains_on_card(cuda, dtype):
    from gaussian_processes_tpu_torch.models import gp

    k = _tree("product", dtype, cuda)
    x = _x(300, 70, dtype, cuda)
    y = torch.sin(2 * x)
    g = torch.Generator().manual_seed(71)
    theta = (0.5 + torch.rand(6, 6, generator=g, dtype=torch.float64)).to(cuda, dtype)
    lml, grad = gp.log_marginal_value_and_grad_chains(k, x, y, theta, 1e-6)
    k64 = _tree("product", torch.float64, "cpu")
    cpu = gp.log_marginal_value_and_grad_chains(k64, x.cpu().double(), y.cpu().double(),
                                                theta.cpu().double(), 1e-6)
    rel = 1e-3 if dtype == torch.float32 else 1e-9
    torch.testing.assert_close(lml.cpu().double(), cpu[0], rtol=rel, atol=0)
    torch.testing.assert_close(grad.cpu().double(), cpu[1], rtol=0,
                               atol=(2e-2 if dtype == torch.float32 else 1e-8) * cpu[1].abs().max())


# -- B2a contracted over the chains: the samplers' gradient terms ------------


def _contract_problem(kind, dtype, dev, chains, n):
    """A leaf, the (chains, P) table (a strided view), alpha and a symmetric
    K^-1 of O(1) entries."""
    k = ALL_KERNELS[kind](dtype, dev)
    P = k.n_params
    x = _x(n, 80, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(chains + n)
    theta = 0.5 + torch.rand(chains, P + 1, generator=g, dtype=dtype, device=dev)
    alpha = torch.randn(chains, n, generator=g, dtype=dtype, device=dev)
    R = torch.randn(chains, n, n, generator=g, dtype=dtype, device=dev)
    return k, x, theta[:, :P], alpha, 0.5 * (R + R.mT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(ALL_KERNELS))
@pytest.mark.parametrize("chains,n", [(64, 500), (1024, 500), (37, 129)])
def test_jac_contract_chains_match_twin(cuda, kind, dtype, chains, n):
    """Held, per chain and plane, to the float64 twin within a share of
    1/2 sum_ij |dK_p| (|alpha_i alpha_j| + |K^-1_ij|), the size of the sum
    before cancellation."""
    k, x, params, alpha, inv_K = _contract_problem(kind, dtype, cuda, chains, n)
    before = dict(_build.launch_counts)
    got = tpw.jacobian_contract_chains(k, x, params, alpha, inv_K)
    torch.cuda.synchronize()
    key = "pairwise_jac_contract_chains" + ("" if kind in KERNELS else "_" + kind)
    assert _build.launch_counts[key] == before.get(key, 0) + 1
    assert all(_build.launch_counts[c] == before.get(c, 0)
               for c in _build.launch_counts if c.startswith("pairwise_jac_chains"))
    k64 = ALL_KERNELS[kind](torch.float64, cuda)
    x64, p64, a64, w64 = (t.double() for t in (x, params, alpha, inv_K))
    want = tpw.jacobian_contract_chains_reference(k64, x64, p64, a64, w64)
    J = tpw.pairwise_jacobian_chains_reference(k64, x64, p64).abs()
    scale = 0.5 * torch.einsum("cpij,cij->cp", J, (a64[:, :, None] * a64[:, None, :]).abs()
                               + w64.abs())
    del J
    share = float(((got.double() - want).abs() / scale).max())
    assert share < (1e-5 if dtype == torch.float32 else 1e-12), share


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["se", "rq"])
def test_jac_contract_chains_repeats_bit_identical(cuda, kind, dtype):
    k, x, params, alpha, inv_K = _contract_problem(kind, dtype, cuda, 1024, 500)
    first = tpw.jacobian_contract_chains(k, x, params, alpha, inv_K)
    assert torch.equal(tpw.jacobian_contract_chains(k, x, params, alpha, inv_K), first)


def test_value_and_grad_chains_1024_peak_memory(cuda):
    """Config #5's batch, 1024 SE chains at n = 500 in float32: the
    Jacobian is never stored, so the factorization sets the peak, under
    4.5 MB a chain."""
    from gaussian_processes_tpu_torch.models import gp

    C, n = 1024, 500
    k = KERNELS["se"](torch.float32, cuda)
    x = _x(n, 81, torch.float32, cuda)
    y = torch.sin(2 * x)
    g = torch.Generator().manual_seed(82)
    theta = (0.5 + torch.rand(C, 3, generator=g, dtype=torch.float64)).to(cuda, torch.float32)
    gp.log_marginal_value_and_grad_chains(k, x, y, theta, 1e-6)  # the build, cuBLAS's workspace
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    before = dict(_build.launch_counts)
    lml, grad = gp.log_marginal_value_and_grad_chains(k, x, y, theta, 1e-6)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(cuda) - base
    assert rise < 4.5e6 * C, rise
    assert _build.launch_counts["pairwise_jac_contract_chains"] == \
        before.get("pairwise_jac_contract_chains", 0) + 1
    assert _build.launch_counts["pairwise_jac_chains"] == before.get("pairwise_jac_chains", 0)
    assert bool(torch.isfinite(lml).all()) and bool(torch.isfinite(grad).all())


# -- the folded element of B1 and B4 (redesigned together) ---------------------

RQ_A = [0.7, 1.5, 940.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", [*ALL_KERNELS, *TREES, "rq_a"])
def test_b1_folded_element_repeats_bit_identical(cuda, kind, dtype):
    """B1 in every case (ragged, with the diagonal, a pivot row, a chain
    table) against ``pairwise_matrix_folded``, repeated bit for bit; RQ at
    a = 0.7, 1.5 and 940."""
    if kind == "rq_a":
        ks = [gpx.RationalQuadraticKernel(0.9, 1.1, a, dtype=dtype, device=cuda) for a in RQ_A]
    elif kind in TREES:
        ks = [_tree(kind, dtype, cuda)]
    else:
        ks = [ALL_KERNELS[kind](dtype, cuda)]
    x1, x2 = _x(129, 72, dtype, cuda), _x(257, 73, dtype, cuda)
    for k in ks:
        for a, b, diag in ((x1, x2, {}), (x1, x1, dict(noise=0.1, jitter=1e-6)),
                           (x1[:1], x2, {})):
            got = tpw.pairwise_matrix(k, a, b, **diag)
            _close(got, tpw.pairwise_matrix_folded(k, a, b, **diag), dtype)
            assert torch.equal(got, tpw.pairwise_matrix(k, a, b, **diag))
        P = k.n_params
        g = torch.Generator().manual_seed(74)
        theta = (0.5 + torch.rand(3, P + 1, generator=g, dtype=torch.float64)).to(cuda, dtype)
        got = tpw.pairwise_matrix_chains(k, x1, theta[:, :P], theta[:, P] ** 2)
        _close(got, tpw.pairwise_matrix_chains_folded(k, x1, theta[:, :P], theta[:, P] ** 2),
               dtype)
        assert torch.equal(got, tpw.pairwise_matrix_chains(k, x1, theta[:, :P], theta[:, P] ** 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", [*ALL_KERNELS, *TREES])
def test_pivot_rows_bit_identical_to_the_column(cuda, kind, dtype):
    """``pivot_rows`` (the parameters read once, one B1 launch a row) gives
    the pivoted Cholesky's row K[piv, :] equal bit for bit to the column
    K[:, piv] and to ``pairwise_matrix``'s row."""
    k = _tree(kind, dtype, cuda) if kind in TREES else ALL_KERNELS[kind](dtype, cuda)
    x = _x(4099, 75, dtype, cuda)
    row = tpw.pivot_rows(k, x)
    before = _build.launch_counts["pairwise_k" + ("_tree" if kind in TREES else (
        "" if kind in KERNELS else "_" + kind))]
    for i in (0, 1234, 4098):
        got = row(x[i:i + 1]).clone()
        assert torch.equal(got, tpw.pairwise_matrix(k, x, x[i:i + 1])[:, 0])
        assert torch.equal(got, tpw.pairwise_matrix(k, x[i:i + 1], x)[0])
    after = _build.launch_counts["pairwise_k" + ("_tree" if kind in TREES else (
        "" if kind in KERNELS else "_" + kind))]
    assert after - before == 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("a", RQ_A)
@pytest.mark.parametrize("n,r", [(129, 1), (777, 9), (300, 300)])
def test_b4_rq_folded_log_matches_plain(cuda, a, n, r, dtype):
    """B4's RQ case (log1p_base: the series below B = 17/16, lg2.approx
    above) against its folded plain version and the plain product, with a
    bit-identical repeat."""
    k = gpx.RationalQuadraticKernel(0.9, 1.1, a, dtype=dtype, device=cuda)
    x = _x(n, 76, dtype, cuda)
    g = torch.Generator().manual_seed(77 + r)
    v = torch.randn(n, r, generator=g, dtype=torch.float64).to(device=cuda, dtype=dtype)
    got = tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
    bound = tpw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
    _within_row_sums(got, tpw.matvec_folded_reference(k, x, v) + tpw._diag_term(0.1, 1e-6, x) * v,
                     bound, dtype)
    assert torch.equal(got, tpw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))


# --- slice 3 (structured grids) on the card: each path keeps its tensors on
# the card and agrees with the same computation in float64 on the CPU


def _grid(n, device, dtype=torch.float64):
    x = torch.arange(n, dtype=torch.float64) * (6.0 / n) - 3.0
    y = torch.sin(2 * x) + 0.1 * torch.randn(n, generator=torch.Generator().manual_seed(0),
                                             dtype=torch.float64)
    return x.to(device=device, dtype=dtype), y.to(device=device, dtype=dtype)


@pytest.mark.parametrize("family", ["se", "matern52"])
def test_toeplitz_fit_on_card_matches_cpu(cuda, family):
    # decaying kernels, whose Strang-preconditioned solve converges to tol in
    # 100 iterations (the periodic kernel's does not: 4.8e-5 after 100, so
    # the two devices' roundings steer two unconverged iterates apart)
    from gaussian_processes_tpu_torch.ops import toeplitz

    x, y = _grid(4096, cuda)
    k = ALL_KERNELS[family](torch.float64, cuda)
    _build.launch_counts.clear()
    col = toeplitz.toeplitz_column(k, x)
    assert sum(_build.launch_counts.values()) == 1 and col.device.type == "cuda"
    want_col = toeplitz.toeplitz_column(ALL_KERNELS[family](torch.float64, "cpu"), x.cpu())
    torch.testing.assert_close(col.cpu(), want_col, rtol=1e-10, atol=1e-12)
    opts = dict(num_probes=4, num_iters=100, tol=1e-10, structure="toeplitz")
    _build.launch_counts.clear()
    got = gpx.fit_iterative(k, x, y, 0.3, torch.Generator().manual_seed(1), **opts)
    # one column serves the matvec and the Strang preconditioner
    assert sum(_build.launch_counts.values()) == 1
    want = gpx.fit_iterative(ALL_KERNELS[family](torch.float64, "cpu"), x.cpu(), y.cpu(), 0.3,
                             torch.Generator().manual_seed(1), **opts)
    assert got.alpha.device.type == "cuda"
    torch.testing.assert_close(got.alpha.cpu(), want.alpha, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(got.log_marginal.cpu(), want.log_marginal, rtol=1e-8, atol=0)


@pytest.mark.parametrize("chains", [1, 8])
def test_whittle_value_and_grad_on_card_match_cpu(cuda, chains):
    from gaussian_processes_tpu_torch.inference import make_log_posterior_whittle

    x, y = _grid(1 << 14, cuda)
    u0 = torch.log(torch.tensor([1.0, 0.3, 0.1], dtype=torch.float64))
    u = u0[None] + 0.05 * torch.randn((chains, 3), generator=torch.Generator().manual_seed(2),
                                      dtype=torch.float64)
    qp = lambda dev: gpx.ProductKernel(KERNELS["se"](torch.float64, dev),  # noqa: E731
                                       KERNELS["periodic"](torch.float64, dev))
    for make, uu in ((lambda dev: KERNELS["se"](torch.float64, dev), u),
                     (qp, torch.cat([u[:, :2], torch.log(torch.tensor([[0.9, 1.1, 2.0]] * chains,
                                                                       dtype=torch.float64)),
                                     u[:, 2:]], dim=1))):
        got = make_log_posterior_whittle(make(cuda), x, y, prior_mean=uu[0].to(cuda))
        want = make_log_posterior_whittle(make("cpu"), x.cpu(), y.cpu(), prior_mean=uu[0])
        gv, gg = got.value_and_grad(uu.to(cuda))
        wv, wg = want.value_and_grad(uu)
        assert gv.device.type == "cuda" and gg.device.type == "cuda"
        torch.testing.assert_close(gv.cpu(), wv, rtol=1e-10, atol=1e-8)
        torch.testing.assert_close(gg.cpu(), wg, rtol=1e-10, atol=1e-8)


def test_ski_on_card_matches_cpu_and_repeats_bitwise(cuda):
    from gaussian_processes_tpu_torch.ops import ski

    g = torch.Generator().manual_seed(3)
    x = torch.sort(torch.rand(20000, generator=g, dtype=torch.float64) * 6 - 3)[0]
    v = torch.randn((20000, 3), generator=g, dtype=torch.float64)
    op_cpu = ski.interpolation_weights(x, ski.make_grid(x, 2048))
    op = ski.interpolation_weights(x.to(cuda), ski.make_grid(x.to(cuda), 2048))
    a = ski.interp_rmatvec(op, v.to(cuda))
    assert torch.equal(a, ski.interp_rmatvec(op, v.to(cuda)))
    torch.testing.assert_close(a.cpu(), ski.interp_rmatvec(op_cpu, v), rtol=1e-12, atol=1e-12)
    k = KERNELS["se"](torch.float64, cuda)
    _build.launch_counts.clear()
    got = ski.kernel_matvec_ski(k, op, v.to(cuda), 0.2)
    assert _build.launch_counts["pairwise_k"] == 1
    want = ski.kernel_matvec_ski(KERNELS["se"](torch.float64, "cpu"), op_cpu, v, 0.2)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("ndim", [1, 2])
def test_ski_clustered_scatter_on_card_matches_cpu_and_repeats_bitwise(cuda, ndim):
    # 3/4 of the inputs inside one grid cell: the busiest grid points carry
    # ~n taps each, one long segment of the sorted taps
    from gaussian_processes_tpu_torch.ops import ski

    g = torch.Generator().manual_seed(6)
    n = 20000
    x = torch.rand((n, ndim), generator=g, dtype=torch.float64) * 6 - 3
    x[: 3 * n // 4] = 0.4 + 1e-4 * torch.randn((3 * n // 4, ndim), generator=g,
                                               dtype=torch.float64)
    v = torch.randn((n, 9), generator=g, dtype=torch.float64)

    def build(xd):
        if ndim == 1:
            return ski.interpolation_weights(xd[:, 0], ski.make_grid(xd[:, 0], 512)), \
                ski.interp_rmatvec
        return ski.interpolation_weights_nd(xd, tuple(ski.make_grid(xd[:, d], 64)
                                                      for d in range(ndim))), \
            ski.interp_rmatvec_nd

    (op, rm), (op_cpu, _) = build(x.to(cuda)), build(x)
    assert int(op.seg_len.max()) >= 3 * n // 4 and op.seg_pts.numel() == n * 4 ** ndim
    for dtype in (torch.float32, torch.float64):
        a = rm(op, v.to(cuda, dtype))
        assert torch.equal(a, rm(op, v.to(cuda, dtype)))
        want = rm(op_cpu, v)
        tol = 1e-12 if dtype == torch.float64 else 1e-4
        assert float(torch.linalg.norm(a.cpu().double() - want) / torch.linalg.norm(want)) < tol


def test_ski_kron_refine_on_card_reaches_its_target(cuda):
    from gaussian_processes_tpu_torch.ops import ski

    g = torch.Generator().manual_seed(4)
    x = (torch.rand((4096, 2), generator=g) * 2 - 1).to(cuda)
    y = torch.sin(3 * x[:, 0]) * torch.cos(2 * x[:, 1]) + 0.1 * torch.randn(
        4096, generator=g).to(cuda)
    k = gpx.ARDGaussianKernel(1.0, torch.tensor([0.2, 0.2]), dtype=torch.float32, device=cuda)
    op = ski.interpolation_weights_nd(x, (ski.make_grid(x[:, 0], 32), ski.make_grid(x[:, 1], 32)))
    post = gpx.fit_iterative(k, x, y, 0.1, torch.Generator().manual_seed(5), num_probes=2,
                             num_iters=100, tol=1e-7, jitter=1e-4, precond_rank=128,
                             structure=op, replace_every=10)
    _build.launch_counts.clear()
    (hi, lo), rel = ski.ski_kron_refine(k, op, x, post.alpha, y, 0.1, jitter=1e-4,
                                        precond_rank=128, rounds=2)
    assert _build.launch_counts["pairwise_ard"] == 128  # B6's pivot rows
    assert hi.device.type == "cuda" and hi.dtype == torch.float32 and float(rel) < 1e-6


def test_fit_large_task_on_card_matches_cpu(cuda):
    import dataclasses

    from gaussian_processes_tpu_torch import cli
    from gaussian_processes_tpu_torch.utils import CONFIGS

    cfg = CONFIGS["config4_large_n"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n=1024),
                              fit=dataclasses.replace(cfg.fit, dtype="float64"))
    got = cli.run_config(cfg, device="cuda")
    want = cli.run_config(cfg, device="cpu")
    assert got["peak_memory_gb"] > 0 and got["fit_wall_s"] > 0
    np.testing.assert_allclose(got["log_marginal"], want["log_marginal"], rtol=1e-10)


def test_fit_blockcyclic_on_card_matches_fit(cuda):
    """``fit_blockcyclic`` at W = 1 with no process group, float64, n = 2048
    and b = 256 (one B1 strip, B3 under each of the 8 diagonal blocks)
    against ``fit`` on the card, and its predictions against
    ``predict_diag``."""
    from gaussian_processes_tpu_torch import parallel

    f64 = torch.float64
    mesh = parallel.make_chain_mesh(axis="shard", device=cuda)
    x = _x(2048, 7, f64, cuda)
    y = torch.sin(2 * x) + 0.1 * _x(2048, 8, f64, cuda)
    k = KERNELS["se"](f64, cuda)
    _build.launch_counts.clear()
    post = parallel.fit_blockcyclic(k, x, y, 0.2, mesh, block_size=256, jitter=1e-6)
    assert _build.launch_counts["pairwise_k"] == 1 and _build.launch_counts["chol_tile"] == 16
    want = gpx.fit(k, x, y, 0.2, 1e-6)
    np.testing.assert_allclose(float(post.log_marginal), float(want.log_marginal), rtol=1e-10)
    torch.testing.assert_close(post.alpha, want.alpha, rtol=1e-7, atol=1e-9)
    xo = torch.linspace(-3, 3, 40, dtype=f64, device=cuda)
    m_bc, v_bc = parallel.predict_diag_blockcyclic(post, xo, mesh)
    m, v = gpx.predict_diag(want, xo)
    torch.testing.assert_close(m_bc, m, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(v_bc, v, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b1_blockcyclic_strip_matches_plain(cuda, dtype):
    """B1 on rank 1's (1024, 4096) strip of n = 4096 over 4 ranks, b = 256,
    against its folded arithmetic and ``pairwise_matrix_reference``."""
    x = _x(4096, 3, dtype, cuda)
    x_own = x.view(4, 4, 256)[:, 1].reshape(-1)
    k = KERNELS["se"](dtype, cuda)
    got = tpw.pairwise_matrix(k, x_own, x)
    assert got.shape == (1024, 4096)
    _close(got, tpw.pairwise_matrix_folded(k, x_own, x), dtype)
    _close(got, tpw.pairwise_matrix_reference(k, x_own, x), dtype)


def test_forward_solve_steps_are_gemms_on_card(cuda):
    """The forward substitution at n = 8192, b = 256 (m = 32), W = 1 with no
    process group, r = 200, float32: at most 4 device kernels a block step
    (the diagonal blocks' inverses counted apart), none of them a TRSM, and
    the solution within twice the float32 triangular solve's distance from
    float64."""
    from gaussian_processes_tpu_torch import parallel
    from gaussian_processes_tpu_torch.parallel import block_cholesky as bc
    from gaussian_processes_tpu_torch.utils import profiling

    f32, b, r = torch.float32, 256, 200
    mesh = parallel.make_chain_mesh(axis="shard", device=cuda)
    x = _x(8192, 11, f32, cuda)
    y = torch.sin(2 * x) + 0.1 * _x(8192, 12, f32, cuda)
    post = parallel.fit_blockcyclic(KERNELS["se"](f32, cuda), x, y, 0.1, mesh, block_size=b,
                                    jitter=1e-4)
    S, m = post.L_blocks, post.n_blocks
    rhs = torch.randn(m * b, r, generator=torch.Generator().manual_seed(5)).to(cuda)

    def device_kernels(fn):
        fn()  # warm
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof, profiling.spans_enabled():
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        return kernels, {e.name for e in events}

    inverse_kernels, _ = device_kernels(lambda: bc._diagonal_inverses(S, 0, 1, b))
    kernels, names = device_kernels(lambda: bc._forward_solve(S, rhs, mesh, m, b))
    assert "gp.solve.forward" in names and inverse_kernels
    assert not [k for k in kernels if "trsm" in k.lower()]
    assert len(kernels) - len(inverse_kernels) <= 4 * m, (len(kernels), len(inverse_kernels))
    want = torch.linalg.solve_triangular(torch.tril(S.double()), rhs.double(), upper=False)

    def err(Y):
        return float((Y.double() - want).norm() / want.norm())

    trsm = torch.linalg.solve_triangular(torch.tril(S), rhs, upper=False)
    assert err(bc._forward_solve(S, rhs, mesh, m, b)) < 2 * err(trsm)
