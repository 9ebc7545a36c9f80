"""Exact GP regression with the squared-exponential kernel, written plainly.

k(x1, x2) = h^2 exp(-(x1 - x2)^2 / (2 w^2)); K + (s^2 + jitter) I is factored
by a right-looking blocked Cholesky in place (the diagonal blocks by
``torch.linalg.cholesky_ex``, the panels by ``solve_triangular``, the
trailing lower triangle by GEMMs through ``Arith``), then
alpha = K^-1 y by blocked substitutions,
lml = -y.alpha / 2 - sum(log diag L) - n log(2 pi) / 2,
the predictive mean K(xo, x) alpha and variance h^2 - ||L^-1 K(x, xo)||^2.
Everything works on a single matrix (n, n) or a stack (C, n, n).
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.arith import Arith

LOG_2PI = math.log(2.0 * math.pi)


def se_block(x1, x2, h, w):
    """h^2 exp(-(x1_i - x2_j)^2 / (2 w^2)), (len(x1), len(x2))."""
    d = (x1[:, None] - x2[None, :]) / w
    return (h * h) * torch.exp(-0.5 * d * d)


def se_matrix(x, h, w, diag, arith: Arith, rows: int = 2048):
    """K(x, x) + diag I in ``arith.dtype``, built in row blocks."""
    x = x.to(arith.dtype)
    n = x.shape[0]
    A = torch.empty((n, n), dtype=arith.dtype, device=x.device)
    for i in range(0, n, rows):
        A[i:i + rows] = se_block(x[i:i + rows], x, h, w)
    A.diagonal().add_(diag)
    return A


def residual(x, y, alpha, h, w, diag, rows: int = 2048) -> float:
    """||(K + diag I) alpha - y|| / ||y|| in float64, K built in row blocks
    and never stored."""
    x, y, alpha = (t.to(torch.float64) for t in (x, y, alpha))
    r = diag * alpha - y
    for i in range(0, x.shape[0], rows):
        r[i:i + rows] += se_block(x[i:i + rows], x, h, w) @ alpha
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y))


def cholesky_(A, arith: Arith, block: int, pieces: int = 8):
    """Lower Cholesky factor of A (..., n, n) in place; the strict upper
    triangle is left as scratch.  A diagonal block that is not positive
    definite turns into NaN, which then spreads."""
    n = A.shape[-1]
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        L_kk, info = torch.linalg.cholesky_ex(A[..., k0:k1, k0:k1])
        bad = (info != 0)[..., None, None]
        L_kk = torch.where(bad, torch.full_like(L_kk, float("nan")), L_kk)
        A[..., k0:k1, k0:k1] = L_kk
        if k1 == n:
            break
        P = torch.linalg.solve_triangular(L_kk.mT, A[..., k1:, k0:k1], upper=True, left=False)
        A[..., k1:, k0:k1] = P
        # trailing update of the lower triangle only: row pieces, each up to
        # the diagonal of its last row
        rows = n - k1
        cut = [k1 + rows * i // pieces for i in range(pieces + 1)]
        for r0, r1 in zip(cut[:-1], cut[1:]):
            if r1 > r0:
                arith.gemm_(A[..., r0:r1, k1:r1], P[..., r0 - k1:r1 - k1, :],
                            P[..., :r1 - k1, :].mT)
    return A


def forward_(L, Y, arith: Arith, block: int):
    """L Z = Y in place (..., n, r), L lower (its upper triangle ignored)."""
    n = L.shape[-1]
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        if k0:
            arith.gemm_(Y[..., k0:k1, :], L[..., k0:k1, :k0], Y[..., :k0, :])
        Y[..., k0:k1, :] = torch.linalg.solve_triangular(
            L[..., k0:k1, k0:k1], Y[..., k0:k1, :], upper=False)
    return Y


def backward_(L, Y, arith: Arith, block: int):
    """L^T Z = Y in place, from the last block up."""
    n = L.shape[-1]
    starts = list(range(0, n, block))
    for k0 in reversed(starts):
        k1 = min(k0 + block, n)
        if k1 < n:
            arith.gemm_(Y[..., k0:k1, :], L[..., k1:, k0:k1].mT, Y[..., k1:, :])
        Y[..., k0:k1, :] = torch.linalg.solve_triangular(
            L[..., k0:k1, k0:k1].mT, Y[..., k0:k1, :], upper=True)
    return Y


def fit(x, y, h, w, noise, jitter, arith: Arith, block: int, keep_factor: bool = False):
    """alpha, lml (and the factor) of the exact fit on (x, y)."""
    dt = arith.dtype
    x, y = x.to(dt), y.to(dt)
    n = x.shape[0]
    A = se_matrix(x, h, w, noise * noise + jitter, arith)
    cholesky_(A, arith, block)
    half_logdet = torch.log(torch.diagonal(A)).sum()
    z = forward_(A, y[:, None].clone(), arith, block)
    alpha = backward_(A, z, arith, block)[:, 0]
    lml = -0.5 * torch.dot(y, alpha) - half_logdet - 0.5 * n * LOG_2PI
    return alpha, lml, (A if keep_factor else None)


def predict(L, x, alpha, xo, h, w, arith: Arith, block: int):
    """Predictive mean and variance at xo from the factor L of the fit on x."""
    dt = arith.dtype
    x, xo, alpha = x.to(dt), xo.to(dt), alpha.to(dt)
    Kxo = se_block(x, xo, h, w)  # (n, r)
    mean = arith.mm(Kxo.T, alpha[:, None])[:, 0]
    V = forward_(L, Kxo, arith, block)
    return mean, h * h - torch.sum(V * V, dim=0)
