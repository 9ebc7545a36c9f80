"""Exact GP regression — the functional core.

Counterpart of ``gaussian_processes_tpu/models/gp.py``:

    fit(kernel, x, y, noise) -> GPPosterior     (frozen dataclass of tensors)
    predict(post, xo)        -> (mean, cov)

Model:   y ~ N(0, K_f(x, x) + s^2 I)       (s = noise standard deviation)

    log p(y | x, theta) = -1/2 y^T K^-1 y - sum(log diag L) - n/2 log 2pi

Hyperparameter derivatives of the log marginal likelihood, with
alpha = K^-1 y and K_p = dK/dtheta_p (analytic kernel Jacobians/Hessians):

    d log p / d theta_p = 1/2 alpha^T K_p alpha - 1/2 tr(K^-1 K_p)

    d2 log p / d theta_p d theta_q =
        1/2 alpha^T K_pq alpha
        - 1/2 alpha^T (K_p K^-1 K_q + K_q K^-1 K_p) alpha
        + 1/2 tr(K^-1 K_q K^-1 K_p) - 1/2 tr(K^-1 K_pq)

The full parameter vector is theta = (kernel params..., s); the noise
components use dK/ds = 2 s I, d2K/ds2 = 2 I, cross terms zero.

Everything runs where the input tensors live.  On a CUDA card K and the
cross-covariances come from kernel B1 (the noise diagonal fused in; B6 for
an ARD kernel over (n, D) inputs), dK/dtheta
and d2K/dtheta2 from B2, and every Cholesky factor from the blocked
factorization over kernel B3 (ops/blocked_cholesky.py).  Random draws take a
``torch.Generator`` where the JAX package takes a key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gaussian_processes_tpu_torch.models.base import Kernel
from gaussian_processes_tpu_torch.ops.blocked_cholesky import (
    choose_cholesky,
    choose_solve,
)
from gaussian_processes_tpu_torch.ops.pairwise import (
    is_tree,
    jacobian_contract_chains,
    pairwise_jacobian_chains,
    pairwise_matrix,
    pairwise_matrix_ard,
    pairwise_matrix_chains,
)
from gaussian_processes_tpu_torch.utils.profiling import counts

_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class GPPosterior:
    """Everything the predictive equations need, computed once by ``fit``.

    Attributes:
      kernel: the covariance kernel.
      x: training inputs, shape (n,).
      y: training targets, shape (n,).
      noise: observation noise standard deviation s (scalar or (n,)).
      L: lower Cholesky factor of K = K_f(x, x) + (s^2 + jitter) I, (n, n).
      alpha: K^-1 y, shape (n,).
      log_marginal: log p(y | x, theta), scalar.
    """

    kernel: Kernel
    x: torch.Tensor
    y: torch.Tensor
    noise: torch.Tensor
    L: torch.Tensor
    alpha: torch.Tensor
    log_marginal: torch.Tensor


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def build_kxx(kernel: Kernel, x, noise, jitter=0.0) -> torch.Tensor:
    """Noise-augmented kernel matrix K = K_f(x, x) + (s^2 + jitter) I.

    ``noise`` may be a scalar s, fused into the K build, or an (n,) vector of
    per-point noise standard deviations (heteroscedastic observations), added
    in place to the diagonal of the freshly built K.  The analytic gradient
    paths assume the scalar form (dK/ds = 2s I).  1-D inputs go through
    kernel B1 on a card, (n, D) inputs with an ARD kernel through B6.
    """
    x = torch.as_tensor(x)
    noise = _like(noise, x)
    build = pairwise_matrix_ard if x.ndim == 2 else pairwise_matrix
    if noise.ndim == 1:
        K = build(kernel, x, x)
        K.diagonal().add_(torch.square(noise) + jitter)
        return K
    return build(kernel, x, x, noise=noise, jitter=jitter)


def _lml(y, alpha, L) -> torch.Tensor:
    n = y.shape[0]
    return (
        -0.5 * torch.dot(y, alpha)
        - torch.sum(torch.log(torch.diagonal(L)))
        - 0.5 * n * _LOG_2PI
    )


def _factor_solve(Kxx, y):
    """(L, alpha, lml) of the built K = ``Kxx``."""
    L = choose_cholesky(Kxx)(Kxx)
    del Kxx
    solve = choose_solve(L)
    alpha = solve(L, solve(L, y), trans=True)
    return L, alpha, _lml(y, alpha, L)


def _chol_pieces(kernel, x, y, noise, jitter):
    return _factor_solve(build_kxx(kernel, x, noise, jitter), y)


def _inputs(x, y, noise):
    x = torch.as_tensor(x)
    y = _like(y, x)
    return x, y, _like(noise, x)


def fit(kernel: Kernel, x, y, noise, jitter=0.0) -> GPPosterior:
    """Exact GP fit: kernel build + one Cholesky factorization + two solves."""
    x, y, noise = _inputs(x, y, noise)
    L, alpha, log_marginal = _chol_pieces(kernel, x, y, noise, jitter)
    return GPPosterior(kernel=kernel, x=x, y=y, noise=noise, L=L,
                       alpha=alpha, log_marginal=log_marginal)


def predict(post: GPPosterior, xo) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior predictive mean (m,) and full covariance (m, m) of f(xo).

    mean = K_xo,x alpha;  cov = K_xo,xo - v^T v with v = L^-1 K_x,xo.
    (Latent-function covariance; add s^2 I for observation noise.)
    """
    xo = _like(xo, post.x)
    Kxox = post.kernel(xo, post.x)
    mean = Kxox @ post.alpha
    v = choose_solve(post.L)(post.L, Kxox.T)
    cov = post.kernel(xo, xo) - v.T @ v
    return mean, cov


def predict_mean(post: GPPosterior, xo) -> torch.Tensor:
    """Posterior predictive mean only — O(n m), no covariance solve."""
    xo = _like(xo, post.x)
    return post.kernel(xo, post.x) @ post.alpha


def predict_diag(post: GPPosterior, xo) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior predictive mean and per-point variance (no m x m matrix).

    var_i = k(xo_i, xo_i) - ||L^-1 k_i||^2.
    """
    xo = _like(xo, post.x)
    Kxox = post.kernel(xo, post.x)
    mean = Kxox @ post.alpha
    v = choose_solve(post.L)(post.L, Kxox.T)
    var = post.kernel.kdiag(xo) - torch.sum(v * v, dim=0)
    return mean, var


def log_predictive_density(post: GPPosterior, xo, yo) -> torch.Tensor:
    """log p(yo | xo, x, y, theta) under the posterior predictive: the
    predictive covariance of f(xo) plus s^2 on the diagonal, evaluated as a
    multivariate normal log density through its Cholesky factor."""
    xo = _like(xo, post.x)
    yo = _like(yo, post.x)
    mean, cov = predict(post, xo)
    m = xo.shape[0]
    cov.diagonal().add_(torch.square(post.noise))
    Lc = choose_cholesky(cov)(cov)
    r = choose_solve(Lc)(Lc, yo - mean)
    return (
        -0.5 * torch.dot(r, r)
        - torch.sum(torch.log(torch.diagonal(Lc)))
        - 0.5 * m * _LOG_2PI
    )


def sample_posterior(
    post: GPPosterior, xo, generator: Optional[torch.Generator] = None,
    n_samples: int = 1, jitter: float = 1e-9,
) -> torch.Tensor:
    """Draw function samples f(xo) ~ posterior, shape (n_samples, m).

    Uses the predictive Cholesky; the tiny jitter keeps the factor of the
    (often numerically rank-deficient) predictive covariance defined.  The
    generator must live on the posterior's device.
    """
    xo = _like(xo, post.x)
    mean, cov = predict(post, xo)
    m = xo.shape[0]
    cov.diagonal().add_(jitter)
    Lc = choose_cholesky(cov)(cov)
    eps = torch.randn((n_samples, m), generator=generator, dtype=cov.dtype,
                      device=cov.device)
    return mean[None, :] + eps @ Lc.T


def log_marginal_likelihood(kernel: Kernel, x, y, noise, jitter=0.0) -> torch.Tensor:
    """log p(y | x, theta)."""
    x, y, noise = _inputs(x, y, noise)
    return _chol_pieces(kernel, x, y, noise, jitter)[2]


def loo_predictive(post: GPPosterior) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact leave-one-out predictives from ONE factorization.

    Closed form (Rasmussen & Williams §5.4.2, with A = K^-1):
    mu_i = y_i - alpha_i / A_ii, var_i = 1 / A_ii (y-space, noise included).
    Returns (mu, var, log pseudo-likelihood = sum_i log N(y_i; mu_i, var_i)).
    """
    n = post.L.shape[0]
    eye = torch.eye(n, dtype=post.L.dtype, device=post.L.device)
    Linv = choose_solve(post.L)(post.L, eye)
    diag_A = torch.sum(torch.square(Linv), dim=0)  # diag(K^-1)
    mu = post.y - post.alpha / diag_A
    var = 1.0 / diag_A
    lpl = -0.5 * torch.sum(torch.square(post.y - mu) / var + torch.log(var) + _LOG_2PI)
    return mu, var, lpl


def extend_posterior(post: GPPosterior, x_new, y_new, jitter: float = 0.0) -> GPPosterior:
    """Online update: append k observations in O(n^2 k), not O((n+k)^3).

    Cholesky append via the Schur complement:

        L' = [[L, 0], [B^T, chol(S)]],  B = L^-1 K(x, x_new),
        S  = K(x_new, x_new) + (s^2 + jitter) I - B^T B

    alpha and log_marginal are recomputed from L' by two triangular solves.
    """
    if post.noise.ndim != 0:
        raise ValueError(
            "extend_posterior supports scalar noise (per-point noise for "
            "the appended block would be ambiguous); refit instead"
        )
    x_new = torch.atleast_1d(_like(x_new, post.x))
    y_new = torch.atleast_1d(_like(y_new, post.x))
    k = y_new.shape[0]
    n = post.y.shape[0]
    solve = choose_solve(post.L)
    Kxn = post.kernel(post.x, x_new)                       # (n, k)
    Knn = build_kxx(post.kernel, x_new, post.noise, jitter)
    B = solve(post.L, Kxn)                                 # (n, k)
    S = Knn - B.T @ B
    S = 0.5 * (S + S.T)
    L_S = choose_cholesky(S)(S)
    L_new = post.L.new_zeros((n + k, n + k))
    L_new[:n, :n] = post.L
    L_new[n:, :n] = B.T
    L_new[n:, n:] = L_S
    x_all = torch.cat([post.x, x_new])
    y_all = torch.cat([post.y, y_new])
    v = solve(L_new, y_all)
    alpha = solve(L_new, v, trans=True)
    lml = (
        -0.5 * torch.dot(v, v)
        - torch.sum(torch.log(torch.diagonal(L_new)))
        - 0.5 * (n + k) * _LOG_2PI
    )
    return GPPosterior(kernel=post.kernel, x=x_all, y=y_all, noise=post.noise,
                       L=L_new, alpha=alpha, log_marginal=lml)


def _full_jacobian(kernel: Kernel, x, noise) -> torch.Tensor:
    """dK/dtheta for theta = (kernel params..., s); shape (P + 1, n, n)."""
    n = x.shape[0]
    P = kernel.n_params
    J = x.new_zeros((P + 1, n, n))
    J[:P] = kernel.jacobian(x, x)
    J[P].diagonal().copy_((2.0 * noise).expand(n))
    return J


def _full_hessian(kernel: Kernel, x) -> torch.Tensor:
    """d2K/dtheta2 for theta = (kernel params..., s); (P+1, P+1, n, n),
    written in place into one zeroed buffer."""
    n = x.shape[0]
    P = kernel.n_params
    out = x.new_zeros((P + 1, P + 1, n, n))
    out[:P, :P] = kernel.hessian(x, x)
    out[P, P].diagonal().fill_(2.0)
    return out


def _grad_pieces(kernel, x, y, noise, jitter):
    """One factorization shared by the gradient and Hessian assemblies."""
    L, alpha, lml = _chol_pieces(kernel, x, y, noise, jitter)
    n = x.shape[0]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    inv_L = choose_solve(L)(L, eye)
    inv_K = inv_L.T @ inv_L
    del inv_L
    J = _full_jacobian(kernel, x, noise)
    return alpha, lml, inv_K, J


def _grad_from_pieces(alpha, inv_K, J):
    quad = torch.einsum("i,pij,j->p", alpha, J, alpha)
    trace = torch.einsum("ij,pji->p", inv_K, J)
    return 0.5 * (quad - trace)


def _hessian_from_pieces(kernel, x, alpha, inv_K, J):
    H = _full_hessian(kernel, x)                           # (T, T, n, n)
    Ja = torch.einsum("pij,j->pi", J, alpha)               # K_p alpha
    KiJa = torch.einsum("ij,pj->pi", inv_K, Ja)            # K^-1 K_p alpha
    W = torch.einsum("ij,pjk->pik", inv_K, J)              # K^-1 K_p

    term1 = 0.5 * torch.einsum("i,pqij,j->pq", alpha, H, alpha)
    cross = torch.einsum("pi,qi->pq", Ja, KiJa)
    term2 = -0.5 * (cross + cross.T)
    term3 = 0.5 * torch.einsum("qij,pji->pq", W, W)
    term4 = -0.5 * torch.einsum("ij,pqji->pq", inv_K, H)
    return term1 + term2 + term3 + term4


# n above which the Hessian assembly streams parameter pairs instead of
# materializing the (P+1, P+1, n, n) kernel-Hessian stack; the streamed
# form's peak is ~(2(P+1) + 3) n^2 (J + W + inv_K + one (n, n) pair slice).
_HESSIAN_CHUNK_N = 2048


def _hessian_from_pieces_chunked(kernel, alpha, inv_K, J, x):
    """Pair-at-a-time Hessian assembly — same math as
    ``_hessian_from_pieces`` with the (T, T, n, n) stack never built.

    Each kernel-parameter pair's (n, n) slice comes from
    ``kernel.hessian_pair`` (one plane of kernel B2b on the card) and is
    consumed at once into two scalars, so peak memory holds one pair.  The
    noise block is analytic (d2K/ds2 = 2 I, cross terms zero).
    """
    P = kernel.n_params
    T = P + 1
    Ja = torch.einsum("pij,j->pi", J, alpha)               # K_p alpha
    KiJa = torch.einsum("ij,pj->pi", inv_K, Ja)            # K^-1 K_p alpha
    cross = torch.einsum("pi,qi->pq", Ja, KiJa)
    term2 = -0.5 * (cross + cross.T)
    W = torch.einsum("ij,pjk->pik", inv_K, J)              # K^-1 K_p
    term3 = 0.5 * torch.einsum("qij,pji->pq", W, W)
    del W

    # term1 + term4, streamed per kernel-parameter pair (upper triangle)
    t14 = alpha.new_zeros((T, T))
    for p in range(P):
        for q in range(p, P):
            Hpq = kernel.hessian_pair(x, x, p, q)          # one (n, n) slice
            t = 0.5 * torch.dot(alpha, Hpq @ alpha) - 0.5 * torch.sum(inv_K * Hpq.T)
            t14[p, q] += t
            if q != p:
                t14[q, p] += t
    # noise-noise block: H[P, P] = 2 I -> t1 = ||alpha||^2, t4 = -tr(K^-1)
    t14[P, P] += torch.dot(alpha, alpha) - torch.trace(inv_K)
    return t14 + term2 + term3


def _hessian_dispatch(kernel, x, alpha, inv_K, J):
    if x.shape[0] >= _HESSIAN_CHUNK_N:
        return _hessian_from_pieces_chunked(kernel, alpha, inv_K, J, x)
    return _hessian_from_pieces(kernel, x, alpha, inv_K, J)


def log_marginal_value_and_grad(kernel: Kernel, x, y, noise, jitter=0.0):
    """Analytic (log p, d log p / d theta) with theta = (kernel params..., s).

    One Cholesky, one explicit K^-1 (for the trace terms), P+1 quadratic
    forms.
    """
    x, y, noise = _inputs(x, y, noise)
    alpha, lml, inv_K, J = _grad_pieces(kernel, x, y, noise, jitter)
    return lml, _grad_from_pieces(alpha, inv_K, J)


def log_marginal_value_and_grad_chains(kernel_template: Kernel, x, y, theta, jitter=0.0):
    """``log_marginal_value_and_grad`` for C parameter vectors at once.

    ``theta`` is (C, P + 1), each row (kernel params..., s) in
    ``kernel_template``'s order; returns lml (C,) and d lml / d theta
    (C, P + 1).  The chains share x and y.  On a card the C matrices K_c
    come from one launch of kernel B1 over the (C, P + 1) table [params,
    s^2 + jitter], their factors from the blocked factorization over B3 on
    (C, 128, 128) stacks; the solves are batched library calls.  For a leaf
    family the kernel-parameter terms 1/2 sum_ij dK_p (alpha alpha^T -
    K^-1)_ij come from B2a contracted (``jacobian_contract_chains``), the
    Jacobians never stored, and count C in ``core.grad_contracted``; a
    tree's Jacobians come from its leaves' B2a launches and are contracted
    by batched library calls.  The noise component uses dK/ds = 2 s I
    without building that plane: d lml / ds = s (alpha^T alpha - tr K^-1).
    A chain whose K is not positive definite gets NaN in its own outputs
    only.
    """
    x = torch.as_tensor(x)
    y = _like(y, x)
    theta = _like(theta, x)
    P = kernel_template.n_params
    if theta.ndim != 2 or theta.shape[1] != P + 1:
        raise ValueError(f"theta must be (C, {P + 1}), got {tuple(theta.shape)}")
    C, n = theta.shape[0], x.shape[0]
    params, s = theta[:, :P], theta[:, P]
    K = pairwise_matrix_chains(kernel_template, x, params, torch.square(s) + jitter)
    L = choose_cholesky(K)(K)
    del K
    v = torch.linalg.solve_triangular(L, y[None, :, None].expand(C, n, 1), upper=False)
    alpha = torch.linalg.solve_triangular(L.mT, v, upper=True)[..., 0]      # (C, n)
    logdet_half = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    lml = -0.5 * (alpha @ y) - logdet_half - 0.5 * n * _LOG_2PI
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    inv_L = torch.linalg.solve_triangular(L, eye.expand(C, n, n), upper=False)
    del L
    inv_K = inv_L.mT @ inv_L
    del inv_L
    if is_tree(kernel_template):
        J = pairwise_jacobian_chains(kernel_template, x, params)             # (C, P, n, n)
        quad = torch.einsum("ci,cpij,cj->cp", alpha, J, alpha)
        trace = torch.einsum("cij,cpji->cp", inv_K, J)
        g_k = 0.5 * (quad - trace)
    else:
        counts["core.grad_contracted"] += C
        g_k = jacobian_contract_chains(kernel_template, x, params, alpha, inv_K)
    g_s = s * (torch.sum(alpha * alpha, dim=-1) - torch.diagonal(inv_K, dim1=-2, dim2=-1).sum(-1))
    return lml, torch.cat([g_k, g_s[:, None]], dim=1)


def log_marginal_hessian(kernel: Kernel, x, y, noise, jitter=0.0):
    """Analytic d2 log p / d theta2, shape (P+1, P+1)."""
    x, y, noise = _inputs(x, y, noise)
    alpha, _, inv_K, J = _grad_pieces(kernel, x, y, noise, jitter)
    return _hessian_dispatch(kernel, x, alpha, inv_K, J)


def log_marginal_all(kernel: Kernel, x, y, noise, jitter=0.0):
    """(log p, grad, hessian) sharing a single Cholesky/inverse/Jacobian."""
    x, y, noise = _inputs(x, y, noise)
    alpha, lml, inv_K, J = _grad_pieces(kernel, x, y, noise, jitter)
    grad = _grad_from_pieces(alpha, inv_K, J)
    Hl = _hessian_dispatch(kernel, x, alpha, inv_K, J)
    return lml, grad, Hl


def likelihood_value_grad_hessian(kernel: Kernel, x, y, noise, jitter=0.0):
    """(lh, dlh/dtheta, d2lh/dtheta2) for the *non-log* marginal likelihood:
    lh = exp(loglh); dlh = lh * dloglh; d2lh = lh (dloglh dloglh^T + d2loglh).
    """
    lml, g, Hl = log_marginal_all(kernel, x, y, noise, jitter)
    lh = torch.exp(lml)
    return lh, lh * g, lh * (torch.outer(g, g) + Hl)
