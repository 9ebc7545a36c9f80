"""Matrix-free exact-GP inference: CG solves + SLQ log marginal.

Counterpart of ``gaussian_processes_tpu/models/iterative_gp.py``.  Nothing
here stores an N x N array: every product with K is a kernel matvec
(``ops/krylov.py``; kernel B4 on a CUDA card), every product with dK/dtheta
a Jacobian product (kernel B5 on a card), so memory is O(N * max(block,
precond_rank)).

    fit_iterative(kernel, x, y, noise) -> IterativePosterior
        alpha = K^-1 y          by batched CG
        log_marginal            = -1/2 y^T alpha - 1/2 SLQ-logdet - n/2 log 2pi
    predict_mean / predict_diag  by more matvecs and CG solves

Accuracy model: alpha and the mean converge to the CG tolerance; the SLQ
logdet is a stochastic estimate with O(1/sqrt(num_probes)) Monte-Carlo
error.  Gradients of the log marginal likelihood use the stochastic trace
identity tr(K^-1 dK) ~ mean_z[(K^-1 z)^T dK z] with the same probes.

Random draws take a ``generator`` (a ``torch.Generator``, or any source of
draws that ``ops.krylov.as_draws`` accepts) where the JAX package takes a
key; the draws come in the JAX package's order.

``structure`` selects the operator: ``"none"`` (kernel matvecs),
``"toeplitz"`` (uniform 1-D grid, ``ops/toeplitz.py``: FFT matvecs and the
Strang circulant preconditioner), a ``kronecker.KronOperator`` (Cartesian
grid, ARD kernel), a ``ski.SKIOperator`` or ``ski.SKIKronOperator``
(scattered inputs through an inducing grid, the SKI surrogate W K_g W^T).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gaussian_processes_tpu_torch.models.gp import _LOG_2PI, _inputs, _like
from gaussian_processes_tpu_torch.ops import kronecker, krylov, pairwise, ski, toeplitz


@dataclasses.dataclass(frozen=True)
class IterativePosterior:
    kernel: torch.nn.Module
    x: torch.Tensor
    y: torch.Tensor
    noise: torch.Tensor
    alpha: torch.Tensor  # K^-1 y by CG
    log_marginal: torch.Tensor  # SLQ estimate
    solve_residual: torch.Tensor  # final relative CG residual of the y solve
    num_probes: int
    num_iters: int


class _Operator(NamedTuple):
    """One structure's products at one (kernel, noise), each grid column
    built once: ``matvec`` v -> (K + (s^2 + jitter) I) v; ``circulant``
    None, or a function giving the grid's free circulant preconditioner
    and its SLQ terms function; ``jacvec`` U -> (P, n, r) dK/dtheta_p U."""

    matvec: Callable
    circulant: Optional[Callable]
    jacvec: Callable


def _shift(noise, jitter):
    return torch.square(noise) + jitter


def _operator(kernel, x, noise, jitter, block_size, structure="none",
              impl="auto") -> _Operator:
    shift = _shift(noise, jitter)
    if isinstance(structure, ski.SKIKronOperator):
        # scattered (n, D) inputs through a Kronecker inducing grid:
        # W ((x)_d T_d) W^T + s^2 I; dK_ski/dtheta_p = W ((x)_d T_{J_p,d}) W^T
        cols = kronecker.kron_columns(kernel, structure.kron)

        def jacvec(U):
            WtU = ski.interp_rmatvec_nd(structure, U)
            return torch.stack([ski.interp_matvec_nd(structure, kronecker.kron_matvec(c, WtU))
                                for c in kronecker.kron_jacobian_columns(kernel, structure.kron)])

        return _Operator(lambda v: ski.ski_kron_matvec(structure, cols, v, shift), None, jacvec)
    if isinstance(structure, kronecker.KronOperator):
        # D-dim Cartesian grid, separable kernel: D batched FFT sweeps; each
        # dK/dtheta_p is Kronecker too
        cols = kronecker.kron_columns(kernel, structure)

        def circulant():
            return (kronecker.kron_circulant_precond(cols, shift),
                    lambda mv, draws, r, it: kronecker.slq_terms_kron_circulant(
                        mv, cols, shift, draws, r, it))

        return _Operator(lambda v: kronecker.kron_matvec(cols, v, shift), circulant,
                         lambda U: torch.stack([kronecker.kron_matvec(c, U) for c in
                                                kronecker.kron_jacobian_columns(kernel, structure)]))
    if isinstance(structure, ski.SKIOperator):
        # scattered inputs through an inducing grid: O(n) gather/scatter +
        # O(m log m) FFT; the grid's column is one (m, 1) K build, and with
        # W theta-independent dK_ski/dtheta_p = W T_{J_p} W^T
        col = toeplitz.toeplitz_column(kernel, structure.grid)

        def jacvec(U):
            WtU = ski.interp_rmatvec(structure, U)
            return torch.stack([ski.interp_matvec(structure, toeplitz.toeplitz_matvec(c, WtU))
                                for c in toeplitz.jacobian_columns(kernel, structure.grid)])

        return _Operator(lambda v: ski.ski_matvec(structure, col, v, shift), None, jacvec)
    if isinstance(structure, str) and structure == "toeplitz":
        # uniform-grid inputs (the caller asserts toeplitz.is_uniform_grid):
        # K is symmetric Toeplitz, an O(n log n) FFT product, and the Strang
        # preconditioner comes from the same column
        col = toeplitz.toeplitz_column(kernel, x)

        def circulant():
            return (toeplitz.strang_circulant_precond(col, shift),
                    lambda mv, draws, r, it: toeplitz.slq_terms_circulant(mv, col, shift, draws,
                                                                          r, it))

        return _Operator(lambda v: toeplitz.toeplitz_matvec(col, v, shift), circulant,
                         lambda U: torch.stack([toeplitz.toeplitz_matvec(c, U)
                                                for c in toeplitz.jacobian_columns(kernel, x)]))
    if not (isinstance(structure, str) and structure == "none"):
        raise ValueError(f"unknown structure: {structure!r}")

    def jacvec(U):
        if x.device.type == "cuda" and pairwise.supports_fused_jacvec(kernel, x):
            # kernel B5: each dK/dtheta_p tile is built on chip and contracted
            # with U; the (P, n, b) Jacobian strips never exist
            return pairwise.kernel_jacvec_fused(kernel, x, U)
        JU = U.new_zeros((kernel.n_params, *U.shape))
        for j in range(0, x.shape[0], block_size):
            JU = JU + kernel.jacobian(x, x[j:j + block_size]) @ U[j:j + block_size]
        return JU

    return _Operator(
        lambda v: krylov.kernel_matvec(kernel, x, v, noise, jitter, block_size=block_size,
                                       impl=impl),
        None, jacvec)


def fit_iterative(
    kernel,
    x,
    y,
    noise,
    generator=None,
    *,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    structure: str = "none",
    replace_every: int = 25,
    precond_L: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> IterativePosterior:
    """Matrix-free exact-GP fit; memory O(n * max(block_size, precond_rank)).

    ``precond_rank > 0`` solves alpha with pivoted-Cholesky-preconditioned CG
    (with residual replacement every ``replace_every`` iterations) and
    estimates the logdet by preconditioned SLQ; ``precond_L`` supplies the
    factor instead.  Otherwise, on a grid (``structure="toeplitz"`` or a
    ``KronOperator``), the free circulant preconditioner takes its place,
    with the circulant-preconditioned SLQ logdet (exact logdet(P)); and
    elsewhere one batched CG solves [y, Rademacher probes] and its
    coefficients give the plain SLQ logdet.  With a SKI operator the target
    is the SKI surrogate K_ski = W K_g W^T.  ``impl`` picks the kernel
    matvec of ``structure="none"`` (``krylov.kernel_matvec``: ``"auto"``,
    ``"fused"`` or ``"strip"``, the row-sharded fit's product at W = 1).
    """
    x, y, noise = _inputs(x, y, noise)
    draws = krylov.as_draws(generator)
    n = x.shape[0]
    dtype = y.dtype

    op = _operator(kernel, x, noise, jitter, block_size, structure, impl)
    mv = op.matvec
    if precond_rank > 0:
        L = (precond_L if precond_L is not None
             else krylov.pivoted_cholesky(kernel, x, precond_rank))
        sigma2 = torch.square(noise) + jitter
        pre = krylov.woodbury_inverse_apply(L, sigma2)
        alpha2, rn = krylov.pcg(mv, pre, y[:, None], num_iters=num_iters, tol=tol,
                                replace_every=replace_every)
        alpha = alpha2[:, 0]
        solve_residual = rn[0]
        logdet = krylov.slq_logdet_preconditioned(mv, L, sigma2, draws, num_probes,
                                                  num_iters, n)
    elif op.circulant is not None:
        pre, slq_terms = op.circulant()
        sol, rn = krylov.pcg(mv, pre, y[:, None], num_iters=num_iters, tol=tol,
                             replace_every=replace_every)
        alpha = sol[:, 0]
        solve_residual = rn[0]
        logdet_p, terms = slq_terms(mv, draws, num_probes, num_iters)
        logdet = logdet_p + torch.mean(terms)
    else:
        probes = draws.rademacher((n, num_probes), dtype, x.device)
        rhs = torch.cat([y[:, None], probes], dim=1)
        res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol)
        alpha = res.solution[:, 0]
        solve_residual = res.residual_norm[0]
        probe_norms = torch.full((num_probes,), float(n), dtype=dtype, device=x.device)
        logdet = krylov.slq_logdet_from_cg(res.alphas[:, 1:], res.betas[:, 1:],
                                           probe_norms, n)
    lml = -0.5 * torch.dot(y, alpha) - 0.5 * logdet - 0.5 * n * _LOG_2PI
    return IterativePosterior(
        kernel=kernel, x=x, y=y, noise=noise, alpha=alpha, log_marginal=lml,
        solve_residual=solve_residual, num_probes=num_probes, num_iters=num_iters,
    )


def predict_mean_iterative(post: IterativePosterior, xo, block_size: int = 1024,
                           structure="none") -> torch.Tensor:
    """Predictive mean K(xo, x) @ alpha, built in blocks of test points:
    O(n m) flops, O(b n) memory.  With a SKI ``structure`` (1-D or D-dim):
    the KISS-GP prediction K(xo, x) ~= W_o K_g W^T, one grid projection
    T_g (W^T alpha) interpolated to the test points."""
    xo = _like(xo, post.x)
    if isinstance(structure, ski.SKIOperator):
        col = toeplitz.toeplitz_column(post.kernel, structure.grid)
        grid_mean = toeplitz.toeplitz_matvec(col, ski.interp_rmatvec(structure, post.alpha))
        return ski.interp_matvec(ski.interpolation_weights(xo, structure.grid), grid_mean)
    if isinstance(structure, ski.SKIKronOperator):
        cols = kronecker.kron_columns(post.kernel, structure.kron)
        grid_mean = kronecker.kron_matvec(cols, ski.interp_rmatvec_nd(structure, post.alpha))
        op_o = ski.interpolation_weights_nd(xo, structure.kron.axes)
        return ski.interp_matvec_nd(op_o, grid_mean)
    chunks = [post.kernel(xo[i:i + block_size], post.x) @ post.alpha
              for i in range(0, xo.shape[0], block_size)]
    return torch.cat(chunks) if chunks else post.alpha.new_zeros((0,))


def predict_diag_iterative(
    post: IterativePosterior,
    xo,
    *,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    structure: str = "none",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and per-point variance; one CG solve for the whole test batch.

    var_i = k(xo_i, xo_i) - k_i^T K^-1 k_i with the m cross-covariance
    columns solved together by (optionally preconditioned) batched CG, a
    matvec with r = m right-hand sides per iteration (memory O(n m)).  On a
    grid structure the solves take its circulant preconditioner.
    """
    xo = _like(xo, post.x)
    Kxxo = post.kernel(post.x, xo)  # (n, m)
    op = _operator(post.kernel, post.x, post.noise, jitter, block_size, structure)
    mv = op.matvec
    if precond_rank > 0:
        L = krylov.pivoted_cholesky(post.kernel, post.x, precond_rank)
        pre = krylov.woodbury_inverse_apply(L, torch.square(post.noise) + jitter)
        sol, _ = krylov.pcg(mv, pre, Kxxo, num_iters=num_iters, tol=tol)
    elif op.circulant is not None:
        pre, _ = op.circulant()
        sol, _ = krylov.pcg(mv, pre, Kxxo, num_iters=num_iters, tol=tol)
    else:
        sol = krylov.mbcg(mv, Kxxo, num_iters=num_iters, tol=tol).solution
    mean = Kxxo.T @ post.alpha
    var = post.kernel.kdiag(xo) - torch.sum(Kxxo * sol, dim=0)
    return mean, var


def fit_mle_iterative(
    kernel,
    x,
    y,
    noise_init,
    generator=None,
    *,
    num_steps: int = 50,
    learning_rate: float = 0.05,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    structure: str = "none",
):
    """Type-II MLE at matrix-free scale: Adam (``torch.optim.Adam``, the
    defaults of ``optax.adam``) on u = log(theta, s), with the stochastic
    (value, grad) pairs of ``log_marginal_value_and_grad_iterative``.

    Fresh probes each step act as minibatch noise.  Returns (kernel, noise,
    last_lml_estimate, lml_trace); the trace reads one value per step back
    to the host.
    """
    x, y, noise_init = _inputs(x, y, noise_init)
    draws = krylov.as_draws(generator)
    P = kernel.n_params
    params = kernel.params.to(device=y.device, dtype=y.dtype)
    u = torch.log(torch.cat([params, noise_init.reshape(1)])).requires_grad_()
    opt = torch.optim.Adam([u], lr=learning_rate)
    lmls = []
    for _ in range(num_steps):
        theta = torch.exp(u.detach())
        lml, g_theta = log_marginal_value_and_grad_iterative(
            kernel.with_params(theta[:P]), x, y, theta[P], draws,
            num_probes=num_probes, num_iters=num_iters, tol=tol, jitter=jitter,
            block_size=block_size, structure=structure,
        )
        u.grad = -g_theta * theta  # d(-lml)/du through exp
        opt.step()
        lmls.append(float(lml))
    theta = torch.exp(u.detach())
    return kernel.with_params(theta[:P]), theta[P], lmls[-1], lmls


class IterativeEstimate(NamedTuple):
    """``log_marginal_value_and_grad_iterative``'s estimate with its
    per-probe terms, from which a caller computes standard errors."""

    lml: torch.Tensor
    grad: torch.Tensor  # (P + 1,)
    logdet_terms: torch.Tensor  # (r,): the SLQ logdet is a constant + their mean
    trace_terms: torch.Tensor  # (P + 1, r): grad = 1/2 (quad - their mean)


def log_marginal_value_and_grad_iterative(
    kernel,
    x,
    y,
    noise,
    generator=None,
    *,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    early_exit: bool = False,
    structure: str = "none",
):
    """(lml_estimate, d lml / d theta) matrix-free, theta = (kernel..., s).

    grad_p = 1/2 alpha^T K_p alpha - 1/2 E_z[(K^-1 z)^T K_p z], with the
    Hutchinson expectation over the same Rademacher probes as the logdet and
    K_p U from kernel B5 on a card (Jacobian strips elsewhere).  With
    ``precond_rank > 0`` all solves run preconditioned CG and the logdet is
    the preconditioned-SLQ estimate.
    """
    est = log_marginal_estimate_iterative(
        kernel, x, y, noise, generator, num_probes=num_probes, num_iters=num_iters,
        tol=tol, jitter=jitter, block_size=block_size, precond_rank=precond_rank,
        early_exit=early_exit, structure=structure,
    )
    return est.lml, est.grad


def log_marginal_estimate_iterative(
    kernel,
    x,
    y,
    noise,
    generator=None,
    *,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    early_exit: bool = False,
    structure: str = "none",
) -> IterativeEstimate:
    """``log_marginal_value_and_grad_iterative`` with its per-probe terms."""
    x, y, noise = _inputs(x, y, noise)
    draws = krylov.as_draws(generator)
    n = x.shape[0]
    dtype = y.dtype

    probes = draws.rademacher((n, num_probes), dtype, x.device)
    rhs = torch.cat([y[:, None], probes], dim=1)
    op = _operator(kernel, x, noise, jitter, block_size, structure)
    mv = op.matvec
    if precond_rank > 0:
        L = krylov.pivoted_cholesky(kernel, x, precond_rank)
        sigma2 = torch.square(noise) + jitter
        pre = krylov.woodbury_inverse_apply(L, sigma2)
        sol, _ = krylov.pcg(mv, pre, rhs, num_iters=num_iters, tol=tol,
                            early_exit=early_exit)
        logdet_terms = krylov.slq_terms_preconditioned(mv, L, sigma2, draws,
                                                       num_probes, num_iters)
        logdet = krylov.precond_logdet(L, sigma2, n) + torch.mean(logdet_terms)
    elif op.circulant is not None:
        # circulant-preconditioned solves and SLQ; the Hutchinson probes stay
        # Rademacher (the trace identity needs only E[z z^T] = I)
        pre, slq_terms = op.circulant()
        sol, _ = krylov.pcg(mv, pre, rhs, num_iters=num_iters, tol=tol,
                            early_exit=early_exit)
        logdet_p, logdet_terms = slq_terms(mv, draws, num_probes, num_iters)
        logdet = logdet_p + torch.mean(logdet_terms)
    else:
        res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol)
        sol = res.solution
        logdet_terms = float(n) * krylov.slq_quadratures_from_cg(
            res.alphas[:, 1:], res.betas[:, 1:])
        logdet = torch.mean(logdet_terms)
    alpha = sol[:, 0]
    Kinv_z = sol[:, 1:]  # (n, r)
    lml = -0.5 * torch.dot(y, alpha) - 0.5 * logdet - 0.5 * n * _LOG_2PI

    U = torch.cat([alpha[:, None], probes], dim=1)  # (n, r + 1)
    JU = op.jacvec(U)  # (P, n, r + 1)
    quad = torch.einsum("n,pn->p", alpha, JU[:, :, 0])
    trace_kernel = torch.einsum("nr,pnr->pr", Kinv_z, JU[:, :, 1:])  # (P, r)

    # noise component: dK/ds = 2 s I
    two_s = 2.0 * noise
    quad_s = two_s * torch.dot(alpha, alpha)
    trace_s = two_s * torch.sum(Kinv_z * probes, dim=0)  # (r,)
    trace_terms = torch.cat([trace_kernel, trace_s[None]])
    grad = 0.5 * (torch.cat([quad, quad_s[None]]) - torch.mean(trace_terms, dim=-1))
    return IterativeEstimate(lml=lml, grad=grad, logdet_terms=logdet_terms,
                             trace_terms=trace_terms)
