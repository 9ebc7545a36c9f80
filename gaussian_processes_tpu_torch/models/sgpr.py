"""Sparse GP regression (SGPR): the Titsias collapsed variational bound.

Counterpart of ``gaussian_processes_tpu/models/sgpr.py``: scattered inputs
at N ~ 1e6 with m inducing points, no CG iterations.  Everything n-sized is
one blocked sweep; everything else is (m, m).

    ELBO = log N(y | 0, Q_ff + s^2 I) - 1/(2 s^2) tr(K_ff - Q_ff)
    Q_ff = K_fu Kuu^+ K_uf

The sweep (``_sweep``) builds K(z, x_j) for each row block of x with kernel
B1 on a card (B6 for ARD; no diagonal term) and accumulates C = K_uf K_fu
and b = K_uf y with ``torch.matmul`` (float32 at full precision, no TF32;
utils/device.py).  Kuu is whitened by a truncated pseudo-inverse
(``psd_pinv``, ``pinv_whitening``: eigenvalues below sqrt(eps) lam_max are
dropped, which only loosens the bound), and the fit's tail eigendecomposes
the whitened A A^T with its eigenvalues clamped at 0 and floored at
m eps lam_max.  The JAX module's docstring records why (float32 round-off
of C amplified by chol(Kuu)^-1).

Differentiability: ``elbo_sgpr`` is differentiable in the kernel's
parameters, the noise and z.  The gradient of K(z, x_j) is kernel B1's
autograd rule (B2a's planes for theta, the plain element's autograd for z;
``ops/pairwise.py``); ``psd_pinv`` carries the full Moore-Penrose
derivative, so autograd never reaches ``torch.linalg.eigh`` (whose rule
divides by eigenvalue gaps and gives NaN on the tied trailing spectrum),
and the bound is written in P = Kuu^+ through the push-through identities:

    logdet(I + AAT)     = logdet(I + C P / s^2)     (Sylvester)
    T^T (I + AAT)^-1 T  = (I + P C / s^2)^-1 P      (push-through)
    tr(AAT)             = tr(P C) / s^2

Autograd keeps each block's K(z, x_j) for the backward: m * n elements, 4
GiB at m = 1024 and n = 2^20 in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gaussian_processes_tpu_torch.models.gp import _LOG_2PI
from gaussian_processes_tpu_torch.ops import krylov


@dataclasses.dataclass(frozen=True)
class SGPRPosterior:
    """Collapsed SGPR posterior; everything predict and sample need is
    (m, m) or (m,).  ``T_uu`` is the truncated whitening map of Kuu (rows:
    eigenvectors over sqrt(lam), zero below the cutoff); ``V_B``, ``lam_B``
    eigendecompose the whitened A A^T (clamped and floored), so D^-1/2 V^T
    plays chol(I + AAT)^-1's role (D = 1 + lam)."""

    kernel: torch.nn.Module
    z: torch.Tensor  # (m,) or (m, D) inducing inputs
    T_uu: torch.Tensor  # (m, m)
    V_B: torch.Tensor  # (m, m)
    lam_B: torch.Tensor  # (m,)
    c: torch.Tensor  # (m,) D^-1/2 V^T T b / s^2
    noise: torch.Tensor
    log_marginal: torch.Tensor  # the ELBO (a lower bound on the exact lml)
    trace_gap: torch.Tensor  # tr(K_ff - Q_ff) >= 0


# ---------------------------------------------------------------------------
# Truncated PSD pseudo-inverse with a tie-safe gradient


def _eigh(A):
    """``torch.linalg.eigh``, or NaN where it cannot decompose A (a
    non-finite A, as a sampler's far proposal gives), as
    ``jnp.linalg.eigh`` returns NaN and the samplers reject the proposal."""
    if bool(torch.isfinite(A).all()):
        try:
            return torch.linalg.eigh(A)
        except torch.linalg.LinAlgError:
            pass
    nan = torch.full_like(A, float("nan"))
    return nan[:, 0], nan


def _eigh_cut(A, abs_tol, rank_tol):
    lam, U = _eigh(A)
    cut = torch.clamp(rank_tol * torch.clamp_min(lam[-1], 0.0), min=abs_tol)
    return lam, U, lam > cut


class _PsdPinv(torch.autograd.Function):
    """Forward: one eigh.  Backward: the Moore-Penrose derivative for a
    symmetric A at locally constant rank,

        A_bar = -P dP P + (I - A P) dP P^2 + P^2 dP (I - P A)

    symmetrized (the last two terms rotate the range; the rank boundary is
    measure zero and ignored)."""

    @staticmethod
    def forward(ctx, A, abs_tol, rank_tol):
        A = A.detach()
        lam, U, keep = _eigh_cut(A, float(abs_tol), rank_tol)
        inv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
        P = (U * inv[None, :]) @ U.T
        P = 0.5 * (P + P.T)
        ctx.save_for_backward(P, A)
        return P

    @staticmethod
    def backward(ctx, dP):
        P, A = ctx.saved_tensors
        P2 = P @ P
        proj_c = torch.eye(P.shape[0], dtype=P.dtype, device=P.device) - A @ P
        dA = -P @ (dP @ P) + proj_c @ (dP @ P2) + P2 @ (dP @ proj_c.T)
        return 0.5 * (dA + dA.T), None, None


def psd_pinv(A: torch.Tensor, abs_tol, rank_tol: float) -> torch.Tensor:
    """P = pseudo-inverse of symmetric PSD A, eigenvalues below
    max(rank_tol lam_max, abs_tol) dropped; differentiable in A (``abs_tol``
    gets no gradient)."""
    return _PsdPinv.apply(A, abs_tol, rank_tol)


def pinv_whitening(A: torch.Tensor, abs_tol, rank_tol: float) -> torch.Tensor:
    """T with T^T T = A^+ (truncated): eigenvectors over sqrt(lam) as rows,
    zero below the cutoff.  Not differentiable (``fit_sgpr``'s outputs are
    used, not differentiated)."""
    lam, U, keep = _eigh_cut(A.detach(), float(abs_tol), rank_tol)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, lam, 1.0)), 0.0)
    return inv_sqrt[:, None] * U.T


def _default_rank_tol(dtype) -> float:
    """sqrt(eps): whitening by a direction at relative eigenvalue lam_rel
    amplifies C's relative round-off by ~1 / lam_rel, so keeping lam_rel >=
    sqrt(eps) caps it at ~sqrt(eps) (the JAX package's measured stability
    boundary)."""
    return math.sqrt(torch.finfo(dtype).eps)


# ---------------------------------------------------------------------------
# The blocked O(n m^2) sweep


def _sweep(kernel, x, y, z, block_size: int):
    """C = K_uf K_fu (m, m), b = K_uf y (m,), ||y||^2 and tr(K_ff) over row
    blocks of x: peak memory O(m * block) without autograd.  A ragged last
    block takes the place of the JAX package's masked padding."""
    m = z.shape[0]
    C = y.new_zeros((m, m))
    bv = y.new_zeros((m,))
    yty = y.new_zeros(())
    trk = y.new_zeros(())
    for j in range(0, y.shape[0], block_size):
        xj, yj = x[j:j + block_size], y[j:j + block_size]
        Kj = kernel(z, xj)  # (m, b): kernel B1 (B6 for ARD) on a card
        C = torch.addmm(C, Kj, Kj.T)
        bv = bv + Kj @ yj
        yty = yty + torch.dot(yj, yj)
        trk = trk + torch.sum(kernel.kdiag(xj).to(y.dtype))
    return C, bv, yty, trk


def _moments(kernel, x, y, noise, z, block_size, jitter):
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    z = torch.as_tensor(z, device=x.device)
    noise = torch.as_tensor(noise, dtype=y.dtype, device=x.device)
    m = z.shape[0]
    Kuu = kernel(z, z) + jitter * torch.eye(m, dtype=y.dtype, device=x.device)
    C, bv, yty, trk = _sweep(kernel, x, y, z, block_size)
    return Kuu, C, bv, yty, trk, torch.square(noise)


# ---------------------------------------------------------------------------
# Fit / bound


def fit_sgpr(
    kernel,
    x,
    y,
    noise,
    z,
    *,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
) -> SGPRPosterior:
    """Fit the collapsed SGPR posterior: O(n m^2) flops in one sweep,
    O(m^2 + block * m) memory.  ``jitter`` defaults to 0: the
    pseudo-inverse truncation (``rank_tol``, default sqrt(eps)) takes its
    regularizing role."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    z = torch.as_tensor(z, device=x.device)
    Kuu, C, bv, yty, trk, s2 = _moments(kernel, x, y, noise, z, block_size, jitter)
    if rank_tol is None:
        rank_tol = _default_rank_tol(y.dtype)
    return _fit_from_moments(kernel, z, noise, y.shape[0], Kuu, C, bv, yty, trk, s2, rank_tol)


def _fit_from_moments(kernel, z, noise, n, Kuu, C, bv, yty, trk, s2, rank_tol) -> SGPRPosterior:
    """The posterior from the moments: everything here is (m, m)."""
    m = z.shape[0]
    T = pinv_whitening(Kuu, 0.0, rank_tol)
    AAT = T @ (C @ T.T) / s2
    AAT = 0.5 * (AAT + AAT.T)
    lam, V = _eigh(AAT)
    # clamp + floor: eigenvalues at the round-off scale of forming AAT are
    # noise, not signal
    floor = m * torch.finfo(C.dtype).eps * torch.clamp_min(lam[-1], 0.0)
    lam = torch.where(lam > floor, lam, 0.0)
    w = T @ bv
    c = (V.T @ w) / torch.sqrt(1.0 + lam) / s2
    trace_gap = torch.clamp_min(trk - s2 * torch.sum(lam), 0.0)
    elbo = (-0.5 * n * _LOG_2PI - 0.5 * torch.sum(torch.log1p(lam)) - 0.5 * n * torch.log(s2)
            - 0.5 * yty / s2 + 0.5 * torch.dot(c, c) - 0.5 * trace_gap / s2)
    return SGPRPosterior(kernel=kernel, z=z, T_uu=T, V_B=V, lam_B=lam, c=c,
                         noise=torch.as_tensor(noise, dtype=C.dtype, device=C.device),
                         log_marginal=elbo, trace_gap=trace_gap)


def elbo_sgpr(
    kernel,
    x,
    y,
    noise,
    z,
    *,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
) -> torch.Tensor:
    """The collapsed bound alone: the differentiable objective of type-II
    MLE (``fit_mle(objective="sgpr")``, ``fit_sgpr_mle``) and of the
    samplers (``make_log_posterior_sgpr``), in kernel parameters, noise and
    z.  The only eigendecomposition is inside ``psd_pinv``; the bound is
    slogdet and solve over the push-through forms, and equals
    ``fit_sgpr(...).log_marginal`` to round-off."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    Kuu, C, bv, yty, trk, s2 = _moments(kernel, x, y, noise, z, block_size, jitter)
    if rank_tol is None:
        rank_tol = _default_rank_tol(y.dtype)
    return _elbo_from_moments(y.shape[0], Kuu, C, bv, yty, trk, s2, rank_tol)


def _elbo_from_moments(n, Kuu, C, bv, yty, trk, s2, rank_tol) -> torch.Tensor:
    m = Kuu.shape[0]
    P = psd_pinv(Kuu, 0.0, rank_tol)
    PC = P @ C / s2
    B = torch.eye(m, dtype=C.dtype, device=C.device) + PC
    _, logdetB = torch.linalg.slogdet(B)
    # solve_ex: a singular B (a sampler's far proposal) gives inf / NaN, as
    # jnp.linalg.solve does, and the sampler rejects it
    quad = torch.dot(bv, torch.linalg.solve_ex(B, P @ bv)[0]) / torch.square(s2)
    trace_gap = torch.clamp_min(trk - s2 * torch.trace(PC), 0.0)
    return (-0.5 * n * _LOG_2PI - 0.5 * logdetB - 0.5 * n * torch.log(s2) - 0.5 * yty / s2
            + 0.5 * quad - 0.5 * trace_gap / s2)


# ---------------------------------------------------------------------------
# Prediction / sampling


def _tmp12(post: SGPRPosterior, xo):
    Kus = post.kernel(post.z, xo)  # (m, q)
    t1 = post.T_uu @ Kus
    t2 = (post.V_B.T @ t1) / torch.sqrt(1.0 + post.lam_B)[:, None]
    return t1, t2


def predict_sgpr(post: SGPRPosterior, xo):
    """Predictive mean (q,) and latent variance (q,) (add s^2 for y-space):
    mean = t2^T c, var = kdiag - sum t1^2 + sum t2^2 with t1 = T Kus,
    t2 = D^-1/2 V^T t1."""
    xo = torch.as_tensor(xo, device=post.z.device)
    t1, t2 = _tmp12(post, xo)
    mean = t2.T @ post.c
    var = (post.kernel.kdiag(xo).to(mean.dtype) - torch.sum(torch.square(t1), dim=0)
           + torch.sum(torch.square(t2), dim=0))
    return mean, var


def predict_sgpr_cov(post: SGPRPosterior, xo):
    """Predictive mean and full latent covariance Kss - t1^T t1 + t2^T t2."""
    xo = torch.as_tensor(xo, device=post.z.device)
    t1, t2 = _tmp12(post, xo)
    return t2.T @ post.c, post.kernel(xo, xo) - t1.T @ t1 + t2.T @ t2


def sample_sgpr_posterior(post: SGPRPosterior, xo, generator=None, n_samples: int = 1,
                          jitter: float = 1e-8):
    """Joint posterior draws (n_samples, q) through the full (q, q)
    predictive covariance (pathwise sampling serves large query sets)."""
    mean, cov = predict_sgpr_cov(post, xo)
    q = mean.shape[0]
    Lc = torch.linalg.cholesky(cov + jitter * torch.eye(q, dtype=cov.dtype, device=cov.device))
    zn = krylov.as_draws(generator).normal((q, n_samples), mean.dtype, mean.device)
    return (mean[:, None] + Lc @ zn).T


# ---------------------------------------------------------------------------
# Inducing-point selection


def inducing_subset(generator, x, m: int) -> torch.Tensor:
    """m training inputs drawn without replacement."""
    x = torch.as_tensor(x)
    return x[krylov.as_draws(generator).choice(x.shape[0], m, x.device)]


def inducing_grid(x, m: int) -> torch.Tensor:
    """1-D only: m evenly spaced points spanning the data range."""
    x = torch.as_tensor(x)
    if x.ndim != 1:
        raise ValueError("inducing_grid is 1-D; use kmeans_inducing for D>1")
    return torch.linspace(float(x.min()), float(x.max()), m, dtype=x.dtype, device=x.device)


def kmeans_inducing(generator, x, m: int, *, iters: int = 10, block_size: int = 8192):
    """Lloyd k-means centers as inducing points: a fixed iteration count,
    blocked O(n m) assignment sweeps (no (n, m) distance matrix beyond one
    block), sums by one-hot products (deterministic on a card, as the JAX
    package's).  Empty clusters keep their center."""
    x = torch.as_tensor(x)
    x2 = x[:, None] if x.ndim == 1 else x
    n, D = x2.shape
    z = inducing_subset(generator, x2, m)
    ids = torch.arange(m, device=x.device)
    for _ in range(iters):
        sums = x2.new_zeros((m, D))
        counts = x2.new_zeros((m,))
        zz = torch.sum(torch.square(z), dim=1)
        for j in range(0, n, block_size):
            xj = x2[j:j + block_size]
            d = torch.sum(torch.square(xj), dim=1)[:, None] - 2.0 * (xj @ z.T) + zz[None, :]
            onehot = (torch.argmin(d, dim=1)[:, None] == ids[None, :]).to(x2.dtype)
            sums = torch.addmm(sums, onehot.T, xj)
            counts = counts + torch.sum(onehot, dim=0)
        z = torch.where((counts > 0)[:, None], sums / torch.clamp_min(counts, 1.0)[:, None], z)
    return z[:, 0] if x.ndim == 1 else z


def select_inducing(generator, x, m: int, method: str = "kmeans"):
    """Dispatch: 'subset' | 'grid' (1-D) | 'kmeans'."""
    if method == "subset":
        return inducing_subset(generator, x, m)
    if method == "grid":
        return inducing_grid(x, m)
    if method == "kmeans":
        return kmeans_inducing(generator, x, m)
    raise ValueError(f"unknown inducing method: {method!r}")


# ---------------------------------------------------------------------------
# Hyperparameter learning and sampling on the bound


def _elbo_value_and_grad(kernel_template, x, y, z, u, opts, learn_inducing=False,
                         prior=None, bound=None):
    """(bound + log prior, gradient) at u = (log theta, log s[, z]) by
    autograd: kernel B1's rule (B6's for ARD) through the sweep and
    ``psd_pinv``'s through the tail.  ``bound`` replaces ``elbo_sgpr`` (the
    row-sharded bound of ``parallel/sgpr_sharded.py``)."""
    from gaussian_processes_tpu_torch.inference import gp_model

    P = kernel_template.n_params
    with torch.enable_grad():
        u = u.detach().requires_grad_()
        kernel, noise = gp_model.unpack(kernel_template, u[:P + 1])
        zz = u[P + 1:].reshape(z.shape) if learn_inducing else z
        value = (bound or elbo_sgpr)(kernel, x, y, noise, zz, **opts)
        if prior is not None:
            mu, sd = prior
            value = value - 0.5 * torch.sum(torch.square((u - mu) / sd))
        (grad,) = torch.autograd.grad(value, u)
    return value.detach(), grad


def fit_sgpr_mle(
    kernel_template,
    x,
    y,
    noise_init,
    z0,
    *,
    learn_inducing: bool = False,
    num_steps: int = 200,
    learning_rate: float = 0.05,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
):
    """Type-II MLE on the collapsed bound with Adam over u = (log kernel
    params, log noise[, z flattened]); with ``learn_inducing`` the inducing
    locations are free variational parameters.  Returns (SGPRPosterior at
    the best iterate, losses)."""
    from gaussian_processes_tpu_torch.inference import gp_model
    from gaussian_processes_tpu_torch.inference.mle import _run_opt

    x = torch.as_tensor(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    z0 = torch.as_tensor(z0, dtype=x.dtype, device=x.device)
    P = kernel_template.n_params
    u0 = gp_model.pack(kernel_template, noise_init).to(dtype=x.dtype, device=x.device)
    if learn_inducing:
        u0 = torch.cat([u0, z0.reshape(-1)])
    opts = dict(block_size=block_size, jitter=jitter, rank_tol=rank_tol)

    def loss_and_grad(u):
        value, grad = _elbo_value_and_grad(kernel_template, x, y, z0, u, opts, learn_inducing)
        return -value, -grad

    best_u, _, losses = _run_opt(loss_and_grad, u0, "adam", learning_rate, num_steps)
    kernel, noise = gp_model.unpack(kernel_template, best_u[:P + 1])
    z = best_u[P + 1:].reshape(z0.shape) if learn_inducing else z0
    return fit_sgpr(kernel, x, y, noise, z, **opts), losses


def log_density_sgpr(kernel_template, x, y, z, *, prior=None, block_size: int = 8192,
                     jitter: float = 0.0, rank_tol: float | None = None):
    """The bound (plus the Normal log prior ``prior`` = (mean, sd) on u) as
    an ``inference.gp_model.LogDensity`` over u = log(theta, s): (D,) or a
    (C, D) stack, whose chains run one after another, each with its own
    sweep."""
    from gaussian_processes_tpu_torch.inference import gp_model

    x = torch.as_tensor(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    z = torch.as_tensor(z, dtype=x.dtype, device=x.device)
    if prior is not None:
        prior = tuple(torch.as_tensor(p, dtype=x.dtype, device=x.device) for p in prior)
    opts = dict(block_size=block_size, jitter=jitter, rank_tol=rank_tol)

    def value_and_grad_chains(U):
        pairs = [_elbo_value_and_grad(kernel_template, x, y, z, u, opts, prior=prior)
                 for u in U]
        return torch.stack([v for v, _ in pairs]), torch.stack([g for _, g in pairs])

    return gp_model.LogDensity(value_and_grad_chains)


def make_log_posterior_sgpr(
    kernel_template,
    x,
    y,
    z,
    *,
    prior_mean=0.0,
    prior_std=2.0,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
):
    """Unnormalized log posterior over u = log(theta, s) with the SGPR bound
    as the likelihood surrogate, for NUTS and ChEES at scattered large n.
    The bound is deterministic and its gradient exact (no probes, no eigh
    autograd), so the samplers' energy errors are honest.  A ``LogDensity``:
    u of shape (D,) or (C, D)."""
    return log_density_sgpr(kernel_template, x, y, z, prior=(prior_mean, prior_std),
                            block_size=block_size, jitter=jitter, rank_tol=rank_tol)
