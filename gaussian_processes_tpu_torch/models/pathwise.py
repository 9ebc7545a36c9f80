"""Pathwise posterior sampling: Matheron's rule + spectral prior features.

Counterpart of ``gaussian_processes_tpu/models/pathwise.py``.  A posterior
function draw is a prior draw corrected by one solve (Wilson et al. 2020,
"efficiently sampling functions from GPs"):

    f_post(.) = f_prior(.) + K(., x) (K + s^2 I)^-1 (y - f_prior(x) - eps)

with f_prior from random Fourier features (Bochner's theorem: every
stationary kernel here is a frequency law) and eps ~ N(0, s^2 I).  The solve
reuses the dense posterior's factor (``sample_posterior_pathwise``) or the
matrix-free CG stack (``sample_posterior_pathwise_iterative``: kernel B4's
matvecs on a card, FFT products on a grid, SKI products); the update term
is a strip product K(xo, x) V, kernel B1's strips contracted with
``torch.matmul``.

Frequency laws (``_spectral_sample``): SE omega ~ N(0, 1/w^2); Matérn
omega ~ t_{2 nu} / w (z / sqrt(g / df), g chi-square); RQ omega ~ N(0,
lam / w^2), lam ~ Gamma(a, rate a); periodic: atoms at q / p with weights
e^-c I_q(c), c = 1 / w^2 (a standalone periodic kernel gets the exact
truncated harmonic map instead); Sum: the mixture of its children's laws
weighted by k(0); Product: omega_1 + omega_2; ARD: N(0, diag(1 / w_d^2)).

Random numbers come from one ``ops.krylov.Draws`` (``as_draws`` of a
``torch.Generator``), drawn in the order the JAX functions consume their
split keys, so a test can hand the port the JAX package's own variates.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gaussian_processes_tpu_torch.models.ard import ARDGaussianKernel
from gaussian_processes_tpu_torch.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu_torch.models.gaussian import GaussianKernel
from gaussian_processes_tpu_torch.models.matern import Matern32Kernel, Matern52Kernel
from gaussian_processes_tpu_torch.models.periodic import PeriodicKernel
from gaussian_processes_tpu_torch.models.rq import RationalQuadraticKernel
from gaussian_processes_tpu_torch.ops import krylov
from gaussian_processes_tpu_torch.ops.toeplitz import _log_bessel_i


@dataclasses.dataclass(frozen=True)
class FourierFeatures:
    """phi_f(t) = scale_f cos(<t, omega_f> + phase_f), f = 1..F.

    ``omega`` is (F,) for scalar inputs or (F, D) for (m, D) inputs.
    E[phi(t) phi(t')^T] ~= k(t, t'); a prior function draw is phi(t) @ u
    with u ~ N(0, I_F)."""

    omega: torch.Tensor
    phase: torch.Tensor
    scale: torch.Tensor

    @property
    def num_features(self) -> int:
        return self.omega.shape[0]

    def __call__(self, t) -> torch.Tensor:
        """Feature matrix (m, F) for inputs of shape (m,) or (m, D)."""
        t = torch.as_tensor(t, device=self.omega.device)
        if self.omega.ndim == 1:
            proj = t[:, None] * self.omega[None, :]
        else:
            proj = t @ self.omega.T
        return self.scale[None, :] * torch.cos(proj + self.phase[None, :])


def _dtype_device(kernel):
    params = kernel.params
    return params.dtype, params.device


def periodic_harmonic_features(kernel: PeriodicKernel, num_harmonics: int = 64) -> FourierFeatures:
    """Exact (truncated) feature map of the periodic kernel, by
    Jacobi-Anger with c = 1 / w^2:

        k(d) = h^2 e^-c [I_0(c) + 2 sum_{q>=1} I_q(c) cos(q d / p)]

    the constant, then cos and sin pairs at q / p with variances
    h^2 e^-c I_q(c) (twice that for q >= 1).  No draws."""
    h, w, p = kernel.h, kernel.w, kernel.p
    c = 1.0 / (w * w)
    q = torch.arange(num_harmonics + 1, dtype=c.dtype, device=c.device)
    wq = torch.exp(2.0 * torch.log(h) - c + _log_bessel_i(q, c))
    omega = torch.cat([q[:1] * 0.0, q[1:] / p, q[1:] / p])
    zeros = torch.zeros_like(q[1:])
    phase = torch.cat([q[:1] * 0.0, zeros, zeros - math.pi / 2.0])
    scale = torch.cat([torch.sqrt(wq[:1]), torch.sqrt(2.0 * wq[1:]), torch.sqrt(2.0 * wq[1:])])
    return FourierFeatures(omega=omega, phase=phase, scale=scale)


#: truncation for periodic atoms inside composites
_PERIODIC_ATOMS = 128


def _spectral_sample(kernel, draws, num: int) -> torch.Tensor:
    """``num`` frequencies from the kernel's normalized spectral law: (num,)
    for scalar-input kernels, (num, D) for ARD.  Every law is symmetric
    about 0 (the ProductKernel rule relies on it)."""
    dtype, dev = _dtype_device(kernel)
    if isinstance(kernel, GaussianKernel):
        return draws.normal((num,), dtype, dev) / kernel.w
    if isinstance(kernel, (Matern32Kernel, Matern52Kernel)):
        df = 3.0 if isinstance(kernel, Matern32Kernel) else 5.0
        z = draws.normal((num,), dtype, dev)
        g = draws.chisquare(df, (num,), dtype, dev)
        return (z / torch.sqrt(g / df)) / kernel.w
    if isinstance(kernel, RationalQuadraticKernel):
        lam = draws.gamma(kernel.a, (num,), dtype, dev) / kernel.a
        z = draws.normal((num,), dtype, dev)
        return z * torch.sqrt(lam) / kernel.w
    if isinstance(kernel, PeriodicKernel):
        c = 1.0 / torch.square(kernel.w)
        q = torch.arange(_PERIODIC_ATOMS + 1, dtype=dtype, device=dev)
        logw = _log_bessel_i(q, c)  # -c and h^2 cancel in the normalization
        logw = logw + torch.where(q > 0, math.log(2.0), 0.0)  # +-q folded
        qs = draws.categorical(logw, (num,), dev)
        sign = draws.rademacher((num,), dtype, dev)
        return sign * qs.to(dtype) / kernel.p
    if isinstance(kernel, SumKernel):
        w1, w2 = _k0(kernel.k1), _k0(kernel.k2)
        pick1 = draws.bernoulli(w1 / (w1 + w2), (num,), dev)
        o1 = _spectral_sample(kernel.k1, draws, num)
        o2 = _spectral_sample(kernel.k2, draws, num)
        if o1.ndim != o2.ndim:
            raise ValueError("SumKernel children must share input dimension")
        return torch.where(pick1 if o1.ndim == 1 else pick1[:, None], o1, o2)
    if isinstance(kernel, ProductKernel):
        o1 = _spectral_sample(kernel.k1, draws, num)
        o2 = _spectral_sample(kernel.k2, draws, num)
        if o1.ndim != o2.ndim:
            raise ValueError("ProductKernel children must share input dimension")
        return o1 + o2
    if isinstance(kernel, ARDGaussianKernel):
        return draws.normal((num, kernel.w.shape[0]), dtype, dev) / kernel.w[None, :]
    raise NotImplementedError(f"no spectral law registered for {type(kernel).__name__}")


def _k0(kernel) -> torch.Tensor:
    """k(0), the prior variance of a stationary kernel."""
    dtype, dev = _dtype_device(kernel)
    shape = (1, kernel.w.shape[0]) if isinstance(kernel, ARDGaussianKernel) else (1,)
    return kernel.kdiag(torch.zeros(shape, dtype=dtype, device=dev))[0]


def prior_features(kernel, generator=None, num_features: int = 2048) -> FourierFeatures:
    """A Fourier feature map phi with E[phi phi^T] ~= K: the exact harmonic
    map for a standalone periodic kernel, otherwise draws from the kernel's
    spectral law (frequencies, then phases uniform on [0, 2 pi))."""
    if isinstance(kernel, PeriodicKernel):
        return periodic_harmonic_features(kernel, num_harmonics=max(1, (num_features - 1) // 2))
    draws = krylov.as_draws(generator)
    dtype, dev = _dtype_device(kernel)
    omega = _spectral_sample(kernel, draws, num_features)
    phase = draws.uniform((num_features,), dtype, dev) * (2.0 * math.pi)
    scale = torch.sqrt(2.0 * _k0(kernel) / num_features).expand(num_features)
    return FourierFeatures(omega=omega, phase=phase, scale=scale)


def _pathwise_terms(kernel, x, y, noise, draws, n_samples: int, num_features: int):
    """(features, u, residual): residual[:, s] = y - f_prior_s(x) - eps_s,
    what the solve inverts.  The dense and iterative samplers draw the same
    way (features, then u, then eps), so they agree draw for draw."""
    feats = prior_features(kernel, draws, num_features)
    F = feats.num_features
    u = draws.normal((F, n_samples), y.dtype, y.device)
    eps = noise * draws.normal((y.shape[0], n_samples), y.dtype, y.device)
    resid = y[:, None] - feats(x) @ u - eps
    return feats, u, resid


def _cross_matvec(kernel, xo, x, V, block_size: int) -> torch.Tensor:
    """K(xo, x) @ V by strips over x: O(m * block) memory; on a card each
    strip is one kernel-B1 launch (B6 for ARD), then ``torch.matmul``."""
    out = V.new_zeros((xo.shape[0], V.shape[1]))
    for j in range(0, x.shape[0], block_size):
        out = out + kernel(xo, x[j:j + block_size]) @ V[j:j + block_size]
    return out


def sample_posterior_pathwise(post, xo, generator=None, n_samples: int = 1,
                              num_features: int = 2048) -> torch.Tensor:
    """Posterior function draws f(xo), (n_samples, m), by the Matheron
    update through the posterior's Cholesky factor (the m x m predictive
    covariance is never factored, so m can be large); the same posterior
    up to the O(1 / sqrt(F)) feature approximation of the prior."""
    from gaussian_processes_tpu_torch.ops.blocked_cholesky import choose_solve

    xo = torch.as_tensor(xo, device=post.x.device)
    feats, u, resid = _pathwise_terms(post.kernel, post.x, post.y, post.noise,
                                      krylov.as_draws(generator), n_samples, num_features)
    solve = choose_solve(post.L)
    v = solve(post.L, solve(post.L, resid), trans=True)  # (n, S)
    return (feats(xo) @ u + post.kernel(xo, post.x) @ v).T


def sample_posterior_pathwise_iterative(
    post,
    xo,
    generator=None,
    n_samples: int = 1,
    num_features: int = 2048,
    *,
    num_iters: int = 150,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 2048,
    precond_rank: int = 0,
    structure="none",
) -> torch.Tensor:
    """Posterior function draws at matrix-free scale, no N x N array: the
    Matheron solve is batched CG on the (n, n_samples) residual block (PCG
    with the pivoted-Cholesky Woodbury preconditioner for ``precond_rank``
    > 0, the Strang circulant for ``structure="toeplitz"``), the update a
    strip product.  ``structure`` selects the operator as in
    ``fit_iterative`` ("none", "toeplitz", an ``ops.ski.SKIOperator``)."""
    from gaussian_processes_tpu_torch.models.iterative_gp import _operator
    from gaussian_processes_tpu_torch.ops import toeplitz

    kernel, x, y, noise = post.kernel, post.x, post.y, post.noise
    xo = torch.as_tensor(xo, device=x.device)
    feats, u, resid = _pathwise_terms(kernel, x, y, noise, krylov.as_draws(generator),
                                      n_samples, num_features)
    matvec = _operator(kernel, x, noise, jitter, block_size, structure).matvec
    shift = torch.square(noise) + jitter
    if precond_rank > 0:
        L = krylov.pivoted_cholesky(kernel, x, precond_rank)
        pre = krylov.woodbury_inverse_apply(L, shift)
        v, _ = krylov.pcg(matvec, pre, resid, num_iters=num_iters, tol=tol)
    elif isinstance(structure, str) and structure == "toeplitz":
        pre = toeplitz.strang_circulant_precond(toeplitz.toeplitz_column(kernel, x), shift)
        v, _ = krylov.pcg(matvec, pre, resid, num_iters=num_iters, tol=tol)
    else:
        v = krylov.mbcg(matvec, resid, num_iters=num_iters, tol=tol).solution
    return (feats(xo) @ u + _cross_matvec(kernel, xo, x, v, block_size)).T
