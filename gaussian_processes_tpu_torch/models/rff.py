"""Random-feature (RFF) GP regression: the feature-space path.

Counterpart of ``gaussian_processes_tpu/models/rff.py``.  The kernel is
approximated by F spectral features (``models/pathwise.py::prior_features``,
E[phi phi^T] ~= K) and the regression is exact Bayesian linear regression
in feature space:

    y = Phi w + eps,  w ~ N(0, I_F),  eps ~ N(0, s^2 I)
    A = Phi^T Phi + s^2 I_F            (F x F)
    w_mean = A^-1 Phi^T y
    mean(xo) = phi(xo)^T w_mean,  var(xo) = s^2 phi(xo)^T A^-1 phi(xo)
    lml = -1/2 [(y^T y - (Phi^T y)^T A^-1 Phi^T y) / s^2
                + logdet(A) + (n - F) log s^2 + n log 2 pi]

One blocked sweep accumulates A and Phi^T y over row blocks of x (the (n, F)
feature matrix never exists; each block is two ``torch.matmul``s, float32
at full precision per utils/device.py), then one F x F Cholesky: the
library's ``torch.linalg.cholesky``, as the JAX package takes XLA's here.
No hand kernel runs on this path.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_processes_tpu_torch.models.gp import _LOG_2PI
from gaussian_processes_tpu_torch.models.pathwise import FourierFeatures, prior_features
from gaussian_processes_tpu_torch.ops import krylov


@dataclasses.dataclass(frozen=True)
class RFFPosterior:
    feats: FourierFeatures
    L_A: torch.Tensor  # (F, F) lower Cholesky of A = Phi^T Phi + s^2 I
    w_mean: torch.Tensor  # (F,)
    noise: torch.Tensor
    log_marginal: torch.Tensor


def fit_rff(
    kernel,
    x,
    y,
    noise,
    generator=None,
    *,
    num_features: int = 2048,
    block_size: int = 8192,
    jitter: float = 0.0,
) -> RFFPosterior:
    """Feature-space GP fit: memory O(F^2 + block * F), flops O(n F^2).
    A ragged last block takes the place of the JAX package's masked
    padding (a padded row would contribute zero)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    n = y.shape[0]
    feats = prior_features(kernel, krylov.as_draws(generator), num_features)
    F = feats.num_features
    A = x.new_zeros((F, F))
    py = x.new_zeros((F,))
    for j in range(0, n, block_size):
        Pj = feats(x[j:j + block_size])  # (b, F)
        A = torch.addmm(A, Pj.T, Pj)
        py = py + Pj.T @ y[j:j + block_size]
    s2 = torch.square(noise) + jitter
    A = A + s2 * torch.eye(F, dtype=x.dtype, device=x.device)
    L_A = torch.linalg.cholesky(A)
    w_mean = torch.cholesky_solve(py[:, None], L_A)[:, 0]
    # the matrix determinant lemma: every term F x F
    quad = (torch.dot(y, y) - torch.dot(py, w_mean)) / s2
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L_A))) + (n - F) * torch.log(s2)
    lml = -0.5 * (quad + logdet + n * _LOG_2PI)
    return RFFPosterior(feats=feats, L_A=L_A, w_mean=w_mean, noise=noise, log_marginal=lml)


def predict_rff(post: RFFPosterior, xo):
    """(mean, latent variance) at the query points: O(m F^2)."""
    P = post.feats(xo)  # (m, F)
    mean = P @ post.w_mean
    Z = torch.linalg.solve_triangular(post.L_A, P.T, upper=False)  # (F, m)
    return mean, torch.square(post.noise) * torch.sum(torch.square(Z), dim=0)


def sample_rff_posterior(post: RFFPosterior, xo, generator=None, n_samples: int = 1):
    """Posterior function draws (n_samples, m): w ~ N(w_mean, s^2 A^-1) as
    w_mean + s L_A^-T z, then f = phi(xo)^T w."""
    F = post.w_mean.shape[0]
    z = krylov.as_draws(generator).normal((F, n_samples), post.w_mean.dtype,
                                          post.w_mean.device)
    dw = post.noise * torch.linalg.solve_triangular(post.L_A.T, z, upper=True)
    return (post.feats(xo) @ (post.w_mean[:, None] + dw)).T
