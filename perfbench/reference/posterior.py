"""The hyperparameter log posterior of config #3, written plainly.

u = log(h, w, s) for the squared-exponential kernel with noise s, a Normal
prior N(prior_mean, prior_std^2) on each u_i, and the exact log marginal
likelihood of (x, y) with K + (s^2 + jitter) I.  The gradient is analytic:
d lml / d theta_i = tr((alpha alpha^T - K^-1) dK/dtheta_i) / 2 with
dK/dh = 2 h E, dK/dw = h^2 E d^2 / w^3, dK/ds = 2 s I, then the chain rule
into u and the prior's -(u - mu) / sd^2.  C chains at once: u is (C, 3).
"""

from __future__ import annotations

import torch

from perfbench.reference import dense
from perfbench.reference.arith import Arith


class LogPosterior:
    """value_and_grad(u) -> ((C,), (C, 3)) in ``arith.dtype`` for u (C, 3)."""

    def __init__(self, x, y, prior_mean, prior_std, jitter, arith: Arith, block: int = 128):
        self.arith, self.block = arith, block
        dt = arith.dtype
        self.x = torch.as_tensor(x).to(dt)
        self.y = torch.as_tensor(y).to(self.x)
        self.mu, self.sd, self.jitter = float(prior_mean), float(prior_std), float(jitter)
        d = self.x[:, None] - self.x[None, :]
        self.d2 = d * d

    def value_and_grad(self, u):
        dt = self.arith.dtype
        u = torch.as_tensor(u).to(device=self.x.device, dtype=dt)
        single = u.ndim == 1
        u = u[None] if single else u
        theta = torch.exp(u)
        h, w, s = (theta[:, i, None, None] for i in range(3))
        n = self.x.shape[0]
        E = torch.exp(-0.5 * self.d2 / (w * w))
        eye = torch.eye(n, dtype=dt, device=u.device)
        K = h * h * E + (s * s + self.jitter) * eye
        L = torch.tril(dense.cholesky_(K.clone(), self.arith, self.block))
        Y = self.y[None, :, None].expand(u.shape[0], n, 1).clone()
        alpha = dense.backward_(L, dense.forward_(L, Y, self.arith, self.block),
                                self.arith, self.block)[..., 0]
        half_logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        lml = -0.5 * (alpha @ self.y) - half_logdet - 0.5 * n * dense.LOG_2PI
        K_inv = torch.cholesky_inverse(L)
        W = alpha[:, :, None] * alpha[:, None, :] - K_inv
        g_h = 0.5 * torch.sum(W * (2.0 * h * E), dim=(-2, -1))
        g_w = 0.5 * torch.sum(W * (h * h * E * self.d2 / (w * w * w)), dim=(-2, -1))
        g_s = theta[:, 2] * (torch.sum(alpha * alpha, -1)
                             - torch.diagonal(K_inv, dim1=-2, dim2=-1).sum(-1))
        g_theta = torch.stack([g_h, g_w, g_s], dim=-1)
        z = (u - self.mu) / self.sd
        value = lml - 0.5 * torch.sum(z * z, dim=-1)
        grad = g_theta * theta - z / self.sd
        return (value[0], grad[0]) if single else (value, grad)
