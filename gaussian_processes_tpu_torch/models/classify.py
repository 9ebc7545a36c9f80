"""Non-Gaussian observation models by the Laplace approximation.

Counterpart of ``gaussian_processes_tpu/models/classify.py`` (Rasmussen &
Williams ch. 3, algorithms 3.1 / 3.2): the latent GP posterior is
approximated by a Gaussian at its Newton mode.

* ``LogisticLikelihood``: labels in {-1, +1}, p(y | f) = sigmoid(y f);
  class probabilities by MacKay's probit approximation.
* ``PoissonLikelihood(binsize)``: counts, y | f ~ Poisson(binsize e^f);
  predictive rate binsize exp(mean + var / 2).

Any likelihood with ``terms(f, y) -> (sum log p, d/df, W = -d2/df2)``, W >=
0, plugs in.  Each Newton step factors B = I + W^1/2 K W^1/2 with
``choose_cholesky`` (on a card the blocked factor with kernel B3 as its
base); K comes from kernel B1 (B6 for ARD).  The step count is fixed and a
fixed three-step backtracking ladder takes the best candidate by
``torch.where`` (no host read in the loop), which makes the iteration
monotone in psi (the JAX package measured float32 Poisson Newton diverging
without it).  The evidence is R&W eq. 3.32, differentiable by autograd
through the unrolled steps: on a card through kernel B1's and the blocked
factor's autograd rules (``ops/pairwise.py``, ``ops/blocked_cholesky.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gaussian_processes_tpu_torch.ops.blocked_cholesky import choose_cholesky, choose_solve


@dataclasses.dataclass(frozen=True)
class LaplacePosterior:
    """The Laplace-approximate latent posterior at the mode."""

    kernel: torch.nn.Module
    likelihood: object
    x: torch.Tensor
    y: torch.Tensor
    f_hat: torch.Tensor  # (n,) latent mode
    sqrt_w: torch.Tensor  # (n,) W^1/2 at the mode
    L_B: torch.Tensor  # (n, n) chol(I + W^1/2 K W^1/2)
    #: K^-1 f_hat as the Newton recurrence carries it: the stable
    #: representer weights for prediction (the raw likelihood gradient's
    #: smoothing relies on a cancellation that float32 mode error breaks)
    a_hat: torch.Tensor
    grad_lik: torch.Tensor  # (n,) d log p(y | f) / df at the mode
    log_marginal: torch.Tensor  # Laplace approximation of log p(y | x, theta)
    newton_deltas: torch.Tensor  # (iters,) psi change per Newton step


def _log_sigmoid(z):
    return -torch.logaddexp(torch.zeros_like(z), -z)


@dataclasses.dataclass(frozen=True)
class LogisticLikelihood:
    """Binary labels in {-1, +1}, p(y | f) = sigmoid(y f)."""

    def log_prob(self, f, y):
        return _log_sigmoid(y * f)

    def terms(self, f, y):
        """(sum log p(y | f), gradient (n,), W (n,)) at latent f."""
        ll = torch.sum(self.log_prob(f, y))
        pi = torch.sigmoid(f)
        grad = 0.5 * (y + 1.0) - pi
        return ll, grad, pi * (1.0 - pi)

    def predict(self, mean, var):
        """p(y = +1) averaged over the latent Gaussian (probit approximation)."""
        kappa = 1.0 / torch.sqrt(1.0 + math.pi * var / 8.0)
        return torch.sigmoid(kappa * mean)


@dataclasses.dataclass(frozen=True)
class PoissonLikelihood:
    """Counts y >= 0 with log link: y | f ~ Poisson(binsize e^f)."""

    binsize: float = 1.0

    def log_prob(self, f, y):
        b = torch.as_tensor(self.binsize, dtype=f.dtype, device=f.device)
        return y * (f + torch.log(b)) - b * torch.exp(f) - torch.lgamma(y + 1.0)

    def terms(self, f, y):
        b = torch.as_tensor(self.binsize, dtype=f.dtype, device=f.device)
        rate = b * torch.exp(f)
        return torch.sum(self.log_prob(f, y)), y - rate, rate

    def predict(self, mean, var):
        """Posterior-expected rate binsize exp(mean + var / 2)."""
        return self.binsize * torch.exp(mean + 0.5 * var)


def fit_laplace(kernel, x, y, *, likelihood=None, num_iters: int = 20,
                jitter: float = 1e-6) -> LaplacePosterior:
    """The latent mode by ``num_iters`` Newton steps (R&W alg. 3.1) through
    B = I + W^1/2 K W^1/2 (eigenvalues in [1, 1 + n max(K) / 4]); K^-1 is
    never formed."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    dtype = y.dtype if y.is_floating_point() else torch.float64
    y = y.to(dtype)
    n = y.shape[0]
    lik = LogisticLikelihood() if likelihood is None else likelihood
    eye = torch.eye(n, dtype=dtype, device=x.device)
    K = kernel(x, x) + jitter * eye
    chol, solve = choose_cholesky(K), choose_solve(K)

    def obj(f, a):  # psi(f) = log p(y | f) - a^T f / 2 with a = K^-1 f
        return lik.terms(f, y)[0] - 0.5 * torch.dot(a, f)

    f = y.new_zeros(n)
    a = y.new_zeros(n)
    psi_prev = torch.full((), -math.inf, dtype=dtype, device=x.device)
    deltas = []
    for _ in range(num_iters):
        _, grad, w = lik.terms(f, y)
        sw = torch.sqrt(torch.clamp_min(w, 0.0))
        L = chol(eye + sw[:, None] * K * sw[None, :])
        b = w * f + grad
        v = solve(L, solve(L, sw * (K @ b)), trans=True)
        a_new = b - sw * v  # = K^-1 f_new
        f_new = K @ a_new
        # a fixed backtracking ladder: the best psi among the full step, its
        # halves and staying put; a_t stays K^-1 f_t since a is linear in f
        best_f, best_a = f, a
        best_psi = torch.where(torch.isfinite(psi_prev), psi_prev, -math.inf)
        for t in (1.0, 0.5, 0.25):
            f_t = f + t * (f_new - f)
            a_t = a + t * (a_new - a)
            psi_t = obj(f_t, a_t)
            take = psi_t > best_psi
            best_f = torch.where(take, f_t, best_f)
            best_a = torch.where(take, a_t, best_a)
            best_psi = torch.where(take, psi_t, best_psi)
        deltas.append(best_psi - psi_prev)
        f, a, psi_prev = best_f, best_a, best_psi

    ll, grad, w = lik.terms(f, y)
    sw = torch.sqrt(torch.clamp_min(w, 0.0))
    L_B = chol(eye + sw[:, None] * K * sw[None, :])
    # R&W eq. 3.32: -a^T f / 2 + log p(y | f_hat) - sum log diag chol(B)
    lml = -0.5 * torch.dot(a, f) + ll - torch.sum(torch.log(torch.diagonal(L_B)))
    return LaplacePosterior(
        kernel=kernel, likelihood=lik, x=x, y=y, f_hat=f, sqrt_w=sw, L_B=L_B, a_hat=a,
        grad_lik=grad, log_marginal=lml,
        newton_deltas=torch.stack(deltas) if deltas else y.new_zeros((0,)),
    )


def predict_laplace(post: LaplacePosterior, xo):
    """Latent predictive mean and variance and the likelihood's transform
    (R&W alg. 3.2): mean = k(xo)^T a_hat, var = k(xo, xo) -
    ||L^-1 W^1/2 k(xo)||^2."""
    xo = torch.as_tensor(xo, device=post.x.device)
    Ks = post.kernel(post.x, xo)  # (n, q)
    mean = Ks.T @ post.a_hat
    v = choose_solve(post.L_B)(post.L_B, post.sqrt_w[:, None] * Ks)
    var = torch.clamp_min(post.kernel.kdiag(xo).to(mean.dtype)
                          - torch.sum(torch.square(v), dim=0), 0.0)
    return mean, var, post.likelihood.predict(mean, var)


def log_marginal_laplace(kernel, x, y, *, likelihood=None, num_iters: int = 20,
                         jitter: float = 1e-6) -> torch.Tensor:
    """The Laplace-approximate evidence alone: the differentiable objective
    of type-II MLE over the latent GP's hyperparameters."""
    return fit_laplace(kernel, x, y, likelihood=likelihood, num_iters=num_iters,
                       jitter=jitter).log_marginal


def fit_laplace_mle(kernel_template, x, y, *, likelihood=None, num_steps: int = 100,
                    learning_rate: float = 0.05, newton_iters: int = 20,
                    jitter: float = 1e-6):
    """Type-II MLE over log kernel params by Adam on the Laplace evidence
    (no noise parameter).  Returns (LaplacePosterior at the best iterate,
    losses)."""
    from gaussian_processes_tpu_torch.inference.mle import _run_opt

    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    u0 = torch.log(kernel_template.params).to(device=x.device)

    def loss_and_grad(u):
        with torch.enable_grad():
            u = u.detach().requires_grad_()
            loss = -log_marginal_laplace(kernel_template.with_params(torch.exp(u)), x, y,
                                         likelihood=likelihood, num_iters=newton_iters,
                                         jitter=jitter)
            (grad,) = torch.autograd.grad(loss, u)
        return loss.detach(), grad

    best_u, _, losses = _run_opt(loss_and_grad, u0, "adam", learning_rate, num_steps)
    post = fit_laplace(kernel_template.with_params(torch.exp(best_u)), x, y,
                       likelihood=likelihood, num_iters=newton_iters, jitter=jitter)
    return post, losses
