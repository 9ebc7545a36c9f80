"""Type-II maximum-likelihood hyperparameter estimation.

Counterpart of ``gaussian_processes_tpu/inference/mle.py`` (BASELINE.json:8,
config #2).  The objective is the negative log marginal likelihood over
unconstrained u = log(kernel params..., noise) from inference/gp_model.py,
with its analytic gradient.  Optimizers: L-BFGS (default; memory 10, as
optax's) or ``torch.optim.Adam`` (the same algorithm as optax's Adam).  One
optimizer step per entry of ``losses``; the best iterate is tracked as in
the JAX package, the final iterate checked against it.  Restarts run one
after another (the line search does not batch).

L-BFGS is written here, not taken from ``torch.optim.LBFGS``: its
strong-Wolfe line search takes a trial point where the objective is not
finite as the next iterate (NaN from then on), where optax's zoom line
search rejects such points (config #2's third restart, float32 on an H100,
extrapolated to a NaN point at step 8 and stayed NaN; PERF.md).  The line
search here backtracks (Armijo) and treats a non-finite value as too long
a step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_processes_tpu_torch.inference import gp_model
from gaussian_processes_tpu_torch.models.base import Kernel


#: L-BFGS memory (optax's default), the line search's budget of halvings
#: and its sufficient-decrease constant
_LBFGS_MEMORY = 10
_LINE_SEARCH_EVALS = 25
_ARMIJO = 1e-4


class MLEResult(NamedTuple):
    kernel: Kernel
    noise: torch.Tensor
    u: torch.Tensor  # optimal log-parameters
    log_marginal: torch.Tensor  # at the optimum
    losses: torch.Tensor  # per-step objective trace
    converged: torch.Tensor  # gradient norm at the optimum below tol


class _LBFGS:
    """L-BFGS (two-loop recursion, initial Hessian scaled by s.y / y.y) with
    a backtracking line search that treats a non-finite objective as too
    long a step.  ``loss_and_grad`` maps u to (loss, gradient)."""

    def __init__(self, loss_and_grad, u0):
        self.loss_and_grad = loss_and_grad
        self.u = u0.clone()
        self.value, self.grad = loss_and_grad(self.u)
        self.pairs = []  # (s, y, 1 / s.y), oldest first
        self.stalled = False  # steepest descent found no acceptable step

    def _direction(self):
        q = -self.grad
        alphas = []
        for s, y, rho in reversed(self.pairs):
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append(a)
        if self.pairs:
            s, y, _ = self.pairs[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for (s, y, rho), a in zip(self.pairs, reversed(alphas)):
            q = q + (a - rho * torch.dot(y, q)) * s
        return q

    def step(self):
        """One iteration; returns (the iterate before it, its loss)."""
        u, value, grad = self.u, self.value, self.grad
        if self.stalled or not bool(torch.isfinite(value)):
            return u, value
        d = self._direction()
        slope = float(torch.dot(grad, d))
        if not slope < 0.0:  # not downhill: forget the memory
            self.pairs.clear()
            d, slope = -grad, -float(torch.dot(grad, grad))
        if not slope < 0.0:  # a zero gradient: a stationary point
            self.stalled = True
            return u, value
        # a unit step once the memory scales the direction; the first step
        # as torch.optim.LBFGS takes it
        t = 1.0 if self.pairs else min(1.0, 1.0 / float(grad.abs().sum()))
        for _ in range(_LINE_SEARCH_EVALS):
            u_new = u + t * d
            v_new, g_new = self.loss_and_grad(u_new)
            if bool(torch.isfinite(v_new)) and float(v_new) <= float(value) + _ARMIJO * t * slope:
                s, y = u_new - u, g_new - grad
                sy = float(torch.dot(s, y))
                if sy > 1e-10:  # curvature: keep the pair
                    self.pairs = (self.pairs + [(s, y, 1.0 / sy)])[-_LBFGS_MEMORY:]
                self.u, self.value, self.grad = u_new, v_new, g_new
                return u, value
            t *= 0.5
        # no acceptable step: stay and start the memory anew; if that was
        # already steepest descent, the iterate is a minimum to the
        # objective's precision and later steps stay there
        self.stalled = not self.pairs
        self.pairs.clear()
        return u, value


def _run_opt(loss_and_grad, u0, method: str, learning_rate: float, num_steps: int):
    """(best u, best loss, per-step losses).  Each step's loss is the
    objective at the iterate before that step's update, as in the JAX
    package's scan; the best of those and of the final iterate wins."""
    if method == "lbfgs":
        opt = _LBFGS(loss_and_grad, u0.detach())
        step = opt.step

        def final():
            return opt.u, opt.value
    elif method == "adam":
        u = u0.detach().clone().requires_grad_(True)
        adam = torch.optim.Adam([u], lr=learning_rate)

        def closure():
            value, grad = loss_and_grad(u.detach())
            u.grad = grad
            return value

        def step():
            before = u.detach().clone()
            return before, adam.step(closure)

        def final():
            return u.detach(), loss_and_grad(u.detach())[0]
    else:
        raise ValueError(f"unknown method: {method!r}")

    best_u = u0.detach().clone()
    best_loss = torch.full((), float("inf"), dtype=u0.dtype, device=u0.device)
    losses = []
    for _ in range(num_steps):
        before, value = step()
        better = value < best_loss
        best_u = torch.where(better, before, best_u)
        best_loss = torch.where(better, value, best_loss)
        losses.append(value)
    u_final, final_loss = final()
    better = final_loss < best_loss
    best_u = torch.where(better, u_final, best_u)
    best_loss = torch.where(better, final_loss, best_loss)
    return best_u, best_loss, torch.stack(losses) if losses else u0.new_zeros((0,))


def fit_mle(
    kernel_template: Kernel,
    x,
    y,
    noise_init,
    *,
    num_steps: int = 100,
    method: str = "lbfgs",
    learning_rate: float = 0.05,
    jitter: float = 0.0,
    grad_tol: float = 1e-3,
    objective: str = "exact",
    inducing=None,
) -> MLEResult:
    """Optimize (kernel params, noise) by maximizing log p(y | x, theta).

    The returned kernel/noise are in natural space.  ``objective``:
    ``"exact"`` (the Cholesky log marginal likelihood), ``"whittle"`` (the
    circulant-model density of ``ops/toeplitz.py::whittle_log_marginal``, for
    uniform-grid x) or ``"sgpr"`` (the Titsias collapsed bound of
    ``models/sgpr.py`` at the inducing inputs ``inducing``, required; its
    jitter is 1e-6 unless a positive one is given; to learn the inducing
    locations too use ``models.sgpr.fit_sgpr_mle(learn_inducing=True)``).
    """
    x = torch.as_tensor(x)
    if objective == "sgpr":
        from gaussian_processes_tpu_torch.models.sgpr import log_density_sgpr

        if inducing is None:
            raise ValueError("objective='sgpr' requires inducing points")
        log_lik = log_density_sgpr(kernel_template, x, y, inducing,
                                   jitter=jitter if jitter > 0.0 else 1e-6)
    elif objective == "whittle":
        log_lik = gp_model.make_log_posterior_whittle(kernel_template, x, y, jitter=jitter,
                                                      center=False, prior_std=None)
    elif objective == "exact":
        log_lik = gp_model.make_log_likelihood(kernel_template, x, y, jitter)
    else:
        raise ValueError(f"unknown objective: {objective!r}")

    def loss_and_grad(u):
        value, grad = log_lik.value_and_grad(u)
        return -value, -grad

    u0 = gp_model.pack(kernel_template, noise_init).to(dtype=x.dtype, device=x.device)
    best_u, best_loss, losses = _run_opt(loss_and_grad, u0, method, learning_rate, num_steps)
    kernel, noise = gp_model.unpack(kernel_template, best_u)
    _, grad = loss_and_grad(best_u)
    return MLEResult(
        kernel=kernel,
        noise=noise,
        u=best_u,
        log_marginal=-best_loss,
        losses=losses,
        converged=torch.linalg.norm(grad) < grad_tol,
    )


def fit_mle_restarts(
    kernel_template: Kernel,
    x,
    y,
    noise_init,
    generator: torch.Generator | None = None,
    n_restarts: int = 8,
    spread: float = 1.0,
    **kwargs,
) -> MLEResult:
    """Multi-restart MLE from jittered inits exp(u0 + spread N(0, 1)),
    returning the restart with the largest log marginal likelihood (guards
    against multimodal likelihoods, e.g. the periodic kernel's period)."""
    x = torch.as_tensor(x)
    u0 = gp_model.pack(kernel_template, noise_init).to(dtype=x.dtype, device=x.device)
    # drawn in float64 and rounded, so that a float32 and a float64 run of
    # one seed start from the same points
    gen_device = generator.device if generator is not None else "cpu"
    eps = torch.randn((n_restarts, u0.shape[0]), generator=generator, dtype=torch.float64,
                      device=gen_device).to(dtype=u0.dtype, device=u0.device)
    inits = torch.exp(u0[None, :] + spread * eps)
    P = kernel_template.n_params
    results = [fit_mle(kernel_template.with_params(theta0[:P]), x, y, theta0[P], **kwargs)
               for theta0 in inits]
    lmls = torch.stack([r.log_marginal for r in results])
    best = int(torch.argmax(torch.nan_to_num(lmls, nan=-float("inf"))))
    return results[best]
