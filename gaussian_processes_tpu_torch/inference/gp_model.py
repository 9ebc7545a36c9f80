"""GP hyperparameter posterior / objective builders.

Counterpart of ``gaussian_processes_tpu/inference/gp_model.py``: the log
marginal likelihood of the exact-GP core (models/gp.py) as a function of
*unconstrained* parameters u = log(theta), theta = (kernel params...,
noise s), for type-II MLE (inference/mle.py) and the samplers
(inference/nuts.py, inference/chees.py).  The prior is independent Normal
on u (log-normal on theta), weakly informative by default.

Each builder returns a ``LogDensity``: ``f(u)`` is a scalar for u of shape
(D,) and (C,) for a (C, D) stack of chains, differentiable by
``torch.autograd``; ``f.value_and_grad(u)`` returns the value and its
gradient in u without building an autograd graph (the samplers call it at
every leapfrog).  The gradient is analytic, not autograd through the
kernels: the exact builders run ``log_marginal_value_and_grad_chains`` (on a
card B1 and B2a over the chains' parameter table, B3 under the batched
blocked factor), then the chain rule into u, g_u = g_theta * theta -
(u - mu) / sd^2; the autograd rule's backward is one multiply, as the JAX
package's ``custom_vjp`` of its iterative posterior is.

The Whittle builders (``make_log_posterior_whittle``, ``_kron``) come with
slice 3 and raise, naming it.
"""

from __future__ import annotations

from typing import Callable

import torch

from gaussian_processes_tpu_torch.models.base import Kernel
from gaussian_processes_tpu_torch.models.gp import log_marginal_value_and_grad_chains
from gaussian_processes_tpu_torch.ops import krylov

#: seed of the iterative posterior's frozen probes (the JAX package's key)
PROBE_SEED = 20240817


class _LogDensityFn(torch.autograd.Function):
    """Value of a ``LogDensity`` with its analytic gradient stashed for the
    backward pass, which is one multiply."""

    @staticmethod
    def forward(ctx, u, density):
        value, grad = density.value_and_grad(u.detach())
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return ct[..., None] * grad, None


class LogDensity:
    """A log density over u built from ``value_and_grad_chains``, a function
    (C, D) -> ((C,), (C, D)) of detached tensors."""

    def __init__(self, value_and_grad_chains: Callable):
        self._vg = value_and_grad_chains

    def value_and_grad(self, u):
        """(value, d value / du) for u of shape (D,) or (C, D), no graph."""
        u = torch.as_tensor(u).detach()
        if u.ndim == 2:
            return self._vg(u)
        value, grad = self._vg(u[None])
        return value[0], grad[0]

    def __call__(self, u):
        return _LogDensityFn.apply(torch.as_tensor(u), self)


def n_hypers(kernel: Kernel) -> int:
    """Dimension of u = (log kernel params..., log noise)."""
    return kernel.n_params + 1


def unpack(kernel_template: Kernel, u):
    """u (P+1,) in log space -> (kernel, noise) in natural space."""
    theta = torch.exp(torch.as_tensor(u))
    P = kernel_template.n_params
    return kernel_template.with_params(theta[:P]), theta[P]


def pack(kernel: Kernel, noise) -> torch.Tensor:
    """(kernel, noise) -> u in log space."""
    params = kernel.params
    noise = torch.as_tensor(noise, dtype=params.dtype, device=params.device)
    return torch.log(torch.cat([params, noise.reshape(1)]))


def _data(x, y):
    x = torch.as_tensor(x)
    return x, torch.as_tensor(y, dtype=x.dtype, device=x.device)


def _prior(prior_mean, prior_std, x):
    return (torch.as_tensor(prior_mean, dtype=x.dtype, device=x.device),
            torch.as_tensor(prior_std, dtype=x.dtype, device=x.device))


def make_log_likelihood(kernel_template: Kernel, x, y, jitter: float = 0.0) -> LogDensity:
    """log p(y | x, exp(u)) as a function of unconstrained u."""
    x, y = _data(x, y)

    def value_and_grad(u):
        theta = torch.exp(u)
        lml, g_theta = log_marginal_value_and_grad_chains(kernel_template, x, y, theta, jitter)
        return lml, g_theta * theta

    return LogDensity(value_and_grad)


def make_log_posterior(
    kernel_template: Kernel,
    x,
    y,
    *,
    prior_mean=0.0,
    prior_std=2.0,
    jitter: float = 0.0,
) -> LogDensity:
    """Unnormalized log posterior over u = log(theta) for NUTS/ChEES.

    log p(u | x, y) = log p(y | x, exp(u)) + sum_i log N(u_i; mu_i, sd_i)

    ``prior_mean``/``prior_std`` broadcast against u (scalar or (P+1,)).
    """
    x, y = _data(x, y)
    mu, sd = _prior(prior_mean, prior_std, x)

    def value_and_grad(u):
        theta = torch.exp(u)
        lml, g_theta = log_marginal_value_and_grad_chains(kernel_template, x, y, theta, jitter)
        z = (u - mu) / sd
        return lml - 0.5 * torch.sum(z * z, dim=-1), g_theta * theta - z / sd

    return LogDensity(value_and_grad)


class _FrozenDraws:
    """The first evaluation's random draws, handed out again at every later
    one: ``rewind`` before each evaluation."""

    def __init__(self, source):
        self.source = source
        self.recorded = []
        self.i = 0

    def rewind(self):
        self.i = 0

    def _take(self, kind, shape, dtype, device):
        if self.i == len(self.recorded):
            self.recorded.append(getattr(self.source, kind)(shape, dtype, device))
        a = self.recorded[self.i]
        if tuple(a.shape) != tuple(shape):
            raise RuntimeError(f"frozen draw {self.i} has shape {tuple(a.shape)}, "
                               f"asked {tuple(shape)}")
        self.i += 1
        return a.to(dtype=dtype, device=device)

    def rademacher(self, shape, dtype, device):
        return self._take("rademacher", shape, dtype, device)

    def normal(self, shape, dtype, device):
        return self._take("normal", shape, dtype, device)


def make_log_posterior_iterative(
    kernel_template: Kernel,
    x,
    y,
    *,
    probe_generator=None,
    prior_mean=0.0,
    prior_std=2.0,
    num_probes: int = 8,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    early_exit: bool = True,
    structure: str = "none",
) -> LogDensity:
    """Matrix-free log posterior over u = log(theta) for NUTS/ChEES.

    The value comes from PCG + SLQ and the gradient from the Hutchinson
    trace identity over the same solves (models/iterative_gp.py:
    ``log_marginal_value_and_grad_iterative``), one evaluation per call.

    **Fixed probes**: the probes (and the preconditioner's draws) come from
    ``probe_generator`` (a ``torch.Generator``, default seeded with
    ``PROBE_SEED``, or any object with ``krylov.Draws``' methods) at the
    first evaluation and are reused at every later one, so the sampler
    targets one deterministic surrogate log-density.  ``early_exit`` applies
    only to preconditioned solves (``precond_rank > 0``), as in the JAX
    package.  One chain at a time: a (C, D) input is evaluated chain by
    chain.
    """
    x, y = _data(x, y)
    mu, sd = _prior(prior_mean, prior_std, x)
    P = kernel_template.n_params
    if probe_generator is None:
        probe_generator = torch.Generator().manual_seed(PROBE_SEED)
    draws = _FrozenDraws(krylov.as_draws(probe_generator))

    from gaussian_processes_tpu_torch.models.iterative_gp import (
        log_marginal_value_and_grad_iterative,
    )

    def one(u):
        theta = torch.exp(u)
        draws.rewind()
        lml, g_theta = log_marginal_value_and_grad_iterative(
            kernel_template.with_params(theta[:P]), x, y, theta[P], draws,
            num_probes=num_probes, num_iters=num_iters, tol=tol, jitter=jitter,
            block_size=block_size, precond_rank=precond_rank,
            early_exit=early_exit and precond_rank > 0, structure=structure,
        )
        z = (u - mu) / sd
        return lml - 0.5 * torch.sum(z * z), g_theta * theta - z / sd

    def value_and_grad(u):
        values, grads = zip(*(one(row) for row in u))
        return torch.stack(values), torch.stack(grads)

    return LogDensity(value_and_grad)


def make_log_posterior_whittle(*args, **kwargs):
    raise NotImplementedError("the Whittle posterior is not ported yet (ROADMAP slice 3, "
                              "structured grids)")


def make_log_posterior_whittle_kron(*args, **kwargs):
    raise NotImplementedError("the Kronecker Whittle posterior is not ported yet (ROADMAP "
                              "slice 3, structured grids)")


def init_positions(
    kernel_template: Kernel,
    noise,
    generator: torch.Generator | None,
    n_chains: int,
    spread: float = 0.5,
    dtype=None,
) -> torch.Tensor:
    """Jittered chain initializations (n_chains, P+1) around log(theta):
    u0 + spread * N(0, 1), drawn on the generator's device and moved to the
    kernel's."""
    u0 = pack(kernel_template, noise)
    if dtype is not None:
        u0 = u0.to(dtype)
    gen_device = generator.device if generator is not None else "cpu"
    eps = torch.randn((n_chains, u0.shape[0]), generator=generator, dtype=u0.dtype,
                      device=gen_device).to(u0.device)
    return u0[None, :] + spread * eps
