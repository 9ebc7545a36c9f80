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

The Whittle builders (``make_log_posterior_whittle``, ``_kron``) have no
hand kernel under them (the spectra are tensor expressions and FFTs): their
gradient is autograd over those operations, one graph per call, freed by
``torch.autograd.grad`` before it returns.
"""

from __future__ import annotations

from typing import Callable

import torch

from gaussian_processes_tpu_torch.models.base import Kernel
from gaussian_processes_tpu_torch.models.gp import _LOG_2PI, log_marginal_value_and_grad_chains
from gaussian_processes_tpu_torch.ops import krylov
from gaussian_processes_tpu_torch.utils.profiling import counts, span

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
        """(value, d value / du) for u of shape (D,) or (C, D), no graph;
        counted as ``core.value_and_grad`` in ``utils.profiling.counts``,
        its rows (C, or 1 for a point) as ``core.rows``."""
        counts["core.value_and_grad"] += 1
        with span("gp.core.value_and_grad"):
            u = torch.as_tensor(u).detach()
            counts["core.rows"] += u.shape[0] if u.ndim == 2 else 1
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


def _whittle_density(lml_of_theta, n_kernel_params, mu, sd) -> LogDensity:
    """A ``LogDensity`` from ``lml_of_theta`` (kernel parameters (C, P) and
    noise (C, 1) -> (C,), autograd-differentiable) plus the Normal prior on
    u unless ``sd`` is None."""

    def value_and_grad(u):
        with torch.enable_grad():
            u = u.detach().requires_grad_(True)
            theta = torch.exp(u)
            value = lml_of_theta(theta[:, :n_kernel_params], theta[:, n_kernel_params:])
            if sd is not None:
                z = (u - mu) / sd
                value = value - 0.5 * torch.sum(z * z, dim=-1)
            (grad,) = torch.autograd.grad(value.sum(), u)
        return value.detach(), grad

    return LogDensity(value_and_grad)


def _whittle_terms(kernel_template, spectrum_fn, p_y, w, n, *, mu, center, dtype):
    """lml_of_theta for the 1-D or Kronecker Whittle density: ``spectrum_fn``
    (theta_k, noise) -> lam, (C, bins...); ``p_y`` and the bin weights ``w``
    flattened."""
    P = kernel_template.n_params

    def flat(lam):
        return lam.flatten(1)

    if not center:
        def lml_of_theta(theta_k, noise):
            lam = flat(spectrum_fn(theta_k, noise))
            quad = torch.sum(w * p_y / lam, dim=-1) / n
            logdet = torch.sum(w * torch.log(lam), dim=-1)
            return -0.5 * quad - 0.5 * logdet - 0.5 * n * _LOG_2PI

        return lml_of_theta

    theta_c = torch.exp(torch.broadcast_to(mu.to(dtype), (P + 1,)))[None]
    with torch.no_grad():
        lam0 = flat(spectrum_fn(theta_c[:, :P], theta_c[:, P:]))
    log_lam0 = torch.log(lam0)

    def lml_of_theta(theta_k, noise):
        lam = flat(spectrum_fn(theta_k, noise))
        # per-bin differences: each term is O(|u - mu|), so the float32
        # reduction never sees the ~1e6-magnitude absolute lml
        dquad = torch.sum(w * p_y * (lam0 - lam) / (lam * lam0), dim=-1) / n
        dlogdet = torch.sum(w * (torch.log(lam) - log_lam0), dim=-1)
        return -0.5 * (dquad + dlogdet)

    return lml_of_theta


def make_log_posterior_whittle(
    kernel_template: Kernel,
    x,
    y,
    *,
    prior_mean=0.0,
    prior_std=2.0,
    jitter: float = 0.0,
    center: bool = True,
    spectrum: str = "auto",
) -> LogDensity:
    """Log posterior over u = log(theta) with the WHITTLE likelihood.

    For uniform-grid data (assert with ``ops.toeplitz.is_uniform_grid``): the
    exact log-density of the circulant surrogate model, three FFT and
    elementwise operations per evaluation, deterministic.  ``spectrum``
    selects the circulant eigenvalues (``ops/toeplitz.py::whittle_spectrum``):
    "auto" takes the analytic aliased density where the kernel has one (at
    n ~ 1e6 a float32 FFT of the column cannot resolve the spectral tail below
    the noise floor), else the FFT spectrum.

    ``center=True`` (default) returns the density shifted by the constant
    -lml(exp(prior_mean)), accumulating per-frequency-bin DIFFERENCES against
    the spectrum at the prior mean before the reduction: at N = 2^20 the
    absolute lml is ~1e6 nats, which float32 resolves to ~0.06 nats, the
    order of an HMC energy error.  Samplers and optimizers are invariant to
    the shift.  ``prior_std=None`` drops the prior (the likelihood alone).
    """
    from gaussian_processes_tpu_torch.ops import toeplitz

    x, y = _data(x, y)
    mu, sd = _prior(prior_mean, 1.0 if prior_std is None else prior_std, x)
    n = y.shape[0]

    def spectrum_fn(theta_k, noise):
        return toeplitz.whittle_spectrum_params(kernel_template, theta_k, noise, x, jitter,
                                                spectrum)

    lml_of_theta = _whittle_terms(
        kernel_template, spectrum_fn, toeplitz.periodogram(y),
        toeplitz._rfft_multiplicity(n, y.dtype, y.device), n, mu=mu, center=center,
        dtype=y.dtype)
    return _whittle_density(lml_of_theta, kernel_template.n_params, mu,
                            None if prior_std is None else sd)


def make_log_posterior_whittle_kron(
    kernel_template: Kernel,
    op,
    y,
    *,
    prior_mean=0.0,
    prior_std=2.0,
    jitter: float = 0.0,
    center: bool = True,
    spectrum: str = "auto",
) -> LogDensity:
    """Log posterior over u = log(h, w_1..w_D, noise) with the D-dim torus
    Whittle likelihood (``ops/kronecker.py::whittle_log_marginal_kron``), for
    an ARD kernel on the Cartesian grid ``op`` (a ``KronOperator``).
    ``center=True`` applies the 1-D builder's float32-resolution fix."""
    from gaussian_processes_tpu_torch.ops import kronecker

    g = op.axes[0]
    y = torch.as_tensor(y, dtype=g.dtype, device=g.device)
    mu, sd = _prior(prior_mean, prior_std, g)
    n = op.n

    def spectrum_fn(theta_k, noise):
        return kronecker.kron_whittle_spectrum_params(
            kernel_template, theta_k, noise, op, jitter, spectrum)

    lml_of_theta = _whittle_terms(
        kernel_template, spectrum_fn, kronecker.fft_periodogram(y, op).reshape(-1),
        torch.ones((), dtype=y.dtype, device=y.device), n, mu=mu, center=center,
        dtype=y.dtype)
    return _whittle_density(lml_of_theta, kernel_template.n_params, mu, sd)


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
