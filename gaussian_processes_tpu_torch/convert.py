"""Conversion from the JAX package's values to the port's objects.

The JAX package's kernels and posteriors are turned into numpy arrays by the
caller (``np.asarray(kernel.params)``, ``np.asarray(post.L)``, ...); these
helpers copy them into the port's counterparts, so both packages can
compute the same thing on the same values.  Nothing here imports JAX.

A kernel is named by its family and parameters, or by a spec: a leaf
``(family, params)`` or a tree ``("sum" | "prod", left_spec, right_spec)``,
so that a JAX ``ProductKernel(GaussianKernel, PeriodicKernel)`` becomes
``("prod", ("se", [h1, w1]), ("periodic", [h2, w2, p2]))``.  The structured
operators (``KronOperator``, ``SKIOperator``, ``SKIKronOperator``), the
SGPR, Laplace and block-cyclic posteriors (one rank's strip) and the
samplers' states (NUTS, ChEES, chain-sharded NUTS) come from their arrays
as well.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_processes_tpu_torch.models.ard import ARDGaussianKernel
from gaussian_processes_tpu_torch.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu_torch.models.gaussian import GaussianKernel
from gaussian_processes_tpu_torch.models.gp import GPPosterior
from gaussian_processes_tpu_torch.models.iterative_gp import IterativePosterior
from gaussian_processes_tpu_torch.models.matern import Matern32Kernel, Matern52Kernel
from gaussian_processes_tpu_torch.models.periodic import PeriodicKernel
from gaussian_processes_tpu_torch.models.rq import RationalQuadraticKernel

#: kernel family names, as in ``utils.config.KernelConfig.family``, and
#: "ard" for ``ARDGaussianKernel`` (params (h, w_1..w_D))
FAMILIES = {"se": GaussianKernel, "periodic": PeriodicKernel, "matern32": Matern32Kernel,
            "matern52": Matern52Kernel, "rq": RationalQuadraticKernel,
            "ard": ARDGaussianKernel}
#: the tree nodes of a spec
COMBINATORS = {"sum": SumKernel, "prod": ProductKernel}


def kernel_from_numpy(family: str, params, *, device="cpu",
                      dtype=torch.float64):
    """The port's kernel of ``family`` with hyperparameters ``params`` (P,)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; one of {list(FAMILIES)}")
    theta = torch.as_tensor(np.array(params), dtype=dtype, device=device)
    return FAMILIES[family].from_params(theta)


def kernel_from_spec(spec, *, device="cpu", dtype=torch.float64):
    """The port's kernel of a spec: ``(family, params)`` for a leaf,
    ``("sum" | "prod", left, right)`` for a tree."""
    if spec[0] in COMBINATORS:
        _, left, right = spec
        return COMBINATORS[spec[0]](kernel_from_spec(left, device=device, dtype=dtype),
                                    kernel_from_spec(right, device=device, dtype=dtype))
    family, params = spec
    return kernel_from_numpy(family, params, device=device, dtype=dtype)


def _kernel(family, params, device, dtype):
    """``family`` with ``params``, or the spec ``family`` when params is None."""
    if params is None:
        return kernel_from_spec(family, device=device, dtype=dtype)
    return kernel_from_numpy(family, params, device=device, dtype=dtype)


def posterior_from_numpy(family, params, x, y, noise, L, alpha,
                         log_marginal, *, device="cpu",
                         dtype=torch.float64) -> GPPosterior:
    """The port's ``GPPosterior`` from the arrays of a JAX ``GPPosterior``;
    the kernel is ``family`` with ``params``, or the spec ``family`` with
    ``params`` None."""

    def t(v):
        return torch.as_tensor(np.array(v), dtype=dtype, device=device)

    return GPPosterior(
        kernel=_kernel(family, params, device, dtype),
        x=t(x), y=t(y), noise=t(noise), L=t(L), alpha=t(alpha),
        log_marginal=t(log_marginal),
    )


def blockcyclic_posterior_from_numpy(family, params, x, y, noise, L_blocks, alpha,
                                     log_marginal, *, block_size, rank, world_size,
                                     device="cpu", dtype=torch.float64):
    """This rank's ``BlockCyclicPosterior`` from the arrays of a JAX one:
    its global (m, m, b, b) ``L_blocks`` has the rows grouped by owner
    (device d's rows are [d m_loc, (d + 1) m_loc)), and rank ``rank`` of
    ``world_size`` takes its (m_loc b, m b) strip.  The kernel as in
    ``posterior_from_numpy``."""
    from gaussian_processes_tpu_torch.parallel.block_cholesky import BlockCyclicPosterior

    blocks = np.asarray(L_blocks)
    m, b = blocks.shape[0], blocks.shape[2]
    if blocks.shape != (m, m, b, b) or b != block_size or m % world_size:
        raise ValueError(f"L_blocks of shape {blocks.shape} is not ({m}, {m}, {block_size}, "
                         f"{block_size}) with {world_size} dividing {m}")
    m_loc = m // world_size
    own = blocks[rank * m_loc:(rank + 1) * m_loc].transpose(0, 2, 1, 3).reshape(m_loc * b, m * b)

    def t(v):
        return _tensor(v, device, dtype)

    return BlockCyclicPosterior(
        kernel=_kernel(family, params, device, dtype), x=t(x), y=t(y), noise=t(noise),
        L_blocks=t(own), alpha=t(alpha), log_marginal=t(log_marginal), block_size=b,
        n_blocks=m, world_size=world_size)


def iterative_posterior_from_numpy(family, params, x, y, noise, alpha,
                                   log_marginal, solve_residual, num_probes,
                                   num_iters, *, device="cpu",
                                   dtype=torch.float64) -> IterativePosterior:
    """The port's ``IterativePosterior`` from the arrays of a JAX one; the
    kernel as in ``posterior_from_numpy``."""

    def t(v):
        return torch.as_tensor(np.array(v), dtype=dtype, device=device)

    return IterativePosterior(
        kernel=_kernel(family, params, device, dtype),
        x=t(x), y=t(y), noise=t(noise), alpha=t(alpha),
        log_marginal=t(log_marginal), solve_residual=t(solve_residual),
        num_probes=int(num_probes), num_iters=int(num_iters),
    )


def sgpr_posterior_from_numpy(family, params, z, T_uu, V_B, lam_B, c, noise, log_marginal,
                              trace_gap, *, device="cpu", dtype=torch.float64):
    """The port's ``SGPRPosterior`` from the arrays of a JAX one; the kernel
    as in ``posterior_from_numpy``."""
    from gaussian_processes_tpu_torch.models.sgpr import SGPRPosterior

    def t(v):
        return _tensor(v, device, dtype)

    return SGPRPosterior(kernel=_kernel(family, params, device, dtype), z=t(z), T_uu=t(T_uu),
                         V_B=t(V_B), lam_B=t(lam_B), c=t(c), noise=t(noise),
                         log_marginal=t(log_marginal), trace_gap=t(trace_gap))


def laplace_posterior_from_numpy(family, params, likelihood, x, y, f_hat, sqrt_w, L_B, a_hat,
                                 grad_lik, log_marginal, newton_deltas, *, device="cpu",
                                 dtype=torch.float64):
    """The port's ``LaplacePosterior`` from the arrays of a JAX one;
    ``likelihood`` is the port's (``LogisticLikelihood()``,
    ``PoissonLikelihood(binsize)``), the kernel as in
    ``posterior_from_numpy``."""
    from gaussian_processes_tpu_torch.models.classify import LaplacePosterior

    def t(v):
        return _tensor(v, device, dtype)

    return LaplacePosterior(kernel=_kernel(family, params, device, dtype), likelihood=likelihood,
                            x=t(x), y=t(y), f_hat=t(f_hat), sqrt_w=t(sqrt_w), L_B=t(L_B),
                            a_hat=t(a_hat), grad_lik=t(grad_lik), log_marginal=t(log_marginal),
                            newton_deltas=t(newton_deltas))


def _tensor(v, device, dtype):
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def kron_operator_from_numpy(axes, *, device="cpu", dtype=torch.float64):
    """The port's ``KronOperator`` from a JAX one's per-dimension grids."""
    from gaussian_processes_tpu_torch.ops.kronecker import KronOperator

    return KronOperator(axes=tuple(_tensor(g, device, dtype) for g in axes))


def ski_operator_from_numpy(grid, idx, w, *, device="cpu", dtype=torch.float64):
    """The port's ``SKIOperator`` from a JAX one's ``grid``, ``idx`` and ``w``
    (its scatter table is built from them)."""
    from gaussian_processes_tpu_torch.ops.ski import SKIOperator

    return SKIOperator(grid=_tensor(grid, device, dtype),
                       idx=_tensor(idx, device, torch.int64), w=_tensor(w, device, dtype))


def ski_kron_operator_from_numpy(axes, idx, w, *, device="cpu", dtype=torch.float64):
    """The port's ``SKIKronOperator`` from a JAX one's ``kron.axes``, ``idx``
    (n, D) and ``w`` (n, 4, D)."""
    from gaussian_processes_tpu_torch.ops.ski import SKIKronOperator

    return SKIKronOperator(kron=kron_operator_from_numpy(axes, device=device, dtype=dtype),
                           idx=_tensor(idx, device, torch.int64), w=_tensor(w, device, dtype))


# ---------------------------------------------------------------------------
# Sampler states (NUTS, ChEES; sharded or not)
#
# A sampler state travels as a flat dict of numpy arrays: the chain block
# ``z``, ``logp``, ``grad``; the dual averaging ``da_log_step``,
# ``da_log_avg_step``, ``da_avg_error``, ``da_count``, ``da_mu``; the Welford
# moments ``welford_mean``, ``welford_m2``, ``welford_count``; ``inv_mass``,
# ``step_size``; and for ChEES ``traj_length``, ``traj_m``, ``traj_v``,
# ``traj_count``.  The JAX package's states carry PRNG keys, the port's
# generators: the random stream does not cross, the caller supplies it.

_CHEES_FIELDS = ("traj_length", "traj_m", "traj_v", "traj_count")


def _sampler_parts(arrays, device, dtype):
    from gaussian_processes_tpu_torch.inference import adaptation as adapt
    from gaussian_processes_tpu_torch.inference.nuts import ChainState

    def t(name):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)

    return dict(
        chains=ChainState(z=t("z"), logp=t("logp"), grad=t("grad")),
        da=adapt.DualAveragingState(log_step=t("da_log_step"),
                                    log_avg_step=t("da_log_avg_step"),
                                    avg_error=t("da_avg_error"),
                                    count=int(arrays["da_count"]), mu=t("da_mu")),
        welford=adapt.WelfordState(mean=t("welford_mean"), m2=t("welford_m2"),
                                   count=t("welford_count")),
        inv_mass=t("inv_mass"), step_size=t("step_size"))


def sampler_state_from_numpy(arrays, generator, *, sharded: bool = False, device="cpu",
                             dtype=torch.float64):
    """The port's NUTS ``SamplerState`` (``parallel.ShardedNUTSState`` when
    ``sharded``) from the flat dict of arrays, drawing from ``generator``."""
    from gaussian_processes_tpu_torch.inference.nuts import SamplerState
    from gaussian_processes_tpu_torch.parallel.sharded import ShardedNUTSState

    cls = ShardedNUTSState if sharded else SamplerState
    return cls(**_sampler_parts(arrays, device, dtype), generator=generator)


def chees_state_from_numpy(arrays, generator, momentum_generator=None, *, device="cpu",
                           dtype=torch.float64):
    """The port's ``CheesState`` from the flat dict of arrays; ``generator``
    draws the jitter, ``momentum_generator`` (None: ``generator``) the
    momenta, as in a chain-sharded run."""
    from gaussian_processes_tpu_torch.inference.chees import CheesState

    def t(name):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)

    return CheesState(**_sampler_parts(arrays, device, dtype),
                      traj_length=t("traj_length"), traj_m=t("traj_m"), traj_v=t("traj_v"),
                      traj_count=int(arrays["traj_count"]), generator=generator,
                      momentum_generator=momentum_generator)


def sampler_state_to_numpy(state) -> dict:
    """The flat dict of arrays of a port NUTS or ChEES state (its generators
    left out): the inverse of the two functions above."""

    def a(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    out = {"z": a(state.chains.z), "logp": a(state.chains.logp), "grad": a(state.chains.grad),
           "da_log_step": a(state.da.log_step), "da_log_avg_step": a(state.da.log_avg_step),
           "da_avg_error": a(state.da.avg_error), "da_count": a(state.da.count),
           "da_mu": a(state.da.mu), "welford_mean": a(state.welford.mean),
           "welford_m2": a(state.welford.m2), "welford_count": a(state.welford.count),
           "inv_mass": a(state.inv_mass), "step_size": a(state.step_size)}
    if hasattr(state, "traj_length"):
        out.update({name: a(getattr(state, name)) for name in _CHEES_FIELDS})
    return out
