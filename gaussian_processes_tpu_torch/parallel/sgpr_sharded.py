"""Data-sharded SGPR over a process group.

Counterpart of ``gaussian_processes_tpu/parallel/sgpr_sharded.py``: the n
training rows are split over the ranks of a ``RankMesh`` and each rank runs
the blocked moment sweep of ``models/sgpr.py`` (``_sweep``: kernel B1's
cross block K(z, x_j) on a card, then GEMMs) on its own rows.  One
``all_reduce`` of the four accumulators (C (m, m), b (m,), y^T y, tr K_ff)
is the only communication, O(m^2) bytes whatever n; the (m, m) tail then
runs on every rank through the same ``_fit_from_moments`` /
``_elbo_from_moments``, so the sharded results equal the single-process
ones up to the order of the sum.

Gradients: the bound is differentiable in the kernel's parameters, the
noise and z.  The moments' sum is an autograd rule whose backward passes
the (replicated) cotangent through unchanged, and the parameters enter the
sweep through a rule whose backward sums the ranks' gradients, once; Kuu
and the tail use the parameters directly.  So each rank's gradient is the
whole bound's, not W times it (``torch.distributed.nn``'s all_reduce would
sum the cotangent in its backward and scale the sweep's part by W).
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.models import sgpr as sgpr_mod
from gaussian_processes_tpu_torch.models.sgpr import SGPRPosterior
from gaussian_processes_tpu_torch.parallel.iterative_sharded import make_row_mesh
from gaussian_processes_tpu_torch.parallel.mesh import RankMesh


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over the ranks.  Backward: the cotangent as it is
    (the loss downstream is the same on every rank)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.psum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradsOverRanks(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradients of the ranks' local
    contributions summed over the ranks."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g), None


def _prep(x, y, z, mesh, axis):
    mesh = mesh if mesh is not None else make_row_mesh(axis=axis)
    x = torch.as_tensor(x).to(mesh.device)
    y = torch.as_tensor(y, dtype=x.dtype).to(mesh.device)
    z = torch.as_tensor(z).to(device=mesh.device)
    return x, y, z, mesh, mesh.block(y.shape[0])


def _moments_sharded(kernel, x, y, z, rows, mesh: RankMesh, block_size, jitter):
    """(Kuu, C, b, y^T y, tr K_ff): the sweep over this rank's rows, summed
    over the ranks; Kuu built on every rank."""
    theta = kernel.params
    flat = _SumGradsOverRanks.apply(torch.cat([theta, z.reshape(-1).to(theta.dtype)]), mesh)
    k_rows = kernel.with_params(flat[:theta.shape[0]])
    z_rows = flat[theta.shape[0]:].reshape(z.shape).to(z.dtype)
    moments = sgpr_mod._sweep(k_rows, x[rows], y[rows], z_rows, block_size)
    C, bv, yty, trk = (_SumOverRanks.apply(t, mesh) for t in moments)
    m = z.shape[0]
    Kuu = kernel(z, z) + jitter * torch.eye(m, dtype=y.dtype, device=y.device)
    return Kuu, C, bv, yty, trk


def fit_sgpr_sharded(kernel, x, y, noise, z, *, mesh: RankMesh | None = None, axis: str = "i",
                     block_size: int = 8192, jitter: float = 0.0,
                     rank_tol: float | None = None) -> SGPRPosterior:
    """``models.sgpr.fit_sgpr`` with the moment sweep split over the ranks
    (W must divide n); every rank returns the whole (m, m) posterior."""
    x, y, z, mesh, rows = _prep(x, y, z, mesh, axis)
    noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
    if rank_tol is None:
        rank_tol = sgpr_mod._default_rank_tol(y.dtype)
    Kuu, C, bv, yty, trk = _moments_sharded(kernel, x, y, z, rows, mesh, block_size, jitter)
    return sgpr_mod._fit_from_moments(kernel, z, noise, y.shape[0], Kuu, C, bv, yty, trk,
                                      torch.square(noise), rank_tol)


def elbo_sgpr_sharded(kernel, x, y, noise, z, *, mesh: RankMesh | None = None, axis: str = "i",
                      block_size: int = 8192, jitter: float = 0.0,
                      rank_tol: float | None = None) -> torch.Tensor:
    """The collapsed bound with the sweep split over the ranks,
    differentiable in (kernel params, noise, z) as ``models.sgpr.elbo_sgpr``;
    every rank holds the same value and, after backward, the same
    gradient."""
    x, y, z, mesh, rows = _prep(x, y, z, mesh, axis)
    noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
    if rank_tol is None:
        rank_tol = sgpr_mod._default_rank_tol(y.dtype)
    Kuu, C, bv, yty, trk = _moments_sharded(kernel, x, y, z, rows, mesh, block_size, jitter)
    return sgpr_mod._elbo_from_moments(y.shape[0], Kuu, C, bv, yty, trk, torch.square(noise),
                                       rank_tol)


def fit_sgpr_mle_sharded(kernel_template, x, y, noise_init, z0, *,
                         mesh: RankMesh | None = None, axis: str = "i",
                         learn_inducing: bool = False, num_steps: int = 200,
                         learning_rate: float = 0.05, block_size: int = 8192,
                         jitter: float = 0.0, rank_tol: float | None = None):
    """``models.sgpr.fit_sgpr_mle`` with every evaluation of the bound
    row-sharded: Adam over u = (log kernel params, log noise[, z]).  Returns
    (SGPRPosterior at the best iterate, losses)."""
    from gaussian_processes_tpu_torch.inference import gp_model
    from gaussian_processes_tpu_torch.inference.mle import _run_opt

    x, y, z0, mesh, _ = _prep(x, y, z0, mesh, axis)
    z0 = z0.to(x.dtype)
    P = kernel_template.n_params
    u0 = gp_model.pack(kernel_template, noise_init).to(dtype=x.dtype, device=x.device)
    if learn_inducing:
        u0 = torch.cat([u0, z0.reshape(-1)])
    opts = dict(block_size=block_size, jitter=jitter, rank_tol=rank_tol, mesh=mesh)

    def loss_and_grad(u):
        value, grad = sgpr_mod._elbo_value_and_grad(kernel_template, x, y, z0, u, opts,
                                                    learn_inducing, bound=elbo_sgpr_sharded)
        return -value, -grad

    best_u, _, losses = _run_opt(loss_and_grad, u0, "adam", learning_rate, num_steps)
    kernel, noise = gp_model.unpack(kernel_template, best_u[:P + 1])
    z = best_u[P + 1:].reshape(z0.shape) if learn_inducing else z0
    return fit_sgpr_sharded(kernel, x, y, noise, z, **opts), losses
