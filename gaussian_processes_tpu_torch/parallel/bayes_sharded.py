"""Fully Bayesian hyperparameter inference with the data rows sharded.

Counterpart of ``gaussian_processes_tpu/parallel/bayes_sharded.py``: ChEES-HMC
on the deterministic PCG + SLQ surrogate of
``inference.gp_model.make_log_posterior_iterative``, each evaluation with
the n training rows split over the ranks of a data axis
(``parallel/iterative_sharded.py::_vg_local``: strip matvecs, the
row-sharded pivoted Cholesky, the Hutchinson gradient), so every rank's
value and gradient is the whole surrogate's.

Two layouts, one code path (``make_bayes_mesh``):

* chains replicated (a chain axis of one rank): every rank steps all C
  chains with the caller's generator, the same run as ``sample_chees`` on
  the unsharded surrogate up to reduction order;
* chains sharded over a chain axis as well (a 2-D layout of W = C_ranks x
  D_ranks processes, two families of ``new_group`` subgroups): the chain
  axis runs ``parallel/sharded.py``'s ChEES, its per-rank momentum
  generator and pooled adaptation, and each chain evaluation splits its
  rows over the data axis.

The surrogate's probes are frozen at build time (drawn once, in the order
of the unsharded surrogate, and sliced by rows), so all ranks sample one
deterministic log density.  It is a ``gp_model.LogDensity``: its autograd
rule's backward is the analytic gradient of ``_vg_local``, as the JAX
package's ``custom_vjp``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gaussian_processes_tpu_torch.inference import chees as chees_mod
from gaussian_processes_tpu_torch.inference import gp_model
from gaussian_processes_tpu_torch.ops import krylov
from gaussian_processes_tpu_torch.parallel import sharded
from gaussian_processes_tpu_torch.parallel.iterative_sharded import (
    _draw_vg_probes,
    _vg_local,
    make_row_mesh,
)
from gaussian_processes_tpu_torch.parallel.mesh import RankMesh, make_mesh
from gaussian_processes_tpu_torch.parallel.multihost import local_device
from gaussian_processes_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BayesMesh:
    """The (chain, data) layout: this rank's chain-axis and data-axis
    meshes.  World rank = chain index x D_ranks + data index."""

    chain: RankMesh
    data: RankMesh


def make_bayes_mesh(n_chain_devices: int = 1, n_data_devices: int | None = None,
                    chain_axis: str = "chain", data_axis: str = "i", *,
                    device=None) -> BayesMesh:
    """Split the default process group into a (chain, data) grid.  Every
    rank must call it (``new_group`` is collective).  An axis of one rank
    has no group and its collectives are the identity."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data_devices is None:
        n_data_devices = world // n_chain_devices
    if n_chain_devices * n_data_devices != world:
        raise ValueError(f"a {n_chain_devices} x {n_data_devices} layout needs "
                         f"{n_chain_devices * n_data_devices} ranks; the group has {world}")
    device = resolve_device(device) if device is not None else local_device()
    if n_chain_devices == 1 or n_data_devices == 1:
        full = make_mesh(None, chain_axis if n_data_devices == 1 else data_axis, device=device)
        one = RankMesh(group=None, rank=0, world_size=1, device=device,
                       axis=data_axis if n_data_devices == 1 else chain_axis)
        return (BayesMesh(chain=full, data=one) if n_data_devices == 1
                else BayesMesh(chain=one, data=full))
    rank = dist.get_rank()
    mine = {}
    for c in range(n_chain_devices):  # the data groups, one per chain index
        ranks = [c * n_data_devices + j for j in range(n_data_devices)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["data"] = make_mesh(None, data_axis, device=device, group=group)
    for j in range(n_data_devices):  # the chain groups, one per data index
        ranks = [c * n_data_devices + j for c in range(n_chain_devices)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["chain"] = make_mesh(None, chain_axis, device=device, group=group)
    return BayesMesh(**mine)


def make_log_posterior_iterative_datasharded(
    kernel_template,
    x,
    y,
    mesh: RankMesh | None = None,
    data_axis: str = "i",
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
) -> gp_model.LogDensity:
    """Data-sharded twin of ``make_log_posterior_iterative`` over u =
    log(theta, s): the global ``x``, ``y`` with this rank's rows taken from
    the data mesh, the probes frozen here from ``probe_generator`` (default
    seeded with ``gp_model.PROBE_SEED``; any source of draws) in the
    unsharded surrogate's order.  A (C, D) input is evaluated chain by
    chain, each evaluation one sharded PCG + SLQ solve whose collectives
    every rank of the data axis joins."""
    mesh = mesh if mesh is not None else make_row_mesh(axis=data_axis)
    x = torch.as_tensor(x).to(mesh.device)
    y = torch.as_tensor(y, dtype=x.dtype).to(mesh.device)
    n = x.shape[0]
    rows = mesh.block(n)
    mu, sd = gp_model._prior(prior_mean, prior_std, x)
    P = kernel_template.n_params
    if probe_generator is None:
        probe_generator = torch.Generator().manual_seed(gp_model.PROBE_SEED)
    probes, xi1, xi2 = _draw_vg_probes(krylov.as_draws(probe_generator), n, num_probes,
                                       precond_rank, y.dtype, x.device)
    local = (x, x[rows], y[rows], probes[rows], xi1, xi2[rows])
    opts = dict(num_probes=num_probes, num_iters=num_iters, tol=tol, jitter=jitter,
                block_size=block_size, precond_rank=precond_rank)

    def one(u):
        theta = torch.exp(u)
        lml, g_theta = _vg_local(kernel_template.with_params(theta[:P]), *local, theta[P],
                                 mesh, **opts)
        z = (u - mu) / sd
        return lml - 0.5 * torch.sum(z * z), g_theta * theta - z / sd

    def value_and_grad(U):
        values, grads = zip(*(one(row) for row in U))
        return torch.stack(values), torch.stack(grads)

    return gp_model.LogDensity(value_and_grad)


def sample_chees_iterative_sharded(
    kernel_template,
    x,
    y,
    init_position,
    generator=None,
    *,
    mesh: BayesMesh | None = None,
    probe_generator=None,
    prior_mean=0.0,
    prior_std=2.0,
    num_probes: int = 8,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    num_warmup: int = 500,
    num_samples: int = 1000,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
):
    """ChEES-HMC on the matrix-free surrogate with the data rows sharded.

    ``init_position`` is the global (C, P+1) chain block over u = log(kernel
    params..., s).  With a chain axis of one rank the chains are replicated
    and the run is ``sample_chees``'s (a ``CheesResult``); with more, the
    chain axis must divide C, the chains split over it as in
    ``sample_chees_sharded`` (a ``ShardedCheesResult``, positions gathered
    to (S, C, D)).
    """
    mesh = mesh if mesh is not None else make_bayes_mesh()
    log_post = make_log_posterior_iterative_datasharded(
        kernel_template, x, y, mesh.data, probe_generator=probe_generator,
        prior_mean=prior_mean, prior_std=prior_std, num_probes=num_probes,
        num_iters=num_iters, tol=tol, jitter=jitter, block_size=block_size,
        precond_rank=precond_rank)
    init_position = torch.as_tensor(init_position).to(mesh.data.device)
    if mesh.chain.world_size == 1:
        return chees_mod.sample_chees(
            log_post, init_position, generator, num_warmup, num_samples,
            init_step_size=init_step_size, init_traj_length=init_traj_length,
            target_accept=target_accept, max_leapfrog=max_leapfrog)
    return sharded.sample_chees_sharded(
        log_post, init_position, generator, mesh=mesh.chain, num_warmup=num_warmup,
        num_samples=num_samples, init_step_size=init_step_size,
        init_traj_length=init_traj_length, target_accept=target_accept,
        max_leapfrog=max_leapfrog)
