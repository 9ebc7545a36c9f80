"""Exact GP with the kernel matrix built block by block over a 2-D grid of ranks.

Counterpart of ``gaussian_processes_tpu/parallel/distributed_gp.py``.  The
JAX package constrains K to P(i, j) over a 2-D mesh and leaves the
factorization to XLA, which gathers a sharded operand before its Cholesky
(``block_cholesky.py:4-7`` there).  The port does the same in the open:
each rank of the a x c grid builds its own (n / a, n / c) block of K with
kernel B1 (B6 for ARD over (n, D) inputs), the blocks are gathered over
the grid, and every rank factors and solves the whole K with
``models.gp.fit``'s own steps (``cholesky_blocked``, kernel B3, on a card).  So N is bounded by one
device here, as it is in the JAX package; beyond that the exact path is
``parallel.block_cholesky.fit_blockcyclic``, which never gathers K.

``make_grid_mesh`` splits the default process group into the grid (world
rank = i c + j) with ``torch.distributed.new_group``; every rank must call
it.  Uneven splits of n (and of the prediction points) follow
``torch.tensor_split``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.distributed as dist

from gaussian_processes_tpu_torch.models.base import Kernel
from gaussian_processes_tpu_torch.models import gp
from gaussian_processes_tpu_torch.models.gp import GPPosterior
from gaussian_processes_tpu_torch.ops.pairwise import pairwise_matrix, pairwise_matrix_ard
from gaussian_processes_tpu_torch.parallel.mesh import RankMesh, make_mesh
from gaussian_processes_tpu_torch.parallel.multihost import local_device
from gaussian_processes_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """An a x c grid of ranks: ``i`` (the ranks of this rank's grid column,
    varying i), ``j`` (of its grid row, varying j) and ``grid`` (all)."""

    i: RankMesh
    j: RankMesh
    grid: RankMesh

    @property
    def shape(self) -> Tuple[int, int]:
        return self.i.world_size, self.j.world_size

    def axis(self, name: str) -> RankMesh:
        for mesh in (self.i, self.j):
            if mesh.axis == name:
                return mesh
        raise ValueError(f"the grid's axes are {(self.i.axis, self.j.axis)}, not {name!r}")


def grid_shape(n_devices: int) -> Tuple[int, int]:
    """(a, n / a): the grid as square as possible, a <= n / a."""
    a = math.isqrt(n_devices)
    while n_devices % a:
        a -= 1
    return a, n_devices // a


def make_grid_mesh(n_devices: int | None = None, axes=("i", "j"), *, device=None) -> GridMesh:
    """The default process group (one device per rank) as the ``grid_shape``
    grid; ``n_devices``, when given, must equal its size.  An axis of one
    rank has no group and its collectives are the identity."""
    device = resolve_device(device) if device is not None else local_device()
    grid = make_mesh(n_devices, "grid", device=device)
    a, c = grid_shape(grid.world_size)
    groups = {}
    for name, n_axis, members in (
            (axes[0], a, [[ii * c + jj for ii in range(a)] for jj in range(c)]),
            (axes[1], c, [[ii * c + jj for jj in range(c)] for ii in range(a)])):
        if n_axis == 1:
            groups[name] = RankMesh(group=None, rank=0, world_size=1, device=device, axis=name)
            continue
        for ranks in members:  # new_group is collective: every rank makes every group
            group = dist.new_group(ranks)
            if grid.rank in ranks:
                groups[name] = RankMesh(group=group, rank=ranks.index(grid.rank),
                                        world_size=n_axis, device=device, axis=name)
    return GridMesh(i=groups[axes[0]], j=groups[axes[1]], grid=grid)


def _bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of part ``index`` of ``torch.tensor_split(range(n), parts)``."""
    q, r = divmod(n, parts)
    start = index * q + min(index, r)
    return start, start + q + (index < r)


def _gather_rows(mesh: RankMesh, t: torch.Tensor, n: int) -> torch.Tensor:
    """The ranks' ``tensor_split`` parts of an n-row tensor, concatenated:
    each part is padded to the largest for the collective and cut back."""
    width = -(-n // mesh.world_size)
    padded = t.new_zeros((width,) + t.shape[1:])
    padded[:t.shape[0]] = t
    parts = mesh.all_gather(padded[None])
    return torch.cat([parts[p, :q - s] for p, (s, q) in
                      enumerate(_bounds(n, mesh.world_size, p) for p in range(mesh.world_size))])


def fit_sharded(
    kernel: Kernel,
    x,
    y,
    noise,
    mesh: GridMesh,
    jitter: float = 1e-6,
    axes: Tuple[str, str] = ("i", "j"),
) -> GPPosterior:
    """Exact GP fit with K built in (i, j) blocks over the grid, then
    gathered and factored on every rank.  Matches ``models.gp.fit`` to
    round-off; every rank returns the same ``GPPosterior``.  ``noise`` is
    a scalar or per-point (n,) standard deviation, as in ``build_kxx``."""
    rows_mesh, cols_mesh = mesh.axis(axes[0]), mesh.axis(axes[1])
    device = mesh.grid.device
    x = torch.as_tensor(x).to(device)
    y = torch.as_tensor(y, dtype=x.dtype).to(device)
    noise = torch.as_tensor(noise, dtype=x.dtype).to(device)
    n = x.shape[0]
    if y.shape != (n,):
        raise ValueError(f"y has shape {tuple(y.shape)}; x has {n} points")
    a, c = rows_mesh.world_size, cols_mesh.world_size
    r0, r1 = _bounds(n, a, rows_mesh.rank)
    c0, c1 = _bounds(n, c, cols_mesh.rank)
    build = pairwise_matrix_ard if x.ndim == 2 else pairwise_matrix
    block = build(kernel, x[r0:r1], x[c0:c1])
    # the global diagonal t in [max(r0, c0), min(r1, c1)) sits at (t - r0, t - c0)
    lo, hi = max(r0, c0), min(r1, c1)
    if lo < hi:
        term = torch.square(noise) + jitter
        block.diagonal(offset=r0 - c0).add_(term[lo:hi] if term.ndim else term)
    # gathered over the grid in world order, rank = i c + j
    height, width = -(-n // a), -(-n // c)
    padded = block.new_zeros(height, width)
    padded[:r1 - r0, :c1 - c0] = block
    del block
    parts = mesh.grid.all_gather(padded[None])
    K = x.new_empty(n, n)
    for i in range(a):
        s0, s1 = _bounds(n, a, i)
        for j in range(c):
            t0, t1 = _bounds(n, c, j)
            K[s0:s1, t0:t1] = parts[i * c + j, :s1 - s0, :t1 - t0]
    del parts, padded
    L, alpha, lml = gp._factor_solve(K, y)
    return GPPosterior(kernel=kernel, x=x, y=y, noise=noise, L=L, alpha=alpha, log_marginal=lml)


def predict_diag_sharded(post: GPPosterior, xo, mesh: GridMesh, axes=("i", "j")):
    """Predictive mean and variance with the rows of K(xo, x) split over
    axis ``axes[0]``: each grid row computes its slice (kernel B1) against
    the replicated factor, and the slices are gathered; every rank returns
    the whole (m,) mean and variance."""
    rows_mesh = mesh.axis(axes[0])
    xo = torch.as_tensor(xo, dtype=post.x.dtype).to(post.x.device)
    m = xo.shape[0]
    s0, s1 = _bounds(m, rows_mesh.world_size, rows_mesh.rank)
    mean, var = gp.predict_diag(post, xo[s0:s1])
    return _gather_rows(rows_mesh, mean, m), _gather_rows(rows_mesh, var, m)
