"""Distributed blocked Cholesky: row-block-cyclic over the ranks of a mesh.

Counterpart of ``gaussian_processes_tpu/parallel/block_cholesky.py``, the
exact GP fit whose N is not bounded by one device: each rank holds its
N^2 / W share of K plus one N x b panel, and K is never gathered.

Layout: N is padded to n_pad = m b with W dividing m; rank r owns the global
row blocks g = r + l W (l < m_loc = m / W), block-cyclic so that late panels
still spread over every rank.  They are kept as one row-major (m_loc b,
n_pad) strip, kernel B1's output K(x_own, x_pad) used as it is: the strip
seen through ``view(m_loc, b, m, b)`` is the JAX package's (m_loc, m, b, b)
block array.  The padded rows and columns are zeroed and the diagonal gets
s^2 + jitter on valid entries and 1 on padded ones, all in place, so the
factorization and the solves pass through the padding as identity blocks.

Right-looking factorization, a host loop over k = 0..m-1 with no host
synchronisation inside it:

  1. the diagonal block is replicated with one ``psum`` of the owner's
     copy and factored on every rank by ``cholesky_blocked`` (kernel B3 on
     its 128-wide tiles); the owner writes L_kk over its block;
  2. the owned rows strictly below k (a contiguous suffix of the strip)
     solve L_gk = A_gk L_kk^-T in place;
  3. ``all_gather`` of those panels (contiguous copies; zeros for g <= k)
     gives the column-k panel in global order;
  4. the trailing update A_gj -= L_gk L_jk^T on the owned rows below k, in
     place, as a staircase of ``STAIRCASE_PIECES`` GEMMs: each piece of
     rows stops at the diagonal of its last row block, so the update does
     about N^3 / 3 flops ((1 + 1 / pieces) times the triangle's) where the
     JAX package's every-block einsum does 2 N^3 and a rectangle over the
     columns right of k 2 N^3 / 3.  Blocks right of a row's diagonal are
     left partly updated and are never read.

The log-determinant is the ``psum`` of the owned diagonal blocks' log
diagonals; alpha = K^-1 y and the predictive variance's L^-1 K(x, xo) come
from blocked substitutions.  Each solve first inverts this rank's diagonal
blocks (``_diagonal_inverses``, a few batched launches), so every step is
GEMMs: Y_k = L_kk^-1 rhs_k - L_kk^-1 (sum_{j<k} L_kj Y_j), the first term
for all owned blocks in one batched product up front, the second two GEMMs
a step.  Across ranks a step takes one ``psum``: of the owner's Y_k going
forward, of the owner's L_kk^-T beside every rank's partial sum going back.
Float32 products run in full float32 (the package's precision policy,
utils/device.py).
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_processes_tpu_torch.models.base import Kernel
from gaussian_processes_tpu_torch.models.gp import _LOG_2PI
from gaussian_processes_tpu_torch.ops.blocked_cholesky import cholesky_blocked
from gaussian_processes_tpu_torch.ops.pairwise import pairwise_matrix
from gaussian_processes_tpu_torch.parallel.mesh import RankMesh
from gaussian_processes_tpu_torch.utils.profiling import counts, span

#: GEMMs per trailing update; the staircase covers (1 + 1 / pieces) times
#: the lower triangle's area
STAIRCASE_PIECES = 8


@dataclasses.dataclass(frozen=True)
class BlockCyclicPosterior:
    """Exact-GP posterior with the Cholesky factor left distributed.

    ``L_blocks`` is this rank's factored (m_loc b, n_pad) strip: its row
    block l is global row block g = rank + l W, and the blocks at or left
    of the diagonal (j <= g) hold L.  The JAX package's field is the global
    (m, m, b, b) array, sharded on its first axis with the rows grouped by
    owner; ``convert.blockcyclic_posterior_from_numpy`` cuts this rank's
    strip from it.  ``alpha`` (n,) and ``log_marginal`` are replicated;
    ``block_size`` (b), ``n_blocks`` (m) and ``world_size`` (W) are the
    geometry the predictions need.
    """

    kernel: Kernel
    x: torch.Tensor
    y: torch.Tensor
    noise: torch.Tensor
    L_blocks: torch.Tensor
    alpha: torch.Tensor
    log_marginal: torch.Tensor
    block_size: int
    n_blocks: int
    world_size: int


def _padded_dims(n: int, world: int, block_size: int):
    """(m, n_pad): the number of row/column blocks and the padded size."""
    chunk = world * block_size
    n_pad = -(-n // chunk) * chunk
    return n_pad // block_size, n_pad


def _check_mesh(mesh: RankMesh, axis: str) -> None:
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def _diagonal_blocks(S: torch.Tensor, rank: int, world: int, b: int) -> torch.Tensor:
    """The (m_loc, b, b) view of the strip's blocks on the global diagonal:
    block l is S[l b:(l + 1) b, g b:(g + 1) b] with g = rank + l W."""
    rows, n_pad = S.shape
    return S.as_strided((rows // b, b, b), (b * n_pad + world * b, n_pad, 1),
                        S.storage_offset() + rank * b)


def _build_strip(kernel, x_pad, n, b, m, noise, jitter, rank, world) -> torch.Tensor:
    """This rank's rows of K + (s^2 + jitter) I with identity padding."""
    with span("gp.factor.build_strip"):
        m_loc = m // world
        x_own = x_pad.view(m_loc, world, b)[:, rank].reshape(-1)
        # the JAX package falls back to kernel(x_own, x_pad) on TypeError; here
        # Kernel.forward is pairwise_matrix, so such a kernel raises either way
        S = pairwise_matrix(kernel, x_own, x_pad)
        S[:, n:].zero_()
        # only the last local block can hold padded rows: the padding is shorter
        # than W blocks, which belong to W different ranks
        first = n - (rank + (m_loc - 1) * world) * b
        if first < b:
            S[(m_loc - 1) * b + max(first, 0):].zero_()
        g = rank + torch.arange(m_loc, device=S.device) * world
        valid = (g[:, None] * b + torch.arange(b, device=S.device)) < n
        _diagonal_blocks(S, rank, world, b).diagonal(dim1=1, dim2=2).add_(
            torch.where(valid, torch.square(noise) + jitter, 1.0))
        return S


def _factor(S: torch.Tensor, mesh: RankMesh, m: int, b: int) -> None:
    """Right-looking block-cyclic Cholesky of the strip, in place."""
    with span("gp.factor.cholesky"):
        world, rank = mesh.world_size, mesh.rank
        m_loc = m // world
        for k in range(m):
            kc = slice(k * b, (k + 1) * b)
            mine, l_k = k % world == rank, k // world
            diag = S[l_k * b:(l_k + 1) * b, kc]
            Lkk = cholesky_blocked(mesh.psum(diag if mine else S.new_zeros(b, b)))
            if mine:
                diag.copy_(Lkk)
            # the owned rows strictly below k: local blocks l >= l0
            l0 = (k - rank) // world + 1
            panel = S[l0 * b:, kc]
            if panel.shape[0]:
                panel.copy_(torch.linalg.solve_triangular(Lkk.mT, panel, upper=True, left=False))
            # every rank sends its blocks l >= lg (those of some rank lie below
            # k), zeroing the one (l0 - lg <= 1) at or above k
            lg = (k + 1) // world
            if lg == m_loc:  # k = m - 1: nothing below
                break
            send = S[lg * b:, kc].clone()
            send[:(l0 - lg) * b] = 0
            gathered = mesh.all_gather(send).view(world, m_loc - lg, b, b)
            below = gathered.transpose(0, 1).reshape(-1, b)[(k + 1 - lg * world) * b:]
            _staircase(S, panel, below, k, l0, rank, world, b)


def _staircase(S, panel, below, k, l0, rank, world, b) -> None:
    """A_gj -= L_gk L_jk^T for the owned rows g > k (``panel``) and the
    columns k < j <= g, ``below`` the global panel's rows g > k."""
    n_rows = S.shape[0] // b - l0
    pieces = min(STAIRCASE_PIECES, n_rows)
    c0 = (k + 1) * b
    for i in range(pieces):
        la, lb = l0 + i * n_rows // pieces, l0 + (i + 1) * n_rows // pieces
        c1 = (rank + (lb - 1) * world + 1) * b  # the diagonal of the piece's last block
        S[la * b:lb * b, c0:c1].addmm_(panel[(la - l0) * b:(lb - l0) * b],
                                       below[:c1 - c0].mT, alpha=-1.0)


def _diagonal_inverses(S: torch.Tensor, rank: int, world: int, b: int) -> torch.Tensor:
    """(m_loc, b, b): the inverses of the strip's diagonal blocks L_kk.

    Recursive doubling on the whole stack at once: the diagonal's reciprocal
    inverts the 1 x 1 blocks, then each level joins two inverted halves,
    [[A, 0], [C, D]]^-1 = [[A^-1, 0], [-D^-1 C A^-1, D^-1]], with two batched
    products over every 2h-block of every L_kk.  An odd factor of b is left
    to one batched triangular solve of the base blocks."""
    inv = torch.tril(_diagonal_blocks(S, rank, world, b))
    m_loc = inv.shape[0]
    counts["solve.diag_inverses"] += m_loc

    def tiles(e):  # the diagonal e x e tiles of every block, (m_loc, b / e, e, e)
        return inv.as_strided((m_loc, b // e, e, e), (b * b, e * (b + 1), b, 1))

    h = b // (b & -b)  # b = h 2^j: the doubling starts from the h x h tiles
    if h == 1:
        inv.diagonal(dim1=1, dim2=2).reciprocal_()
    else:
        eye = torch.eye(h, dtype=inv.dtype, device=inv.device)
        tiles(h).copy_(torch.linalg.solve_triangular(tiles(h), eye, upper=False))
    while h < b:
        pairs = tiles(2 * h)
        pair = pairs.reshape(-1, 2 * h, 2 * h)  # a copy, except at the top level
        x = torch.bmm(torch.bmm(pair[:, h:, h:], pair[:, h:, :h]), pair[:, :h, :h])
        torch.neg(x.view(pairs[..., h:, :h].shape), out=pairs[..., h:, :h])
        h *= 2
    return inv


def _forward_solve(S, rhs, mesh: RankMesh, m: int, b: int) -> torch.Tensor:
    """L Y = rhs for the (n_pad, r) right-hand side, replicated."""
    with span("gp.solve.forward"):
        world, rank = mesh.world_size, mesh.rank
        inv = _diagonal_inverses(S, rank, world, b)
        r = rhs.shape[1]
        # L_kk^-1 rhs_k of the owned blocks; at one rank this is Y's buffer
        own = torch.bmm(inv, rhs.reshape(m // world, world, b, r)[:, rank])
        Y = own.view(-1, r) if world == 1 else rhs.new_empty(rhs.shape)
        for k in range(m):
            l, mine = k // world, k % world == rank
            if mine and k:
                own[l].addmm_(inv[l], S[l * b:(l + 1) * b, :k * b] @ Y[:k * b], alpha=-1.0)
            if world > 1:
                Y[k * b:(k + 1) * b] = mesh.psum(own[l] if mine else own.new_zeros(b, r))
        return Y


def _backward_solve(S, Ybar, mesh: RankMesh, m: int, b: int) -> torch.Tensor:
    """L^T Z = Ybar from the bottom; each rank sums its owned rows below k."""
    with span("gp.solve.backward"):
        world, rank = mesh.world_size, mesh.rank
        inv_t = _diagonal_inverses(S, rank, world, b).mT
        r = Ybar.shape[1]
        if world == 1:
            Z = torch.bmm(inv_t, Ybar.reshape(m, b, r))
            for k in reversed(range(m - 1)):
                below = S[(k + 1) * b:, k * b:(k + 1) * b].mT @ Z[k + 1:].view(-1, r)
                Z[k].addmm_(inv_t[k], below, alpha=-1.0)
            return Z.view(-1, r)
        Z = Ybar.clone()
        Z_own = Z.view(m // world, world, b, r)[:, rank]
        for k in reversed(range(m)):
            kc = slice(k * b, (k + 1) * b)
            buf = Z.new_zeros(b, b + r)  # [L_kk^-T from the owner | sum_{g>k} L_gk^T Z_g]
            if k % world == rank:
                buf[:, :b] = inv_t[k // world]
            l0 = (k - rank) // world + 1
            if l0 < Z_own.shape[0]:
                buf[:, b:] = S[l0 * b:, kc].mT @ Z_own[l0:].reshape(-1, r)
            buf = mesh.psum(buf)
            Z[kc] = buf[:, :b] @ (Z[kc] - buf[:, b:])
        return Z


def fit_blockcyclic(
    kernel: Kernel,
    x,
    y,
    noise,
    mesh: RankMesh,
    axis: str = "shard",
    block_size: int = 256,
    jitter: float = 1e-5,
) -> BlockCyclicPosterior:
    """Exact GP fit at large N without K on any rank: each rank holds its
    N^2 / W strip and one N x b panel.  Called by every rank of ``mesh``
    with the global 1-D ``x``, ``y`` and a scalar ``noise``; runs on the
    mesh's device.  Matches ``models.gp.fit`` to round-off."""
    with span("gp.entry.fit_blockcyclic"):
        _check_mesh(mesh, axis)
        x = torch.as_tensor(x).to(mesh.device)
        y = torch.as_tensor(y, dtype=x.dtype).to(mesh.device)
        noise = torch.as_tensor(noise, dtype=x.dtype).to(mesh.device)
        if x.ndim != 1 or y.shape != x.shape or noise.ndim != 0:
            raise ValueError("fit_blockcyclic takes 1-D x, y of its shape and a scalar noise, got "
                             f"x {tuple(x.shape)}, y {tuple(y.shape)}, noise {tuple(noise.shape)}")
        n, b, world = x.shape[0], block_size, mesh.world_size
        m, n_pad = _padded_dims(n, world, b)
        x_pad, y_pad = x.new_zeros(n_pad), y.new_zeros(n_pad)
        x_pad[:n], y_pad[:n] = x, y

        S = _build_strip(kernel, x_pad, n, b, m, noise, jitter, mesh.rank, world)
        _factor(S, mesh, m, b)
        diag = _diagonal_blocks(S, mesh.rank, world, b).diagonal(dim1=1, dim2=2)
        logdet = mesh.psum(torch.sum(torch.log(diag)))
        ybar = _forward_solve(S, y_pad[:, None], mesh, m, b)
        alpha = _backward_solve(S, ybar, mesh, m, b)[:n, 0]
        lml = -0.5 * torch.dot(y, alpha) - logdet - 0.5 * n * _LOG_2PI
        return BlockCyclicPosterior(kernel=kernel, x=x, y=y, noise=noise, L_blocks=S, alpha=alpha,
                                    log_marginal=lml, block_size=b, n_blocks=m, world_size=world)


def predict_diag_blockcyclic(post: BlockCyclicPosterior, xo, mesh: RankMesh,
                             axis: str = "shard"):
    """Predictive mean and variance from the distributed factor, replicated.

    The mean needs only alpha (one (r, n) product); the variance runs the
    blocked forward substitution with the r cross-covariance columns as its
    right-hand side.  Called by every rank of the mesh the fit ran on."""
    with span("gp.entry.predict_diag_blockcyclic"):
        _check_mesh(mesh, axis)
        if mesh.world_size != post.world_size:
            raise ValueError(f"the posterior was fitted over {post.world_size} ranks; the mesh "
                             f"has {mesh.world_size}")
        xo = torch.as_tensor(xo, dtype=post.x.dtype).to(post.x.device)
        n, b, m = post.x.shape[0], post.block_size, post.n_blocks
        Kxox = post.kernel(xo, post.x)
        mean = Kxox @ post.alpha
        rhs = Kxox.new_zeros(m * b, xo.shape[0])
        rhs[:n] = Kxox.T
        v = _forward_solve(post.L_blocks, rhs, mesh, m, b)[:n]
        return mean, post.kernel.kdiag(xo) - torch.sum(v * v, dim=0)
