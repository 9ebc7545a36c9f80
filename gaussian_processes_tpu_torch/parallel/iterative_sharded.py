"""Row-sharded matrix-free GP inference over a process group.

Counterpart of ``gaussian_processes_tpu/parallel/iterative_sharded.py``: the
n training rows are split over the ranks of a ``RankMesh`` (rank r owns rows
[r n / W, (r + 1) n / W)), each rank builds only its (n / W, block) kernel
strips (kernel B1 on a card), and the CG + SLQ machinery of
``ops/krylov.py`` runs on every rank with three kinds of collective:

* ``all_gather`` of the (n, r) Krylov block before each rectangular strip
  product K(x_local, x) @ v, the only O(n r) communication;
* ``all_reduce`` of every column sum of the CG recurrence, the Woodbury
  capacitance contractions and the SLQ probe norms (the ``allreduce``
  hooks of ``ops/krylov.py``);
* a max / min / sum pivot broadcast per step of the row-sharded pivoted
  Cholesky.

The hooks reduce exactly the quantities the single-process code sums, so
the sharded recurrence is the same algorithm; the rank count only changes
the order of floating-point reductions.  The random draws come from one
``krylov.Draws`` (or a stand-in, as the tests replay the JAX package's) in
the order of the unsharded functions, so both see the same probes.
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.models.gp import _LOG_2PI
from gaussian_processes_tpu_torch.models.iterative_gp import IterativePosterior
from gaussian_processes_tpu_torch.ops import krylov, pairwise
from gaussian_processes_tpu_torch.parallel.mesh import RankMesh, make_mesh


def make_row_mesh(n_devices: int | None = None, axis: str = "i", *, device=None) -> RankMesh:
    """The row axis over the default process group (one device per rank)."""
    return make_mesh(n_devices, axis, device=device)


def _prep(x, y, noise, mesh: RankMesh):
    """Global inputs on the rank's device and this rank's row block."""
    x = torch.as_tensor(x).to(mesh.device)
    y = torch.as_tensor(y, dtype=x.dtype).to(mesh.device)
    noise = torch.as_tensor(noise, dtype=x.dtype).to(mesh.device)
    return x, y, noise, mesh.block(x.shape[0])


def _sharded_matvec(kernel, x_full, x_loc, noise, jitter, block_size, mesh: RankMesh):
    """v_local (n / W, r) -> the rank's rows of (K + (s^2 + jitter) I) v: one
    ``all_gather`` of v, then the strip product K(x_loc, x) @ v."""
    diag = torch.square(noise) + jitter

    def mv(v_loc):
        v_full = mesh.all_gather(v_loc, dim=0)
        out = krylov.kernel_matvec(kernel, x_full, v_full, noise, jitter,
                                   block_size=block_size, x_rows=x_loc)
        return out + diag * v_loc

    return mv


def _pivoted_cholesky_sharded(kernel, x_loc, rank: int, mesh: RankMesh, jitter: float = 1e-6):
    """Row-sharded greedy pivoted Cholesky: this rank's (n / W, rank) rows
    of the factor of ``krylov.pivoted_cholesky``.  Each step takes the
    global residual-diagonal maximum (the lowest rank among equal maxima
    owns the pivot), sums the owner's pivot point and factor row to every
    rank, and updates the local rows; the over-rank floor comes from the
    global leading diagonal."""
    n_loc = x_loc.shape[0]
    dtype = x_loc.dtype if x_loc.is_floating_point() else torch.float32
    d = kernel.kdiag(x_loc).to(dtype)
    L = torch.zeros((n_loc, rank), dtype=dtype, device=x_loc.device)
    floor = mesh.pmax(torch.max(d)) * (1e3 * torch.finfo(dtype).eps)
    me = torch.tensor(mesh.rank, device=x_loc.device)
    none = torch.tensor(mesh.world_size, device=x_loc.device)
    row = pairwise.pivot_rows(kernel, x_loc)
    point = x_loc.reshape(n_loc, -1)
    for j in range(rank):
        am = torch.argmax(d).reshape(1)
        m = d.index_select(0, am)[0]
        d_piv = mesh.pmax(m)
        owner = mesh.pmin(torch.where(m >= d_piv, me, none))
        mine = (owner == me).to(dtype)
        # the owner's pivot point and factor row, summed to every rank
        picked = mesh.psum(mine * torch.cat([point.index_select(0, am)[0].to(dtype),
                                             L.index_select(0, am)[0]]))
        xp, lp = picked[:point.shape[1]].to(x_loc.dtype), picked[point.shape[1]:]
        c = row(xp.reshape((1,) + x_loc.shape[1:])).to(dtype)  # K[piv, local rows]
        col = (c - L @ lp) / torch.sqrt(torch.clamp_min(d_piv, jitter))
        col = torch.where(d_piv > floor, col, torch.zeros_like(col))
        L[:, j] = col
        d = torch.clamp_min(d - col * col, 0.0)
    return L


def fit_iterative_sharded(
    kernel,
    x,
    y,
    noise,
    generator=None,
    *,
    mesh: RankMesh | None = None,
    axis: str = "i",
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    replace_every: int = 25,
) -> IterativePosterior:
    """Matrix-free exact-GP fit with the rows split over the mesh's ranks.

    The estimator of ``models.iterative_gp.fit_iterative`` with the same
    draws (Rademacher probes; with ``precond_rank > 0`` the preconditioned
    SLQ normals, xi1 (rank, r) then xi2 (n, r)); W must divide n.
    ``replace_every`` is the preconditioned solve's residual replacement, as
    in ``fit_iterative`` (the JAX package's sharded fit has none: 0).
    The posterior's ``alpha`` is the global (n,) solution, on every rank.
    """
    mesh = mesh if mesh is not None else make_row_mesh(axis=axis)
    x, y, noise, rows = _prep(x, y, noise, mesh)
    draws = krylov.as_draws(generator)
    n, dtype = x.shape[0], y.dtype
    x_loc, y_loc = x[rows], y[rows]
    mv = _sharded_matvec(kernel, x, x_loc, noise, jitter, block_size, mesh)
    red = mesh.psum
    if precond_rank > 0:
        xi1 = draws.normal((precond_rank, num_probes), dtype, x.device)
        xi2 = draws.normal((n, num_probes), dtype, x.device)[rows]
        sigma2 = torch.square(noise) + jitter
        L = _pivoted_cholesky_sharded(kernel, x_loc, precond_rank, mesh)
        pre = krylov.woodbury_inverse_apply(L, sigma2, allreduce=red)
        sol, rn = krylov.pcg(mv, pre, y_loc[:, None], num_iters=num_iters, tol=tol,
                             allreduce=red, replace_every=replace_every)
        shift = krylov.effective_precond_shift(L, sigma2, allreduce=red)
        probes = L @ xi1 + torch.sqrt(shift) * xi2
        logdet = krylov.slq_logdet_preconditioned(mv, L, sigma2, None, num_probes, num_iters,
                                                  n, probes=probes, allreduce=red)
        alpha_loc, residual = sol[:, 0], rn[0]
    else:
        probes = draws.rademacher((n, num_probes), dtype, x.device)[rows]
        rhs = torch.cat([y_loc[:, None], probes], dim=1)
        res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol, allreduce=red)
        probe_norms = torch.full((num_probes,), float(n), dtype=dtype, device=x.device)
        logdet = krylov.slq_logdet_from_cg(res.alphas[:, 1:], res.betas[:, 1:], probe_norms, n)
        alpha_loc, residual = res.solution[:, 0], res.residual_norm[0]
    lml = -0.5 * red(torch.dot(y_loc, alpha_loc)) - 0.5 * logdet - 0.5 * n * _LOG_2PI
    return IterativePosterior(kernel=kernel, x=x, y=y, noise=noise,
                              alpha=mesh.all_gather(alpha_loc), log_marginal=lml,
                              solve_residual=residual, num_probes=num_probes,
                              num_iters=num_iters)


def _draw_vg_probes(draws, n, num_probes, precond_rank, dtype, device):
    """The value+grad estimator's draws in the unsharded order: Rademacher
    probes (n, r), then with a preconditioner xi1 (rank, r) and xi2 (n, r)."""
    probes = draws.rademacher((n, num_probes), dtype, device)
    if precond_rank > 0:
        xi1 = draws.normal((precond_rank, num_probes), dtype, device)
        xi2 = draws.normal((n, num_probes), dtype, device)
    else:
        xi1 = torch.zeros((0, num_probes), dtype=dtype, device=device)
        xi2 = torch.zeros((n, num_probes), dtype=dtype, device=device)
    return probes, xi1, xi2


def _vg_local(kernel, x_full, x_loc, y_loc, probes_loc, xi1, xi2_loc, noise, mesh: RankMesh, *,
              num_probes, num_iters, tol, jitter, block_size, precond_rank):
    """One rank's part of the sharded (lml, d lml / d theta) estimator, with
    the data, probe and xi2 rows of the rank; returns the (lml, grad) every
    rank shares, grad = (d / d kernel params..., d / d s).  Shared by the
    MLE below and the data-sharded Bayesian log posterior
    (``parallel/bayes_sharded.py``)."""
    n = x_full.shape[0]
    red = mesh.psum
    mv = _sharded_matvec(kernel, x_full, x_loc, noise, jitter, block_size, mesh)
    rhs = torch.cat([y_loc[:, None], probes_loc], dim=1)
    if precond_rank > 0:
        sigma2 = torch.square(noise) + jitter
        L = _pivoted_cholesky_sharded(kernel, x_loc, precond_rank, mesh)
        pre = krylov.woodbury_inverse_apply(L, sigma2, allreduce=red)
        sol, _ = krylov.pcg(mv, pre, rhs, num_iters=num_iters, tol=tol, allreduce=red)
        shift = krylov.effective_precond_shift(L, sigma2, allreduce=red)
        slq_probes = L @ xi1 + torch.sqrt(shift) * xi2_loc
        logdet = krylov.slq_logdet_preconditioned(mv, L, sigma2, None, num_probes, num_iters,
                                                  n, probes=slq_probes, allreduce=red)
    else:
        res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol, allreduce=red)
        sol = res.solution
        probe_norms = torch.full((num_probes,), float(n), dtype=y_loc.dtype,
                                 device=y_loc.device)
        logdet = krylov.slq_logdet_from_cg(res.alphas[:, 1:], res.betas[:, 1:], probe_norms, n)
    alpha_loc, Kinv_z_loc = sol[:, 0], sol[:, 1:]
    lml = -0.5 * red(torch.dot(y_loc, alpha_loc)) - 0.5 * logdet - 0.5 * n * _LOG_2PI

    # Hutchinson gradient: this rank's Jacobian strips J_p(x_loc, x_j) (kernel
    # B2a on a card) against column blocks of the gathered [alpha, probes]
    U = mesh.all_gather(torch.cat([alpha_loc[:, None], probes_loc], dim=1))
    JU = U.new_zeros((kernel.n_params, x_loc.shape[0], U.shape[1]))
    for j in range(0, n, block_size):
        JU = JU + kernel.jacobian(x_loc, x_full[j:j + block_size]) @ U[j:j + block_size]
    quad = red(torch.einsum("n,pn->p", alpha_loc, JU[:, :, 0]))
    trace = torch.mean(red(torch.einsum("nr,pnr->pr", Kinv_z_loc, JU[:, :, 1:])), dim=-1)
    two_s = 2.0 * noise
    quad_s = two_s * red(torch.dot(alpha_loc, alpha_loc))
    trace_s = two_s * torch.mean(red(torch.sum(Kinv_z_loc * probes_loc, dim=0)))
    grad = 0.5 * torch.cat([quad - trace, (quad_s - trace_s).reshape(1)])
    return lml, grad


def log_marginal_value_and_grad_iterative_sharded(
    kernel,
    x,
    y,
    noise,
    generator=None,
    *,
    mesh: RankMesh | None = None,
    axis: str = "i",
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
):
    """Row-sharded (lml, d lml / d theta), theta = (kernel params..., s):
    the estimator of ``log_marginal_value_and_grad_iterative`` with the
    same draws; every rank returns the same pair."""
    mesh = mesh if mesh is not None else make_row_mesh(axis=axis)
    x, y, noise, rows = _prep(x, y, noise, mesh)
    probes, xi1, xi2 = _draw_vg_probes(krylov.as_draws(generator), x.shape[0], num_probes,
                                       precond_rank, y.dtype, x.device)
    return _vg_local(kernel, x, x[rows], y[rows], probes[rows], xi1, xi2[rows], noise, mesh,
                     num_probes=num_probes, num_iters=num_iters, tol=tol, jitter=jitter,
                     block_size=block_size, precond_rank=precond_rank)


def fit_mle_iterative_sharded(
    kernel,
    x,
    y,
    noise_init,
    generator=None,
    *,
    mesh: RankMesh | None = None,
    axis: str = "i",
    num_steps: int = 50,
    learning_rate: float = 0.05,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
):
    """Matrix-free type-II MLE with every (value, grad) row-sharded: Adam
    (``torch.optim.Adam``, ``optax.adam``'s defaults) on u = log(theta, s),
    fresh draws each step, as ``fit_mle_iterative``.  Returns (kernel, noise,
    last_lml_estimate, lml_trace)."""
    mesh = mesh if mesh is not None else make_row_mesh(axis=axis)
    x, y, noise_init, rows = _prep(x, y, noise_init, mesh)
    draws = krylov.as_draws(generator)
    n, P = x.shape[0], kernel.n_params
    params = kernel.params.to(device=y.device, dtype=y.dtype)
    u = torch.log(torch.cat([params, noise_init.reshape(1)])).requires_grad_()
    opt = torch.optim.Adam([u], lr=learning_rate)
    lmls = []
    for _ in range(num_steps):
        theta = torch.exp(u.detach())
        probes, xi1, xi2 = _draw_vg_probes(draws, n, num_probes, precond_rank, y.dtype,
                                           x.device)
        lml, g_theta = _vg_local(
            kernel.with_params(theta[:P]), x, x[rows], y[rows], probes[rows], xi1, xi2[rows],
            theta[P], mesh, num_probes=num_probes, num_iters=num_iters, tol=tol,
            jitter=jitter, block_size=block_size, precond_rank=precond_rank)
        u.grad = -g_theta * theta  # d(-lml)/du through exp
        opt.step()
        lmls.append(float(lml))
    theta = torch.exp(u.detach())
    return kernel.with_params(theta[:P]), theta[P], lmls[-1], lmls


def predict_mean_iterative_sharded(post: IterativePosterior, xo, *,
                                   mesh: RankMesh | None = None, axis: str = "i",
                                   block_size: int = 1024) -> torch.Tensor:
    """Predictive mean with the test rows split over the ranks: K(xo_loc, x)
    @ alpha.  ``xo`` is zero-padded to a multiple of W (the padded rows are
    dropped), so any m works; every rank returns all m means."""
    mesh = mesh if mesh is not None else make_row_mesh(axis=axis)
    xo = torch.as_tensor(xo, dtype=post.x.dtype).to(post.x.device)
    m = xo.shape[0]
    m_pad = -(-m // mesh.world_size) * mesh.world_size
    xo_pad = torch.cat([xo, xo.new_zeros((m_pad - m,) + xo.shape[1:])])
    out = krylov.kernel_matvec(post.kernel, post.x, post.alpha, post.noise, 0.0,
                               block_size=block_size, x_rows=xo_pad[mesh.block(m_pad)])
    return mesh.all_gather(out)[:m]
