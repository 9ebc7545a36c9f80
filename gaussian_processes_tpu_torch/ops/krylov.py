"""Matrix-free Krylov ops: kernel matvec, batched CG, SLQ logdet.

Counterpart of ``gaussian_processes_tpu/ops/krylov.py``: the large-N path on
which no N x N array is ever stored (pattern: the public BBMM / GPyTorch line
of work, blackbox matrix-matrix inference).

* ``kernel_matvec``: (K + (s^2 + jitter) I) v.  ``"fused"`` is kernel B4 on a
  CUDA card (``ops/pairwise.py::kernel_matvec_fused``); ``"strip"`` builds
  (n, b) strips of K with the pairwise builder and contracts each with
  ``torch.matmul``.  ``"auto"`` takes the fused form for CUDA tensors
  whenever the kernel has one, and the strip everywhere else.
* ``mbcg`` / ``pcg``: batched (preconditioned) conjugate gradients run a
  fixed number of iterations; converged or broken-down columns freeze under
  masked updates.  The recurrence coefficients double as each probe's
  Lanczos tridiagonal, so solves and logdet probes come out of one sweep.
* ``slq_logdet_*``: stochastic Lanczos quadrature of logdet, plain (from
  Rademacher probes) or preconditioned by a pivoted Cholesky factor.

``lax.scan`` becomes a Python loop of masked tensor updates that never reads
a value back to the host; ``lax.cond`` on the iteration index becomes a
Python ``if``.  Only ``pcg(early_exit=True)`` reads the active mask each
iteration, one synchronisation per iteration.

Random numbers: the JAX package draws from keys; here every draw of the
matrix-free path (and of slice 4's samplers, features and inducing points)
goes through one ``Draws`` object (``as_draws``), which takes them in order
from a ``torch.Generator``.  The draws are standard variates; scaling stays
with the caller, as in the JAX functions.  Any object with the same methods
may stand in for it, which is how the tests replay the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussian_processes_tpu_torch.ops import pairwise
from gaussian_processes_tpu_torch.ops.blocked_cholesky import cholesky_reference


def _identity(a):
    return a


class Draws:
    """The random numbers of the matrix-free path, drawn in order from one
    generator (on the CPU unless the generator lives elsewhere, so a seed
    gives the same numbers whatever the device) and moved to the device."""

    def __init__(self, generator: torch.Generator | None = None):
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)

    def rademacher(self, shape, dtype, device) -> torch.Tensor:
        bits = torch.randint(0, 2, shape, generator=self.generator,
                             device=self.generator.device)
        return (2 * bits - 1).to(dtype=dtype, device=device)

    def normal(self, shape, dtype, device) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.generator.device).to(device)

    def uniform(self, shape, dtype, device) -> torch.Tensor:
        """Uniform on [0, 1)."""
        return torch.rand(shape, generator=self.generator, dtype=dtype,
                          device=self.generator.device).to(device)

    def gamma(self, a, shape, dtype, device) -> torch.Tensor:
        """Gamma(a, rate 1)."""
        conc = torch.as_tensor(a, dtype=dtype).to(self.generator.device).expand(shape)
        return torch._standard_gamma(conc.contiguous(), generator=self.generator).to(device)

    def chisquare(self, df, shape, dtype, device) -> torch.Tensor:
        """Chi-square with ``df`` degrees of freedom: 2 Gamma(df / 2)."""
        return 2.0 * self.gamma(0.5 * df, shape, dtype, device)

    def categorical(self, logits, shape, device) -> torch.Tensor:
        """Indices drawn with log-weights ``logits`` (K,), int64."""
        p = torch.softmax(torch.as_tensor(logits).to(self.generator.device, torch.float64), 0)
        idx = torch.multinomial(p, math.prod(shape), replacement=True, generator=self.generator)
        return idx.reshape(shape).to(device)

    def bernoulli(self, p, shape, device) -> torch.Tensor:
        """Booleans, True with probability ``p`` (a scalar)."""
        return self.uniform(shape, torch.float64, device) < float(p)

    def choice(self, n: int, m: int, device) -> torch.Tensor:
        """``m`` of ``range(n)`` without replacement, int64."""
        return torch.randperm(n, generator=self.generator,
                              device=self.generator.device)[:m].to(device)


def as_draws(generator):
    """``generator`` as a source of draws: a ``torch.Generator`` or None
    (seed 0, as the JAX package defaults to ``key(0)``) becomes a ``Draws``;
    anything else must have ``Draws``' two methods and is used as it is."""
    if generator is None or isinstance(generator, torch.Generator):
        return Draws(generator)
    return generator


def kernel_matvec(
    kernel,
    x,
    v,
    noise,
    jitter: float = 0.0,
    block_size: int = 1024,
    impl: str = "auto",
    x_rows=None,
) -> torch.Tensor:
    """(K_f(x, x) + (noise^2 + jitter) I) @ v without materializing K.

    ``v`` may be (n,) or (n, r).  ``impl``: ``"strip"`` (column strips of K,
    each contracted), ``"fused"`` (kernel B4: K tiles built and consumed on
    chip) or ``"auto"``.  The JAX package's default of the strip was measured
    on a TPU and does not carry over: on a CUDA card ``"auto"`` takes B4.

    ``x_rows`` selects a rectangular strip product K_f(x_rows, x) @ v, the
    row-sharded building block of a distributed matvec; the noise diagonal
    is then NOT added (rows and columns are misaligned on a shard).
    """
    x = torch.as_tensor(x)
    rect = x_rows is not None
    if impl == "auto":
        fused = (x.device.type == "cuda" and not rect
                 and pairwise.supports_fused_matvec(kernel, x))
        impl = "fused" if fused else "strip"
    if impl == "fused":
        if rect:
            raise ValueError("impl='fused' does not support x_rows")
        return pairwise.kernel_matvec_fused(kernel, x, v, noise, jitter)
    if impl != "strip":
        raise ValueError(f"unknown impl {impl!r}")
    rows = x if not rect else torch.as_tensor(x_rows, device=x.device)
    v = torch.as_tensor(v, device=x.device)
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    out = v2.new_zeros((rows.shape[0], v2.shape[1]))
    for j in range(0, x.shape[0], block_size):
        out = out + kernel(rows, x[j:j + block_size]) @ v2[j:j + block_size]
    if not rect:
        diag = torch.square(torch.as_tensor(noise, dtype=out.dtype, device=out.device)) + jitter
        out = out + diag * v2
    return out[:, 0] if squeeze else out


class MBCGResult(NamedTuple):
    solution: torch.Tensor  # (n, r)
    alphas: torch.Tensor  # (m, r) CG step sizes
    betas: torch.Tensor  # (m, r) CG direction updates
    residual_norm: torch.Tensor  # (r,) final relative residuals


def _stack(steps, rhs) -> torch.Tensor:
    return torch.stack(steps) if steps else rhs.new_zeros((0, rhs.shape[1]))


def mbcg(matvec, rhs, num_iters: int, tol: float = 1e-10, allreduce=None) -> MBCGResult:
    """Batched CG on (n, r) right-hand sides, fixed ``num_iters``.

    Converged columns, and numerical breakdowns (pAp <= 0, non-finite
    values, a residual blown far past its best), freeze under masked
    updates, so their Lanczos coefficients stop changing.  Returns the best
    iterate seen.  ``allreduce`` wraps every column sum over the n axis (the
    hook of a row-sharded run); by default it is the identity.
    """
    red = allreduce if allreduce is not None else _identity

    def colsum(a):
        return red(torch.sum(a, dim=0))

    x = torch.zeros_like(rhs)
    res = rhs
    p = rhs
    rs = colsum(res * res)
    b_norm = torch.sqrt(torch.clamp_min(colsum(rhs * rhs), 1e-30))
    x_best, rs_best = x, rs
    alphas, betas = [], []
    for _ in range(num_iters):
        Ap = matvec(p)
        pAp = colsum(p * Ap)
        active = (
            (torch.sqrt(rs) / b_norm > tol)
            & (pAp > 0)
            & torch.isfinite(pAp)
            & torch.isfinite(rs)
            & (rs < 1e4 * rs_best)
        )
        alpha = torch.where(active, rs / torch.where(active, pAp, 1.0), 0.0)
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * Ap
        rs_new = torch.where(active, colsum(res * res), rs)
        beta = torch.where(active, rs_new / torch.clamp_min(rs, 1e-30), 0.0)
        p = torch.where(active[None, :], res + beta[None, :] * p, p)
        better = rs_new < rs_best
        x_best = torch.where(better[None, :], x, x_best)
        rs_best = torch.where(better, rs_new, rs_best)
        rs = rs_new
        alphas.append(alpha)
        betas.append(beta)
    return MBCGResult(
        solution=x_best,
        alphas=_stack(alphas, rhs),
        betas=_stack(betas, rhs),
        residual_norm=torch.sqrt(rs_best) / b_norm,
    )


def pivoted_cholesky(kernel, x, rank: int, jitter: float = 1e-6) -> torch.Tensor:
    """Rank-k pivoted Cholesky of K_f(x, x), built matrix-free.

    Greedy diagonal pivoting; each step builds one kernel row K[piv, :]
    (``pairwise.pivot_rows``: kernel B1 on the parameters read once before
    the loop, or B6 for ARD, on a card; a 1 x n output keeps the launch's
    stores on one row; the row equals the column K[:, piv] bit for bit,
    since x_piv - x_i only changes sign)
    and multiplies the whole factor, O(n k) per step.  The pivot stays on
    the device (no host read per step).  Once the residual diagonal falls
    below 1e3 * eps * max(diag), later columns are frozen to zero: past that
    floor they would be round-off divided by a clamped pivot and would spoil
    the Woodbury preconditioner.
    """
    x = torch.as_tensor(x)
    n = x.shape[0]
    dtype = x.dtype if x.is_floating_point() else torch.float32
    d = kernel.kdiag(x).to(dtype)  # (n,)
    L = torch.zeros((n, rank), dtype=dtype, device=x.device)
    floor = torch.max(d) * (1e3 * torch.finfo(dtype).eps)
    row = pairwise.pivot_rows(kernel, x)
    for j in range(rank):
        piv = torch.argmax(d).reshape(1)
        c = row(x.index_select(0, piv)).to(dtype)  # K[piv, :]
        d_piv = d.index_select(0, piv)[0]
        lp = L.index_select(0, piv)[0]  # (rank,); columns >= j are still zero
        col = (c - L @ lp) / torch.sqrt(torch.clamp_min(d_piv, jitter))
        col = torch.where(d_piv > floor, col, torch.zeros_like(col))
        L[:, j] = col
        d = torch.clamp_min(d - col * col, 0.0)
    return L


def effective_precond_shift(L, sigma2, allreduce=None, floor_factor: float = 1.5e3):
    """Damped Woodbury shift: max(sigma2, floor_factor * eps * lam_max).

    The apply's final ``(v - L M^-1 L^T v) / shift`` amplifies its own
    rounding by about ||K|| / shift; flooring the shift at about
    1e3 * eps * lam_max caps that amplification where sigma2 is below the
    dtype's reach.  lam_max is estimated by the squared norm of the first
    pivot column.
    """
    lam = torch.sum(torch.square(L[:, 0]))
    if allreduce is not None:
        lam = allreduce(lam)
    eps = torch.finfo(L.dtype).eps
    sigma2 = torch.as_tensor(sigma2, dtype=L.dtype, device=L.device)
    return torch.maximum(sigma2, (floor_factor * eps) * lam)


def _capacitance_factor(L, sigma2, allreduce):
    red = allreduce if allreduce is not None else _identity
    k = L.shape[1]
    shift = effective_precond_shift(L, sigma2, allreduce=allreduce)
    M = shift * torch.eye(k, dtype=L.dtype, device=L.device) + red(L.T @ L)
    return shift, cholesky_reference(M)


def woodbury_inverse_apply(L, sigma2, allreduce=None):
    """Return v -> (L L^T + shift I)^-1 v via the Woodbury identity, with
    shift = ``effective_precond_shift(L, sigma2)``.

    The (k, k) capacitance matrix is factored once and inverted once into a
    triangular inverse, so every apply is the same fixed SPD operator, a
    chain of matrix products (what CG requires of a preconditioner).
    """
    red = allreduce if allreduce is not None else _identity
    shift, Lm = _capacitance_factor(L, sigma2, allreduce)
    eye = torch.eye(L.shape[1], dtype=L.dtype, device=L.device)
    Lm_inv = torch.linalg.solve_triangular(Lm, eye, upper=False)

    def apply(v):
        Ltv = red(L.T @ v)
        t = Lm_inv @ Ltv
        MLtv = Lm_inv.T @ t
        return (v - L @ MLtv) / shift

    return apply


def pcg(
    matvec,
    precond,
    rhs,
    num_iters: int,
    tol: float = 1e-10,
    return_tridiag: bool = False,
    early_exit: bool = False,
    allreduce=None,
    replace_every: int = 0,
):
    """Preconditioned CG on (n, r) right-hand sides, fixed iterations.

    Same robustness policy as ``mbcg``.  ``return_tridiag`` also returns the
    recurrence coefficients (the Lanczos tridiagonal of P^-1 A in the P inner
    product, for preconditioned SLQ).

    ``early_exit=True`` stops once every column has frozen; the result is
    bit-identical to the fixed-length loop (frozen columns do not change
    either way), at the cost of reading the active mask on the host once per
    iteration.  ``replace_every=k`` recomputes the residual as the true
    ``rhs - matvec(x)`` every k iterations and restarts the direction from
    the preconditioned residual, for still-active columns only (a frozen
    column is never revived).  Neither combines with ``return_tridiag``.
    """
    if early_exit and return_tridiag:
        raise ValueError("early_exit does not collect tridiagonals")
    if replace_every and return_tridiag:
        raise ValueError("residual replacement invalidates the Lanczos tridiagonal")
    red = allreduce if allreduce is not None else _identity

    def colsum(a):
        return red(torch.sum(a, dim=0))

    x = torch.zeros_like(rhs)
    res = rhs
    p = precond(res)
    rz = colsum(res * p)
    b_norm = torch.sqrt(torch.clamp_min(colsum(rhs * rhs), 1e-30))
    x_best = x
    rn_best = torch.sqrt(colsum(res * res))
    act_prev = torch.ones(rhs.shape[1], dtype=torch.bool, device=rhs.device)
    alphas, betas = [], []
    for i in range(num_iters):
        if early_exit and not bool(act_prev.any()):
            break
        if replace_every and i > 0 and i % replace_every == 0:
            res_t = rhs - matvec(x)
            z_t = precond(res_t)
            res = torch.where(act_prev[None, :], res_t, res)
            p = torch.where(act_prev[None, :], z_t, p)
            rz = torch.where(act_prev, colsum(res_t * z_t), rz)
        Ap = matvec(p)
        pAp = colsum(p * Ap)
        rn = torch.sqrt(colsum(res * res))
        active = (
            (rn / b_norm > tol)
            & (pAp > 0)
            & torch.isfinite(pAp)
            & torch.isfinite(rz)
            & (rn < 1e2 * rn_best + 1e-30)
            & act_prev
        )
        alpha = torch.where(active, rz / torch.where(active, pAp, 1.0), 0.0)
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * Ap
        z = precond(res)
        rz_new = torch.where(active, colsum(res * z), rz)
        beta = torch.where(active, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = torch.where(active[None, :], z + beta[None, :] * p, p)
        rn_new = torch.sqrt(colsum(res * res))
        better = rn_new < rn_best
        x_best = torch.where(better[None, :], x, x_best)
        rn_best = torch.where(better, rn_new, rn_best)
        rz = rz_new
        act_prev = active
        alphas.append(alpha)
        betas.append(beta)
    if return_tridiag:
        return x_best, rn_best / b_norm, _stack(alphas, rhs), _stack(betas, rhs)
    return x_best, rn_best / b_norm


def precond_logdet(L, sigma2, n: int, allreduce=None) -> torch.Tensor:
    """Exact logdet(L L^T + shift I) by the matrix determinant lemma:
    logdet(shift I_k + L^T L) + (n - k) log(shift), with the damped shift of
    ``woodbury_inverse_apply``.  ``n`` is the global row count."""
    shift, Lm = _capacitance_factor(L, sigma2, allreduce)
    k = L.shape[1]
    return 2.0 * torch.sum(torch.log(torch.diagonal(Lm))) + (n - k) * torch.log(shift)


def sample_precond_probes(generator, L, sigma2, num_probes: int, allreduce=None):
    """Draw z ~ N(0, P), P = L L^T + shift I (the apply's damped shift):
    z = L xi1 + sqrt(shift) xi2, xi1 (k, r) drawn before xi2 (n, r)."""
    draws = as_draws(generator)
    n, k = L.shape
    xi1 = draws.normal((k, num_probes), L.dtype, L.device)
    xi2 = draws.normal((n, num_probes), L.dtype, L.device)
    sigma = torch.sqrt(effective_precond_shift(L, sigma2, allreduce=allreduce))
    return L @ xi1 + sigma * xi2


def slq_quadratures_from_cg(alphas, betas) -> torch.Tensor:
    """e1^T log(T) e1 for each column's Lanczos tridiagonal T, shape (r,):
    the per-probe quadratures of the SLQ estimates."""
    evals, evecs = torch.linalg.eigh(lanczos_tridiag_from_cg(alphas, betas))
    w = torch.square(evecs[:, 0, :])  # (r, m) first-component weights
    return torch.sum(w * torch.log(torch.clamp_min(evals, 1e-30)), dim=-1)


def slq_terms_preconditioned(matvec, L, sigma2, generator, num_probes: int,
                             num_iters: int, probes=None, allreduce=None):
    """The per-probe terms (z^T P^-1 z) e1^T log(T) e1, shape (r,), whose
    mean is the stochastic part of ``slq_logdet_preconditioned``."""
    red = allreduce if allreduce is not None else _identity
    pre = woodbury_inverse_apply(L, sigma2, allreduce=allreduce)
    if probes is None:
        probes = sample_precond_probes(generator, L, sigma2, num_probes,
                                       allreduce=allreduce)
    _, _, alphas, betas = pcg(matvec, pre, probes, num_iters=num_iters, tol=1e-12,
                              return_tridiag=True, allreduce=allreduce)
    probe_norms = red(torch.sum(probes * pre(probes), dim=0))  # z^T P^-1 z
    return probe_norms * slq_quadratures_from_cg(alphas, betas)


def slq_logdet_preconditioned(matvec, L, sigma2, generator, num_probes: int,
                              num_iters: int, n: int, probes=None, allreduce=None):
    """SLQ estimate of logdet(A) with pivoted-Cholesky preconditioning:

        logdet(A) = logdet(P) + E_{z ~ N(0, P)}[(z^T P^-1 z) e1^T log(T) e1]

    with T the PCG Lanczos tridiagonal of P^-1 A started at z (the GPyTorch
    preconditioned-SLQ identity); logdet(P) is exact.  Pass ``probes``
    (n_local, r) in sharded contexts (``generator`` is then unused).
    """
    terms = slq_terms_preconditioned(matvec, L, sigma2, generator, num_probes,
                                     num_iters, probes=probes, allreduce=allreduce)
    return precond_logdet(L, sigma2, n, allreduce=allreduce) + torch.mean(terms)


def lanczos_tridiag_from_cg(alphas, betas) -> torch.Tensor:
    """Lanczos T (r, m, m), one per column, from CG coefficients (m, r).

    diag_k    = 1/alpha_k + beta_{k-1}/alpha_{k-1}   (beta_{-1} = 0)
    offdiag_k = sqrt(beta_k) / alpha_k
    Frozen (alpha = 0) iterations give zero rows and columns, inert in the
    quadrature.
    """
    m, r = alphas.shape
    safe_a = torch.where(alphas > 0, alphas, 1.0)
    inv_a = torch.where(alphas > 0, 1.0 / safe_a, 0.0)  # (m, r)
    prev_beta_over_a = torch.cat([alphas.new_zeros((1, r)), (betas * inv_a)[:-1]], dim=0)
    diag = inv_a + prev_beta_over_a  # (m, r)
    off = torch.sqrt(torch.clamp_min(betas, 0.0)) * inv_a  # (m, r); last unused
    offd = off[:-1].T  # (r, m - 1)
    return (torch.diag_embed(diag.T) + torch.diag_embed(offd, offset=1)
            + torch.diag_embed(offd, offset=-1))


def slq_logdet_from_cg(alphas, betas, probe_sq_norms, n) -> torch.Tensor:
    """SLQ estimate of logdet(K) from the CG coefficients of Rademacher
    probes: mean_probes[||z||^2 e1^T log(T) e1] (||z||^2 = n for Rademacher
    probes, passed explicitly to support normalized probes)."""
    return torch.mean(probe_sq_norms * slq_quadratures_from_cg(alphas, betas))
