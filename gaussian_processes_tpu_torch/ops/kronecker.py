"""Kronecker-structured kernel algebra for D-dimensional Cartesian grids.

Counterpart of ``gaussian_processes_tpu/ops/kronecker.py``, the multi-dim
sibling of ``ops/toeplitz.py``.  When the (n, D) training inputs are the
Cartesian product of per-dimension uniform grids (row-major, axis 0 slowest:
``kron_inputs``), the ARD squared-exponential kernel matrix factorizes as

    K = h^2 T_1 (x) T_2 (x) ... (x) T_D,   T_d[i,j] = k_d(g_d[i] - g_d[j])

so a matvec is D batched Toeplitz-FFT sweeps over the reshaped tensor,
O(n log n) for n = prod(n_d).  dK/dh = (2/h) K; dK/dw_d swaps factor d for
its derivative column, so the matrix-free gradient stays in FFT land too.
The Kronecker product of the per-dimension Strang circulants is diagonalized
by the D-dim DFT: an O(n log n) preconditioner with an exact logdet, and the
torus Whittle density.

The columns are plain elementwise tensor code (as in the JAX package, which
does not build them with its pairwise kernel); the FFTs are ``torch.fft``.
The spectra take the kernel's parameters as ``theta`` (1 + D,) or
(C, 1 + D), differentiable by autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from gaussian_processes_tpu_torch.models.ard import ARDGaussianKernel
from gaussian_processes_tpu_torch.ops import krylov, toeplitz


@dataclasses.dataclass(frozen=True)
class KronOperator:
    """Cartesian-grid geometry: per-dimension uniform 1-D grids.

    ``axes``: tuple of (n_d,) tensors.  The (n, D) training inputs must be
    ``kron_inputs(axes)`` (row-major) and y must follow the same order.
    Kernel and noise are not stored: one geometry serves every
    hyperparameter value.
    """

    axes: Tuple[torch.Tensor, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(a.shape[0]) for a in self.axes)

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.axes)


def kron_inputs(axes) -> torch.Tensor:
    """(n, D) Cartesian-product inputs, row-major (axis 0 slowest)."""
    grids = torch.meshgrid(*[torch.as_tensor(a) for a in axes], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def _se_column(g: torch.Tensor, w) -> torch.Tensor:
    """First column of the unit-amplitude SE Toeplitz factor on grid g."""
    d = g - g[0]
    return torch.exp(-0.5 * torch.square(d) / torch.square(w))


def _se_dcolumn(g: torch.Tensor, w) -> torch.Tensor:
    """First column of d/dw of the unit SE factor: E * d^2 / w^3."""
    d = g - g[0]
    s = torch.square(d) / torch.square(w)
    return torch.exp(-0.5 * s) * s / w


def _check(kernel, op: KronOperator) -> None:
    if not isinstance(kernel, ARDGaussianKernel):
        raise NotImplementedError(
            "Kronecker structure currently supports ARDGaussianKernel (separable by "
            f"construction); got {type(kernel).__name__}")
    if kernel.w.shape[0] != op.ndim:
        raise ValueError(f"kernel has {kernel.w.shape[0]} lengthscales, grid has "
                         f"{op.ndim} axes")


def _theta(kernel, op: KronOperator) -> torch.Tensor:
    g = op.axes[0]
    return kernel.params.to(dtype=g.dtype, device=g.device)


def _columns(theta, op: KronOperator):
    """Per-dimension columns at ``theta`` (1 + D,) or (C, 1 + D): each (n_d,)
    or (C, n_d); h^2 folded into factor 0."""
    cols = [_se_column(g, theta[..., 1 + d:2 + d]) for d, g in enumerate(op.axes)]
    cols[0] = cols[0] * torch.square(theta[..., 0:1])
    return cols


def kron_columns(kernel: ARDGaussianKernel, op: KronOperator):
    """Per-dimension Toeplitz first columns; h^2 folded into factor 0."""
    _check(kernel, op)
    return _columns(_theta(kernel, op), op)


def kron_jacobian_columns(kernel: ARDGaussianKernel, op: KronOperator):
    """Column lists for dK/dtheta_p, p = (h, w_1..w_D), each Kronecker:
    dK/dh = (2/h) K (same columns, rescaled); dK/dw_d swaps factor d for its
    derivative column (amplitude kept on factor 0)."""
    base = kron_columns(kernel, op)
    theta = _theta(kernel, op)
    h = theta[0]
    out = [[base[0] * (2.0 / h)] + list(base[1:])]
    for d in range(op.ndim):
        cols = list(base)
        dcol = _se_dcolumn(op.axes[d], theta[1 + d])
        cols[d] = dcol * torch.square(h) if d == 0 else dcol
        out.append(cols)
    return out


def kron_matvec(cols, v: torch.Tensor, shift=0.0) -> torch.Tensor:
    """((x)_d T_d + shift I) @ v; v is (n,) or (n, r), n = prod(n_d).  D
    batched Toeplitz-FFT sweeps, each factor along its own axis."""
    sizes = tuple(int(c.shape[0]) for c in cols)
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    r = v2.shape[1]
    t = v2.reshape(*sizes, r)
    for d, c in enumerate(cols):
        t = torch.movedim(t, d, 0)
        lead, rest = t.shape[0], t.shape[1:]
        t = toeplitz.toeplitz_matvec(c, t.reshape(lead, -1))
        t = torch.movedim(t.reshape(lead, *rest), 0, d)
    out = t.reshape(-1, r) + torch.as_tensor(shift, dtype=v2.dtype, device=v2.device) * v2
    return out[:, 0] if squeeze else out


def kernel_matvec_kron(kernel, op: KronOperator, v, noise, jitter: float = 0.0):
    """(K(x, x) + (noise^2 + jitter) I) @ v on the Cartesian grid."""
    cols = kron_columns(kernel, op)
    shift = torch.square(torch.as_tensor(noise, dtype=cols[0].dtype,
                                         device=cols[0].device)) + jitter
    return kron_matvec(cols, v, shift)


# --- circulant preconditioner / exact-logdet SLQ (D-dim) --------------------


def _outer(lams):
    """Outer product of per-dimension spectra, each (n_d,) or (C, n_d):
    (n_1, ..., n_D) or (C, n_1, ..., n_D)."""
    lam = lams[0]
    for d, lam_d in enumerate(lams[1:], start=1):
        lam = lam[..., None] * lam_d.reshape(lam_d.shape[:-1] + (1,) * d + lam_d.shape[-1:])
    return lam


def _add_shift(lam, shift, D: int):
    shift = torch.as_tensor(shift, dtype=lam.dtype, device=lam.device)
    if shift.ndim:  # (C, 1): one shift per chain
        shift = shift.reshape(shift.shape[:1] + (1,) * D)
    return toeplitz._spd_guard(lam + shift)


def kron_circulant_spectrum(cols, shift) -> torch.Tensor:
    """Full-grid spectrum of P = ((x)_d C_d) + shift I, noise ADDITIVE.

    Each C_d is the Strang circulant of T_d; the Kronecker product is
    diagonalized by the D-dim DFT with eigenvalues outer(lam_d).  Per-factor
    FFT round-off is rectified at zero and the shift added after, as in
    ``toeplitz.circulant_eigenvalues``.  The wrap needs each dimension's
    kernel to decay within n_d / 2 cells; with a lengthscale comparable to
    the grid extent the clamped circulant can slow CG.  Returned shape: the
    grid's (with a leading chain axis for batched columns).
    """
    lams = []
    for c in cols:
        wrap = toeplitz._wrap_index(c.shape[-1], c.device)
        lams.append(torch.clamp_min(torch.fft.fft(c[..., wrap]).real, 0.0))
    return _add_shift(_outer(lams), shift, len(cols))


def _spectrum_analytic(theta, op: KronOperator, shift, aliases: int = 2):
    lams = []
    for d, g in enumerate(op.axes):
        n = g.shape[0]
        dx = g[1] - g[0]
        k = torch.arange(n, dtype=g.dtype, device=g.device)
        k = torch.where(k <= n // 2, k, k - n)  # full fft bin frequencies
        om = 2.0 * math.pi * k / (n * dx)
        om_s = 2.0 * math.pi / dx
        w = theta[..., 1 + d:2 + d]
        lam_d = None
        for l in range(-aliases, aliases + 1):
            s = w * math.sqrt(2.0 * math.pi) * torch.exp(-0.5 * torch.square(w * (om + l * om_s)))
            lam_d = s if lam_d is None else lam_d + s
        lam_d = lam_d / dx
        if d == 0:
            lam_d = lam_d * torch.square(theta[..., 0:1])
        lams.append(lam_d)
    return _add_shift(_outer(lams), shift, op.ndim)


def kron_circulant_spectrum_analytic(kernel, op: KronOperator, shift, aliases: int = 2):
    """Analytic torus spectrum of the separable ARD-SE kernel: each factor's
    periodized spectrum from the 1-D SE Poisson sum over the full fft
    frequency grid, h^2 on factor 0, their outer product plus the additive
    noise.  Exact tail decay in float32."""
    if not isinstance(kernel, ARDGaussianKernel):
        raise NotImplementedError("analytic Kronecker spectrum supports ARDGaussianKernel; "
                                  f"got {type(kernel).__name__}")
    return _spectrum_analytic(_theta(kernel, op), op, shift, aliases)


def kron_whittle_spectrum_params(kernel_template, theta, noise, op: KronOperator,
                                 jitter: float = 0.0, spectrum: str = "auto"):
    """``kron_whittle_spectrum`` at parameters ``theta`` (1 + D,) with a
    scalar noise, or (C, 1 + D) with noise (C, 1); differentiable by
    autograd."""
    _check(kernel_template, op)
    g = op.axes[0]
    shift = torch.square(torch.as_tensor(noise, dtype=g.dtype, device=g.device)) + jitter
    if spectrum in ("auto", "analytic"):
        return _spectrum_analytic(theta, op, shift)
    return kron_circulant_spectrum(_columns(theta, op), shift)


def kron_whittle_spectrum(kernel, op: KronOperator, noise, jitter: float = 0.0,
                          spectrum: str = "auto") -> torch.Tensor:
    """Grid-shaped torus spectrum of the Kronecker Whittle density: "auto" and
    "analytic" the closed-form ARD-SE spectrum, "fft" the per-factor FFT of
    the wrapped columns."""
    _check(kernel, op)
    return kron_whittle_spectrum_params(kernel, _theta(kernel, op), noise, op, jitter,
                                        spectrum)


def _kron_circulant_apply(lam: torch.Tensor, power: float):
    """v -> F^-1 diag(lam^power) F v over the D-dim grid; v (n,) or (n, r)."""
    lp = torch.pow(lam, power)
    sizes = lam.shape
    dims = tuple(range(len(sizes)))

    def apply(v):
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        r = v2.shape[1]
        t = v2.reshape(*sizes, r)
        ft = torch.fft.fftn(t, dim=dims)
        out = torch.fft.ifftn(ft * lp[..., None], dim=dims).real
        out = out.reshape(-1, r).to(v2.dtype)
        return out[:, 0] if squeeze else out

    return apply


def kron_circulant_precond(cols, shift):
    """v -> P^-1 v, P = Kronecker-Strang circulant + shift I."""
    return _kron_circulant_apply(kron_circulant_spectrum(cols, shift), -1.0)


def slq_terms_kron_circulant(matvec, cols, shift, generator, num_probes: int,
                             num_iters: int):
    """(logdet(P), per-probe terms (r,)) of ``slq_logdet_kron_circulant``."""
    draws = krylov.as_draws(generator)
    lam = kron_circulant_spectrum(cols, shift)
    pre = _kron_circulant_apply(lam, -1.0)
    half = _kron_circulant_apply(lam, 0.5)
    n = lam.numel()
    probes = half(draws.normal((n, num_probes), lam.dtype, lam.device))
    _, _, alphas, betas = krylov.pcg(matvec, pre, probes, num_iters=num_iters, tol=1e-12,
                                     return_tridiag=True)
    probe_norms = torch.sum(probes * pre(probes), dim=0)
    # physical Ritz floor (see toeplitz.slq_terms_circulant)
    floor = torch.as_tensor(shift, dtype=lam.dtype, device=lam.device) / torch.max(lam)
    terms = probe_norms * toeplitz._slq_floor_quadratures(alphas, betas, floor)
    return torch.sum(torch.log(lam)), terms


def slq_logdet_kron_circulant(matvec, cols, shift, generator, num_probes: int,
                              num_iters: int):
    """logdet(A) by circulant-preconditioned SLQ on the D-dim grid: the
    identity of ``toeplitz.slq_logdet_circulant`` with P = ((x)_d C_d) +
    shift I, exact logdet(P) = sum log lam over the full grid."""
    logdet_p, terms = slq_terms_kron_circulant(matvec, cols, shift, generator, num_probes,
                                               num_iters)
    return logdet_p + torch.mean(terms)


def fft_periodogram(y: torch.Tensor, op: KronOperator) -> torch.Tensor:
    """|fftn(y over the grid)|^2, grid-shaped."""
    fy = torch.fft.fftn(y.reshape(op.shape))
    return torch.square(fy.real) + torch.square(fy.imag)


def whittle_log_marginal_kron(kernel, op: KronOperator, y, noise, jitter: float = 0.0,
                              spectrum: str = "auto") -> torch.Tensor:
    """EXACT log-density of the D-dim torus (Kronecker-circulant) model:

        lml_W = -1/2 sum_k [ |Y^_k|^2 / (n lam_k) + log lam_k ] - (n/2) log 2pi

    with Y^ = fftn(y over the grid), the sum over all n bins of the full
    complex FFT.  Each dimension's ends are neighbours, as in 1-D.
    """
    g = op.axes[0]
    y = torch.as_tensor(y, dtype=g.dtype, device=g.device)
    n = op.n
    lam = kron_whittle_spectrum(kernel, op, noise, jitter, spectrum)
    quad = torch.sum(fft_periodogram(y, op) / lam) / n
    logdet = torch.sum(torch.log(lam))
    return -0.5 * quad - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)
