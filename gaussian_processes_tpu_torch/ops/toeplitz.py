"""Toeplitz-structured kernel algebra for uniform 1-D grids (FFT matvecs).

Counterpart of ``gaussian_processes_tpu/ops/toeplitz.py``.  On an evenly
spaced grid every stationary kernel matrix is symmetric Toeplitz,
K[i, j] = k((i - j) dx), fully described by its first column, so a matvec is
a circulant-embedding FFT product, O(n log n):

    embed col into a length-2n circulant   c = [col, 0, col[n-1:0:-1]]
    (T v) = irfft(rfft(c) * rfft([v, 0]))[:n]

dK/dtheta_p of a stationary kernel is stationary too, so the Hutchinson
trace terms of the matrix-free gradient are FFT products of the Jacobian
columns.  The Strang circulant (the column wrapped at n/2) preconditions a
Toeplitz system in one more FFT pair, and its spectrum defines the Whittle
likelihood: the exact log-density of the circulant model, three FFT and
elementwise operations per evaluation.

The FFTs are ``torch.fft`` (cuFFT on a card), as the JAX package leaves
them to XLA.  The first column comes from the kernel's K (kernel B1 at the
(n, 1) shape on a card), the Jacobian columns from its dK/dtheta (kernel B2a
at (P, n, 1)).

The spectra take their parameters as a tensor ``theta`` of shape (P,) or
(C, P) (C chains, ``whittle_spectrum_params``), differentiable by autograd:
the analytic spectra are tensor expressions in theta; the FFT spectrum is
the FFT of the column with its derivative, the FFT of the Jacobian columns,
attached linearly (the spectrum is linear in the column).  The quasi-periodic
spectrum rematerializes each chunk of harmonics in the backward pass
(``torch.utils.checkpoint``): without it the gradient keeps every harmonic's
intermediates, which the JAX package measured at 53 GB at n = 2^20.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gaussian_processes_tpu_torch.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu_torch.models.gaussian import GaussianKernel
from gaussian_processes_tpu_torch.models.matern import Matern32Kernel, Matern52Kernel
from gaussian_processes_tpu_torch.models.periodic import PeriodicKernel
from gaussian_processes_tpu_torch.ops import krylov

_SQRT_2PI = math.sqrt(2.0 * math.pi)
#: harmonics per rematerialized chunk of the quasi-periodic spectrum
_QP_CHUNK = 4


def is_uniform_grid(x, rtol: float | None = None) -> bool:
    """Host-side check that ``x`` is sorted and evenly spaced.

    The default tolerance adapts to the dtype: an exactly uniform grid
    stored in float32 carries spacing jitter up to ~eps * max|x|, which can
    exceed a fixed 1e-5 of dx on fine grids.
    """
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.ndim != 1 or x.shape[0] < 2:
        return False
    d = np.diff(x)
    dx = d.mean()
    if dx == 0:
        return False
    if rtol is None:
        eps = np.finfo(x.dtype).eps if np.issubdtype(x.dtype, np.floating) \
            else np.finfo(np.float64).eps
        rtol = max(1e-5, 4.0 * eps * float(np.max(np.abs(x))) / abs(dx))
    return bool(np.max(np.abs(d - dx)) <= rtol * abs(dx))


def toeplitz_column(kernel, x: torch.Tensor) -> torch.Tensor:
    """First column of K_f(x, x) for a uniform grid x: col[i] = k(x_i - x_0)."""
    x = torch.as_tensor(x)
    return kernel(x, x[:1])[:, 0]


def jacobian_columns(kernel, x: torch.Tensor) -> torch.Tensor:
    """First columns of dK/dtheta_p, shape (P, n), each Toeplitz too."""
    x = torch.as_tensor(x)
    return kernel.jacobian(x, x[:1])[:, :, 0]


def _embed_fft(col: torch.Tensor) -> torch.Tensor:
    """rfft of the length-2n circulant embedding of a symmetric Toeplitz."""
    emb = torch.cat([col, col.new_zeros((1,)), col[1:].flip(0)])
    return torch.fft.rfft(emb)


def toeplitz_matvec(col: torch.Tensor, v: torch.Tensor, shift=0.0) -> torch.Tensor:
    """(T + shift I) @ v for symmetric Toeplitz T with first column ``col``.

    ``v``: (n,) or (n, r).  One length-2n rfft/irfft pair.
    """
    n = col.shape[0]
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    fc = _embed_fft(col)  # (n + 1,) complex
    fv = torch.fft.rfft(v2, n=2 * n, dim=0)  # zero-padded to 2n
    out = torch.fft.irfft(fc[:, None] * fv, n=2 * n, dim=0)[:n]
    out = out.to(v2.dtype) + torch.as_tensor(shift, dtype=v2.dtype, device=v2.device) * v2
    return out[:, 0] if squeeze else out


def kernel_matvec_toeplitz(kernel, x, v, noise, jitter: float = 0.0) -> torch.Tensor:
    """(K_f(x, x) + (noise^2 + jitter) I) @ v on a uniform grid; the
    counterpart of ``krylov.kernel_matvec`` when ``is_uniform_grid(x)``."""
    col = toeplitz_column(kernel, x)
    shift = torch.square(torch.as_tensor(noise, dtype=col.dtype, device=col.device)) + jitter
    return toeplitz_matvec(col, v, shift)


def _wrap_index(n: int, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    return torch.where(idx <= n // 2, idx, n - idx)


def _spd_guard(lam: torch.Tensor) -> torch.Tensor:
    # absolute SPD guard: with shift == 0 (noise = jitter = 0) rectified
    # bins are exactly 0, and lam^-1 / log(lam) would be infinite
    return torch.clamp_min(lam, torch.finfo(lam.dtype).tiny)


def circulant_eigenvalues(col: torch.Tensor, shift) -> torch.Tensor:
    """Spectrum of P = C_s + shift I (Strang circulant), noise ADDITIVE.

    The wrap-around column keeps lags up to n/2 and reflects the rest; the
    kernel part's eigenvalues are the real DFT of that column.  Negative
    kernel eigenvalues (truncated tails, FFT round-off) are rectified at zero
    and ``shift``, the noise variance plus jitter, is added after, so it is
    never clamped away (a relative floor lands at the noise level at
    n ~ 1e6 and erases the noise from the high-frequency bins).
    """
    lam_k = torch.fft.rfft(col[_wrap_index(col.shape[0], col.device)]).real
    shift = torch.as_tensor(shift, dtype=col.dtype, device=col.device)
    return _spd_guard(torch.clamp_min(lam_k, 0.0) + shift)


# ---------------------------------------------------------------------------
# Analytic spectra.  ``theta`` holds a kernel's parameters in ``params``
# order, shape (P,) or (C, P); a column theta[..., i:i+1] broadcasts against
# a frequency vector to (m,) or (C, m).
# ---------------------------------------------------------------------------


def _col(theta: torch.Tensor, i: int) -> torch.Tensor:
    return theta[..., i:i + 1]


def _split(kernel, theta):
    p1 = kernel.k1.n_params
    return theta[..., :p1], theta[..., p1:]


def _density(kernel, theta, omega):
    """S(omega) of ``kernel`` at parameters ``theta``, or None."""
    if isinstance(kernel, GaussianKernel):
        h, w = _col(theta, 0), _col(theta, 1)
        return torch.square(h) * w * _SQRT_2PI * torch.exp(-0.5 * torch.square(w * omega))
    if isinstance(kernel, Matern32Kernel):
        h, w = _col(theta, 0), _col(theta, 1)
        return torch.square(h) * (12.0 * math.sqrt(3.0) / w ** 3) / torch.square(
            3.0 / torch.square(w) + torch.square(omega))
    if isinstance(kernel, Matern52Kernel):
        h, w = _col(theta, 0), _col(theta, 1)
        return torch.square(h) * (400.0 * math.sqrt(5.0) / 3.0 / w ** 5) / (
            5.0 / torch.square(w) + torch.square(omega)) ** 3
    if isinstance(kernel, SumKernel):
        t1, t2 = _split(kernel, theta)
        s1 = _density(kernel.k1, t1, omega)
        s2 = _density(kernel.k2, t2, omega)
        if s1 is None or s2 is None:
            return None
        return s1 + s2
    return None


def spectral_density(kernel, omega):
    """Continuous-FT spectral density S(w) with k(t) = (1/2pi) int S e^{iwt}.

    Returns None for families without a supported closed form (periodic: a
    line spectrum; RQ; products); sums map to sums.

      SE          h^2 w sqrt(2 pi) exp(-w^2 o^2 / 2)
      Matern-3/2  h^2 12 sqrt(3) / w^3 * (3/w^2 + o^2)^-2
      Matern-5/2  h^2 (400 sqrt(5) / 3) / w^5 * (5/w^2 + o^2)^-3
    """
    omega = torch.as_tensor(omega)
    theta = kernel.params.to(dtype=omega.dtype, device=omega.device)
    return _density(kernel, theta, omega)


def _log_bessel_i(q: torch.Tensor, c: torch.Tensor, num_terms: int = 80) -> torch.Tensor:
    """log I_q(c) by the ascending series, over integer orders q (Q,) and
    c of shape (1,) or (C, 1); returns (Q,) or (C, Q).  The port's own copy
    of ``models/pathwise.py::_log_bessel_i``: accurate for c <= ~60 with 80
    terms (lengthscales w >= ~0.13)."""
    m = torch.arange(num_terms, dtype=c.dtype, device=c.device)
    logc2 = torch.log(c / 2.0)[..., None]  # (..., 1, 1)
    terms = ((2.0 * m[None, :] + q[:, None]) * logc2 - torch.lgamma(m[None, :] + 1.0)
             - torch.lgamma(m[None, :] + q[:, None] + 1.0))
    return torch.logsumexp(terms, dim=-1)


def _periodic_weights(theta, num_harmonics: int, dtype):
    """(a_q, nu_q): harmonic variances (2x folded in for q >= 1) and line
    frequencies in rad of the periodic kernel's Jacobi-Anger expansion,
    each (Q + 1,) or (C, Q + 1)."""
    h, w, p = _col(theta, 0), _col(theta, 1), _col(theta, 2)
    c = 1.0 / (w * w)
    q = torch.arange(num_harmonics + 1, dtype=dtype, device=theta.device)
    logI = _log_bessel_i(q, c, num_terms=max(80, num_harmonics))
    a = torch.exp(2.0 * torch.log(h) - c + logI)
    a = a * torch.where(q == 0, 1.0, 2.0).to(dtype)
    return a, q / p


def _rfft_multiplicity(n: int, dtype, device) -> torch.Tensor:
    """Conjugate multiplicities of the n // 2 + 1 rfft bins: 2 interior, 1 at
    DC and (for even n) Nyquist."""
    m = n // 2 + 1
    w = torch.full((m,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    if n % 2 == 0:
        w[m - 1] = 1.0
    return w


def _line_bins(theta, n: int, dx, num_harmonics: int, dtype):
    a, nu = _periodic_weights(theta, num_harmonics, dtype)
    # folded line positions in rfft-bin units: f in cycles/sample
    f = nu * dx / (2.0 * math.pi)
    f = torch.remainder(f, 1.0)
    f = torch.minimum(f, 1.0 - f)  # [0, 1/2]
    t = f * n  # [0, n/2]
    k0 = torch.clamp(torch.floor(t).long(), 0, n // 2)
    frac = t - k0.to(dtype)
    k1 = torch.clamp_max(k0 + 1, n // 2)
    m = n // 2 + 1
    mult = _rfft_multiplicity(n, dtype, theta.device)
    lam = a.new_zeros(a.shape[:-1] + (m,))
    lam = lam.scatter_add(-1, k0, a * (1.0 - frac) * n / mult[k0])
    return lam.scatter_add(-1, k1, a * frac * n / mult[k1])


def periodic_line_bins(kernel, n: int, dx, num_harmonics: int = 256) -> torch.Tensor:
    """Exact folded line spectrum of the periodic kernel on n grid bins.

    k(d) = a_0 + sum_{q>=1} a_q cos(q d / p), a_0 = h^2 e^{-c} I_0(c),
    a_q = 2 h^2 e^{-c} I_q(c), c = 1/w^2.  Sampling at spacing dx folds each
    line exactly onto its aliased frequency in [0, pi/dx]; the circulant
    model assigns each line's variance to its two neighbouring rfft bins with
    linear weights (exact when the period is grid-commensurate).  A line of
    variance a at interior bin k contributes a n / w_k (w_k its conjugate
    multiplicity).  ``num_harmonics`` = 256 covers lengthscales w >= ~0.07
    (the truncated Bessel series' limit below that is the reference's own).
    Kernel part only (no noise shift).
    """
    dx = torch.as_tensor(dx)
    theta = kernel.params.to(dtype=dx.dtype, device=dx.device)
    return _line_bins(theta, n, dx, num_harmonics, dx.dtype)


def _quasi_periodic_bins(kp, thp, kc, thc, n: int, dx, dtype, aliases: int,
                         num_harmonics: int):
    a, nu = _periodic_weights(thp, num_harmonics, dtype)
    k = torch.arange(n // 2 + 1, dtype=dtype, device=thp.device)
    om = 2.0 * math.pi * k / (n * dx)
    om_s = 2.0 * math.pi / dx
    # every alias at once: (2 aliases + 1, m) shifted frequencies, reduced
    # over the alias axis; the parameters get an axis to broadcast over it
    l = torch.arange(-aliases, aliases + 1, dtype=dtype, device=thp.device)
    om_l = om[None, :] + l[:, None] * om_s

    def body(lam, a_chunk, nu_chunk, thc_):
        th = thc_[..., None, :]
        for j in range(a_chunk.shape[-1]):
            aq, nuq = a_chunk[..., j:j + 1], nu_chunk[..., j:j + 1, None]
            s = (torch.sum(_density(kc, th, om_l - nuq), dim=-2)
                 + torch.sum(_density(kc, th, om_l + nuq), dim=-2))
            lam = lam + 0.5 * aq * s
        return lam

    lam = a.new_zeros(torch.broadcast_shapes(a.shape[:-1], thc.shape[:-1]) + (n // 2 + 1,))
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (a, nu, thc))
    for start in range(0, num_harmonics + 1, _QP_CHUNK):
        sl = slice(start, start + _QP_CHUNK)
        if remat:
            lam = checkpoint(body, lam, a[..., sl], nu[..., sl], thc, use_reentrant=False)
        else:
            lam = body(lam, a[..., sl], nu[..., sl], thc)
    return lam / dx


def quasi_periodic_bins(kp, kc, n: int, dx, dtype, aliases: int, num_harmonics: int):
    """Analytic circulant bins of the QUASI-PERIODIC product kernel
    k = k_periodic * k_continuous, whose spectral density is

        S(o) = sum_q (a_q / 2) [S_c(o - nu_q) + S_c(o + nu_q)]

    (the line spectrum convolved with the continuous density), aliased by
    the Poisson sum over |l| <= ``aliases``.  Kernel part only.  The alias
    window is the reference's: a harmonic whose shifted density reaches past
    it is truncated."""
    dx = torch.as_tensor(dx)
    thp = kp.params.to(dtype=dtype, device=dx.device)
    thc = kc.params.to(dtype=dtype, device=dx.device)
    return _quasi_periodic_bins(kp, thp, kc, thc, n, dx, dtype, aliases, num_harmonics)


#: exp(-z) is exactly zero in float64 (and float32) past z ~ 745.1
_EXP_UNDERFLOW = 745.2


def _se_aliases_underflow(kernel, theta, om_s) -> bool:
    """Whether every alias |l| >= 1 of an SE density is exactly zero in every
    rfft bin, value and derivative.  Over the bins |o_k + l om_s| >= om_s / 2,
    so each such term is exp(-z) with z >= (w om_s / 2)^2 / 2 times finite
    factors; past twice the exponential's underflow it is +-0, adding it
    changes no bit of the alias sum, and its contribution to every gradient
    is 0.  So the sum skips them (at N = 2^20 and w = 0.006, z ~ 5e6): one
    host read of min(w) per evaluation for 16 fewer density evaluations."""
    if not isinstance(kernel, GaussianKernel):
        return False
    w_min = torch.min(torch.abs(theta[..., 1]))
    return bool(0.5 * torch.square(w_min * om_s / 2.0) > 2.0 * _EXP_UNDERFLOW)


def _analytic_kernel_bins(kernel, theta, n: int, dx, dtype, aliases: int, num_harmonics: int):
    """Kernel part of the analytic circulant spectrum at ``theta``, or None.
    Recursive over sums; a product is supported when one factor is periodic
    and the other has a continuous density (``quasi_periodic_bins``)."""
    if isinstance(kernel, PeriodicKernel):
        return _line_bins(theta, n, dx, num_harmonics, dtype)
    if isinstance(kernel, SumKernel):
        t1, t2 = _split(kernel, theta)
        a = _analytic_kernel_bins(kernel.k1, t1, n, dx, dtype, aliases, num_harmonics)
        b = _analytic_kernel_bins(kernel.k2, t2, n, dx, dtype, aliases, num_harmonics)
        if a is None or b is None:
            return None
        return a + b
    if isinstance(kernel, ProductKernel):
        t1, t2 = _split(kernel, theta)
        for kp, thp, kc, thc in ((kernel.k1, t1, kernel.k2, t2),
                                 (kernel.k2, t2, kernel.k1, t1)):
            if isinstance(kp, PeriodicKernel) and not isinstance(kc, PeriodicKernel):
                if _density(kc, thc, theta.new_zeros((1,))) is None:
                    return None
                return _quasi_periodic_bins(kp, thp, kc, thc, n, dx, dtype, aliases,
                                            num_harmonics)
        return None
    k = torch.arange(n // 2 + 1, dtype=dtype, device=theta.device)
    om = 2.0 * math.pi * k / (n * dx)
    om_s = 2.0 * math.pi / dx
    zero_aliases = _se_aliases_underflow(kernel, theta, om_s)
    lam = None
    for l in range(-aliases, aliases + 1):
        if l and zero_aliases:
            continue
        s = _density(kernel, theta, om + l * om_s)
        if s is None:
            return None
        lam = s if lam is None else lam + s
    return lam / dx


def _grid_step(x: torch.Tensor):
    return x.shape[0], x[1] - x[0]


def circulant_eigenvalues_analytic(kernel, x, shift, aliases: int = 8,
                                   num_harmonics: int = 256):
    """Periodized-kernel circulant spectrum from the ANALYTIC density.

    Poisson summation: lam_k = (1/dx) sum_l S(o_k + l 2 pi / dx), the alias
    sum truncated at |l| <= ``aliases`` (8 keeps the polynomial-tail Matérn
    spectra's truncation below 1e-4; SE converges at any count >= 1).  The
    periodic kernel folds exactly (``periodic_line_bins``); sums recurse.
    An analytic tail is evaluated directly, so the additive noise stays exact
    in every bin where a float32 FFT of the column would leave round-off of
    ~eps * lam_max.  Returns None without a supported spectrum.
    """
    x = torch.as_tensor(x)
    theta = kernel.params.to(dtype=x.dtype, device=x.device)
    return _analytic_spectrum(kernel, theta, x, shift, aliases, num_harmonics)


def _analytic_spectrum(kernel, theta, x, shift, aliases=8, num_harmonics=256):
    n, dx = _grid_step(x)
    lam = _analytic_kernel_bins(kernel, theta, n, dx, x.dtype, aliases, num_harmonics)
    if lam is None:
        return None
    return _spd_guard(lam + torch.as_tensor(shift, dtype=x.dtype, device=x.device))


def _fft_spectrum(kernel, theta, x, shift):
    """Strang-circulant spectrum from the kernel's column at ``theta``, with
    its derivative attached: the column's FFT is linear in the column, so
    d lam / d theta_p is the FFT of the Jacobian column p (zero where the
    bin was rectified)."""
    if theta.ndim == 2:
        return torch.stack([_fft_spectrum(kernel, t, x, s)
                            for t, s in zip(theta, torch.broadcast_to(
                                torch.as_tensor(shift, dtype=x.dtype, device=x.device),
                                (theta.shape[0], 1)))])
    kern = kernel.with_params(theta.detach())
    wrap = _wrap_index(x.shape[0], x.device)
    lam_k = torch.fft.rfft(toeplitz_column(kern, x)[wrap]).real
    lam = torch.clamp_min(lam_k, 0.0)
    if torch.is_grad_enabled() and theta.requires_grad:
        dlam = torch.fft.rfft(jacobian_columns(kern, x)[:, wrap], dim=-1).real  # (P, m)
        lam = lam + torch.where(lam_k > 0, (theta - theta.detach()) @ dlam, 0.0)
    return _spd_guard(lam + torch.as_tensor(shift, dtype=x.dtype, device=x.device))


def whittle_spectrum_params(kernel_template, theta, noise, x, jitter: float = 0.0,
                            spectrum: str = "auto") -> torch.Tensor:
    """``whittle_spectrum`` at kernel parameters ``theta`` (P,) with a scalar
    ``noise``, or (C, P) with noise (C, 1): (n//2 + 1,) or (C, n//2 + 1),
    differentiable in theta and noise by autograd."""
    x = torch.as_tensor(x)
    shift = torch.square(torch.as_tensor(noise, dtype=x.dtype, device=x.device)) + jitter
    if spectrum in ("auto", "analytic"):
        lam = _analytic_spectrum(kernel_template, theta, x, shift)
        if lam is not None:
            return lam
        if spectrum == "analytic":
            raise NotImplementedError(
                f"no closed-form spectral density for {type(kernel_template).__name__}; "
                "use spectrum='fft'")
        if x.shape[0] > 100_000:
            # the FFT spectrum's float32 round-off tail (~eps * lam_max) is
            # the order of a realistic noise variance at n ~ 1e6
            warnings.warn(
                f"whittle_spectrum: no analytic spectrum for {type(kernel_template).__name__}; "
                f"falling back to the FFT spectrum at n={x.shape[0]}, whose float32 round-off "
                "tail can bias the noise posterior at this scale.", stacklevel=2)
    return _fft_spectrum(kernel_template, theta, x, shift)


def whittle_spectrum(kernel, x, noise, jitter: float = 0.0, spectrum: str = "auto"):
    """The (n//2+1,) circulant spectrum the Whittle density uses.

    ``spectrum``: "auto" (analytic when the kernel has a closed-form density,
    else FFT), "analytic" (error if unsupported), "fft".  Shared by
    ``whittle_log_marginal`` and the centered posterior in
    inference/gp_model.py, so both describe the same model.
    """
    x = torch.as_tensor(x)
    theta = kernel.params.to(dtype=x.dtype, device=x.device)
    return whittle_spectrum_params(kernel, theta, noise, x, jitter, spectrum)


def _circulant_apply(lam: torch.Tensor, n: int, power: float):
    """v -> F^-1 diag(lam^power) F v, a symmetric circulant application."""
    lp = torch.pow(lam, power)

    def apply(v):
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        fv = torch.fft.rfft(v2, dim=0)
        out = torch.fft.irfft(fv * lp[:, None], n=n, dim=0).to(v2.dtype)
        return out[:, 0] if squeeze else out

    return apply


def strang_circulant_precond(col: torch.Tensor, shift):
    """v -> (C_s + shift I)^-1 v; O(n log n) build and apply.  Replaces the
    pivoted-Cholesky preconditioner on grids: CG only needs P ~ A."""
    lam = circulant_eigenvalues(col, shift)
    return _circulant_apply(lam, col.shape[0], -1.0)


def circulant_logdet(lam: torch.Tensor, n: int) -> torch.Tensor:
    """Exact logdet of the circulant from its rfft spectrum (interior bins
    count twice, DC and even-n Nyquist once)."""
    w = _rfft_multiplicity(n, lam.dtype, lam.device)
    return torch.sum(w * torch.log(lam), dim=-1)


def whittle_log_marginal(kernel, x, y, noise, jitter: float = 0.0, spectrum: str = "auto"):
    """EXACT log-density of the circulant surrogate model: the Whittle
    likelihood of GP regression on a uniform grid,

        lml_W = -1/2 sum_k w_k [ |y~_k|^2 / (n lam_k) + log lam_k ] - (n/2) log 2pi

    (y~ = rfft(y), lam from ``whittle_spectrum``, w_k the conjugate
    multiplicities).  The model is a stationary GP on the circle of
    circumference n dx: the two ends of the grid are neighbours, so use an
    endpoint-exclusive grid and data compatible with that boundary.
    """
    x = torch.as_tensor(x)
    lam = whittle_spectrum(kernel, x, noise, jitter, spectrum)
    return _whittle_from_spectrum(lam, torch.as_tensor(y, dtype=x.dtype, device=x.device))


def periodogram(y: torch.Tensor) -> torch.Tensor:
    """|rfft(y)|^2 (n times the periodogram)."""
    fy = torch.fft.rfft(y)
    return torch.square(fy.real) + torch.square(fy.imag)


def _whittle_from_spectrum(lam, y):
    n = y.shape[0]
    w = _rfft_multiplicity(n, lam.dtype, lam.device)
    quad = torch.sum(w * periodogram(y) / lam, dim=-1) / n
    logdet = torch.sum(w * torch.log(lam), dim=-1)
    return -0.5 * quad - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)


def _slq_floor_quadratures(alphas, betas, floor):
    T = krylov.lanczos_tridiag_from_cg(alphas, betas)
    evals, evecs = torch.linalg.eigh(T)
    w = torch.square(evecs[:, 0, :])
    return torch.sum(w * torch.log(torch.maximum(evals, floor)), dim=-1)


def slq_terms_circulant(matvec, col, shift, generator, num_probes: int, num_iters: int):
    """(logdet(P), per-probe terms (r,)) of ``slq_logdet_circulant``; the
    estimate is logdet(P) + mean(terms)."""
    draws = krylov.as_draws(generator)
    n = col.shape[0]
    lam = circulant_eigenvalues(col, shift)
    pre = _circulant_apply(lam, n, -1.0)
    half = _circulant_apply(lam, n, 0.5)
    probes = half(draws.normal((n, num_probes), col.dtype, col.device))
    _, _, alphas, betas = krylov.pcg(matvec, pre, probes, num_iters=num_iters, tol=1e-12,
                                     return_tridiag=True)
    probe_norms = torch.sum(probes * pre(probes), dim=0)
    # physical Ritz floor: the preconditioned operator's spectrum is
    # >= shift / max(lam), so anything below is float32 Lanczos round-off
    floor = torch.as_tensor(shift, dtype=lam.dtype, device=lam.device) / torch.max(lam)
    return circulant_logdet(lam, n), probe_norms * _slq_floor_quadratures(alphas, betas, floor)


def slq_logdet_circulant(matvec, col, shift, generator, num_probes: int, num_iters: int):
    """SLQ estimate of logdet(A) with Strang-circulant preconditioning:

        logdet(A) = logdet(P) + E_{z ~ N(0,P)}[(z^T P^-1 z) e1^T log(T) e1]

    logdet(P) exact from the spectrum, z = P^(1/2) u one FFT pair, T the PCG
    Lanczos tridiagonal.  ``generator``: a ``torch.Generator`` or a source of
    draws (``krylov.as_draws``); u is its next normal (n, num_probes) draw.
    """
    logdet_p, terms = slq_terms_circulant(matvec, col, shift, generator, num_probes, num_iters)
    return logdet_p + torch.mean(terms)
