"""Rational-quadratic covariance kernel.

Counterpart of ``gaussian_processes_tpu/models/rq.py``:

  k(d) = h^2 (1 + d^2 / (2 a w^2))^(-a),   theta = (h, w, a)

a is the scale-mixture parameter (a -> inf recovers SE).  With
z = d^2/(2w^2) and B = 1 + z/a:

  k_w  = 2 h^2 z B^(-a-1) / w
  k_a  = h^2 B^(-a) (z/(aB) - ln B)
  k_ww = 2 h^2 z B^(-a-2) (2(a+1)z/a - 3B) / w^2
  k_wa = 2 h^2 z B^(-a-1) ((a+1)z/(a^2 B) - ln B) / w
       = 2 h^2 z B^(-a-1) (z/(aB) - ln B + z/(a^2 B)) / w
  k_aa = h^2 B^(-a) ((z/(aB) - ln B)^2 + z^2/(a^3 B^2))

The derivatives take ln B = log1p(z/a), B^(-a) = exp(-a ln B) and
z/(aB) - ln B as its series below z/a = 1/16 (``_terms``): at large a, B
rounds away z/a's digits and the difference cancels, which left float32
type-II MLE with RQ (a -> 1e3) far from its optimum.  The CUDA form is
``gp::RQForm`` in csrc/closed_forms.cuh.
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.models.base import Kernel


class RationalQuadraticKernel(Kernel):
    """RQ kernel with output scale h, lengthscale w, mixture parameter a."""

    param_names = ("h", "w", "a")
    cuda_family = 4

    def __init__(self, h, w, a, *, dtype=None, device=None):
        super().__init__(h, w, a, dtype=dtype, device=device)

    @classmethod
    def sym_K(cls):
        import sympy as sp

        d, h, w, a = sp.symbols("d h w a", positive=True)
        return h ** 2 * (1 + d ** 2 / (2 * a * w ** 2)) ** (-a), d, (h, w, a)

    @staticmethod
    def k_fn(d, h, w, a):
        z = d * d / (2.0 * w * w)
        return (h * h) * torch.pow(1.0 + z / a, -a)

    @staticmethod
    def _terms(d, w, a):
        """(z, B, B^(-a), ln B, C = z/(aB) - ln B) with q = z/a: ln B =
        log1p(q), and below q = 1/16 C = -q^2/2 + 2q^3/3 - ... to q^9
        (float32) or q^16 (float64)."""
        z = d * d / (2.0 * w * w)
        q = z / a
        lnB = torch.log1p(q)
        B = 1.0 + q
        Bma = torch.exp(-a * lnB)
        series = torch.zeros_like(q)
        for k in range(9 if q.dtype == torch.float32 else 16, 1, -1):
            series = series * q + (-1) ** (k + 1) * (k - 1) / k
        C = torch.where(q < 0.0625, series * q * q, q / B - lnB)
        return z, B, Bma, lnB, C

    @staticmethod
    def jac_fn(d, h, w, a):
        z, B, Bma, _, C = RationalQuadraticKernel._terms(d, w, a)
        Bma1 = Bma / B
        dh = 2.0 * h * Bma
        dw = 2.0 * (h * h) * z * Bma1 / w
        da = (h * h) * Bma * C
        return (dh, dw, da)

    @staticmethod
    def hess_fn(d, h, w, a):
        z, B, Bma, lnB, C = RationalQuadraticKernel._terms(d, w, a)
        Bma1 = Bma / B
        Bma2 = Bma1 / B
        h2 = h * h
        k_hh = 2.0 * Bma
        k_hw = 4.0 * h * z * Bma1 / w
        k_ha = 2.0 * h * Bma * C
        k_ww = 2.0 * h2 * z * Bma2 * (2.0 * (a + 1.0) * z / a - 3.0 * B) / (w * w)
        # (a + 1) z / (a^2 B) - ln B = C + z / (a^2 B)
        k_wa = 2.0 * h2 * z * Bma1 * (C + z / (a * a * B)) / w
        k_aa = h2 * Bma * (C * C + z * z / (a ** 3 * B * B))
        return (k_hh, k_hw, k_ha, k_ww, k_wa, k_aa)
