"""Rational-quadratic covariance kernel.

Counterpart of ``gaussian_processes_tpu/models/rq.py``:

  k(d) = h^2 (1 + d^2 / (2 a w^2))^(-a),   theta = (h, w, a)

a is the scale-mixture parameter (a -> inf recovers SE).  With
z = d^2/(2w^2) and B = 1 + z/a:

  k_w  = 2 h^2 z B^(-a-1) / w
  k_a  = h^2 B^(-a) (z/(aB) - ln B)
  k_ww = 2 h^2 z B^(-a-2) (2(a+1)z/a - 3B) / w^2
  k_wa = 2 h^2 z B^(-a-1) ((a+1)z/(a^2 B) - ln B) / w
  k_aa = h^2 B^(-a) ((z/(aB) - ln B)^2 + z^2/(a^3 B^2))

The CUDA form is ``gp::RQForm`` in csrc/closed_forms.cuh.
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

    @staticmethod
    def k_fn(d, h, w, a):
        z = d * d / (2.0 * w * w)
        return (h * h) * torch.pow(1.0 + z / a, -a)

    @staticmethod
    def jac_fn(d, h, w, a):
        z = d * d / (2.0 * w * w)
        B = 1.0 + z / a
        Bma = torch.pow(B, -a)
        Bma1 = Bma / B
        lnB = torch.log(B)
        dh = 2.0 * h * Bma
        dw = 2.0 * (h * h) * z * Bma1 / w
        da = (h * h) * Bma * (z / (a * B) - lnB)
        return (dh, dw, da)

    @staticmethod
    def hess_fn(d, h, w, a):
        z = d * d / (2.0 * w * w)
        B = 1.0 + z / a
        Bma = torch.pow(B, -a)
        Bma1 = Bma / B
        Bma2 = Bma1 / B
        lnB = torch.log(B)
        C = z / (a * B) - lnB
        h2 = h * h
        k_hh = 2.0 * Bma
        k_hw = 4.0 * h * z * Bma1 / w
        k_ha = 2.0 * h * Bma * C
        k_ww = 2.0 * h2 * z * Bma2 * (2.0 * (a + 1.0) * z / a - 3.0 * B) / (w * w)
        k_wa = 2.0 * h2 * z * Bma1 * ((a + 1.0) * z / (a * a * B) - lnB) / w
        k_aa = h2 * Bma * (C * C + z * z / (a ** 3 * B * B))
        return (k_hh, k_hw, k_ha, k_ww, k_wa, k_aa)
