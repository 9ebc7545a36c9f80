"""Squared-exponential ("Gaussian") covariance kernel.

Counterpart of ``gaussian_processes_tpu/models/gaussian.py``:

    k(x1, x2) = h^2 * exp(-(x1 - x2)^2 / (2 w^2)),   theta = (h, w)

Derivatives (E = exp(-d^2 / (2 w^2)), d = x1 - x2):

    dK/dh   = 2 h E                 d2K/dh2  = 2 E
    dK/dw   = h^2 E d^2 / w^3       d2K/dhdw = 2 h E d^2 / w^3
    d2K/dw2 = h^2 E (d^4 / w^6 - 3 d^2 / w^4)

The CUDA form is ``gp::SEForm`` in csrc/closed_forms.cuh.
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.models.base import Kernel


class GaussianKernel(Kernel):
    """Squared-exponential kernel with output scale h and lengthscale w."""

    param_names = ("h", "w")
    cuda_family = 0

    def __init__(self, h, w, *, dtype=None, device=None):
        super().__init__(h, w, dtype=dtype, device=device)

    @classmethod
    def sym_K(cls):
        import sympy as sp

        d, h, w = sp.symbols("d h w", positive=True)
        return h ** 2 * sp.exp(-(d ** 2) / (2 * w ** 2)), d, (h, w)

    @staticmethod
    def k_fn(d, h, w):
        iw2 = 1.0 / (w * w)
        return (h * h) * torch.exp(-0.5 * d * d * iw2)

    @staticmethod
    def jac_fn(d, h, w):
        d2 = d * d
        iw2 = 1.0 / (w * w)
        E = torch.exp(-0.5 * d2 * iw2)
        dh = 2.0 * h * E
        dw = (h * h) * E * d2 * iw2 / w
        return (dh, dw)

    @staticmethod
    def hess_fn(d, h, w):
        d2 = d * d
        iw2 = 1.0 / (w * w)
        iw3 = iw2 / w
        E = torch.exp(-0.5 * d2 * iw2)
        hh = 2.0 * E
        hw = 2.0 * h * E * d2 * iw3
        ww = (h * h) * E * (d2 * d2 * iw3 * iw3 - 3.0 * d2 * iw2 * iw2)
        return (hh, hw, ww)
