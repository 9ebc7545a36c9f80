"""Matérn covariance kernels (nu = 3/2 and 5/2).

Counterpart of ``gaussian_processes_tpu/models/matern.py``.  With
u = c |d| / w (c = sqrt(3) or sqrt(5)) and E = exp(-u):

  nu=3/2:  k = h^2 (1 + u) E
    k_w  = h^2 u^2 E / w
    k_ww = h^2 u^2 (u - 3) E / w^2

  nu=5/2:  k = h^2 (1 + u + u^2/3) E
    k_w  = h^2 u^2 (1 + u) E / (3 w)
    k_ww = h^2 u^2 (u^2 - 3u - 3) E / (3 w^2)

(u depends on w as u' = -u/w; the cross terms with h are the 2h / h^2
scalings.)  The CUDA forms are ``gp::Matern32Form`` and
``gp::Matern52Form`` in csrc/closed_forms.cuh.
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.models.base import Kernel

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


class Matern32Kernel(Kernel):
    """Matérn nu=3/2 with output scale h and lengthscale w."""

    param_names = ("h", "w")
    cuda_family = 2

    def __init__(self, h, w, *, dtype=None, device=None):
        super().__init__(h, w, dtype=dtype, device=device)

    @classmethod
    def sym_K(cls):
        import sympy as sp

        # d must stay real (not positive) or sympy folds Abs(d) -> d
        d = sp.symbols("d", real=True)
        h, w = sp.symbols("h w", positive=True)
        u = sp.sqrt(3) * sp.Abs(d) / w
        return h ** 2 * (1 + u) * sp.exp(-u), d, (h, w)

    @staticmethod
    def k_fn(d, h, w):
        u = _SQRT3 * torch.abs(d) / w
        return (h * h) * (1.0 + u) * torch.exp(-u)

    @staticmethod
    def jac_fn(d, h, w):
        u = _SQRT3 * torch.abs(d) / w
        E = torch.exp(-u)
        dh = 2.0 * h * (1.0 + u) * E
        dw = (h * h) * u * u * E / w
        return (dh, dw)

    @staticmethod
    def hess_fn(d, h, w):
        u = _SQRT3 * torch.abs(d) / w
        E = torch.exp(-u)
        hh = 2.0 * (1.0 + u) * E
        hw = 2.0 * h * u * u * E / w
        ww = (h * h) * u * u * (u - 3.0) * E / (w * w)
        return (hh, hw, ww)


class Matern52Kernel(Kernel):
    """Matérn nu=5/2 with output scale h and lengthscale w."""

    param_names = ("h", "w")
    cuda_family = 3

    def __init__(self, h, w, *, dtype=None, device=None):
        super().__init__(h, w, dtype=dtype, device=device)

    @classmethod
    def sym_K(cls):
        import sympy as sp

        d = sp.symbols("d", real=True)
        h, w = sp.symbols("h w", positive=True)
        u = sp.sqrt(5) * sp.Abs(d) / w
        return h ** 2 * (1 + u + u ** 2 / 3) * sp.exp(-u), d, (h, w)

    @staticmethod
    def k_fn(d, h, w):
        u = _SQRT5 * torch.abs(d) / w
        return (h * h) * (1.0 + u + u * u / 3.0) * torch.exp(-u)

    @staticmethod
    def jac_fn(d, h, w):
        u = _SQRT5 * torch.abs(d) / w
        E = torch.exp(-u)
        dh = 2.0 * h * (1.0 + u + u * u / 3.0) * E
        dw = (h * h) * u * u * (1.0 + u) * E / (3.0 * w)
        return (dh, dw)

    @staticmethod
    def hess_fn(d, h, w):
        u = _SQRT5 * torch.abs(d) / w
        E = torch.exp(-u)
        hh = 2.0 * (1.0 + u + u * u / 3.0) * E
        hw = 2.0 * h * u * u * (1.0 + u) * E / (3.0 * w)
        ww = (h * h) * u * u * (u * u - 3.0 * u - 3.0) * E / (3.0 * w * w)
        return (hh, hw, ww)
