"""Periodic covariance kernel.

Counterpart of ``gaussian_processes_tpu/models/periodic.py``:

    k(x1, x2) = h^2 * exp(-2 sin^2(d / (2 p)) / w^2),   theta = (h, w, p)

Derivation: write K = h^2 e^g with u = d/(2p), g = -2 sin^2(u) / w^2:

    g_w  =  4 sin^2(u) / w^3
    g_p  =  d sin(2u) / (w^2 p^2)
    g_ww = -12 sin^2(u) / w^4
    g_wp = -2 d sin(2u) / (w^3 p^2)
    g_pp = -d (d cos(2u) / p + 2 sin(2u)) / (w^2 p^3)

    K_h = 2 h e^g            K_hh = 2 e^g
    K_w = h^2 e^g g_w        K_hw = 2 h e^g g_w      K_hp = 2 h e^g g_p
    K_p = h^2 e^g g_p        K_ww = h^2 e^g (g_w^2 + g_ww)
    K_wp = h^2 e^g (g_w g_p + g_wp)
    K_pp = h^2 e^g (g_p^2 + g_pp)

The CUDA form is ``gp::PeriodicForm`` in csrc/closed_forms.cuh.
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.models.base import Kernel


class PeriodicKernel(Kernel):
    """Periodic kernel with output scale h, lengthscale w, period p."""

    param_names = ("h", "w", "p")
    cuda_family = 1

    def __init__(self, h, w, p, *, dtype=None, device=None):
        super().__init__(h, w, p, dtype=dtype, device=device)

    @classmethod
    def sym_K(cls):
        import sympy as sp

        d, h, w, p = sp.symbols("d h w p", positive=True)
        return h ** 2 * sp.exp(-2 * sp.sin(d / (2 * p)) ** 2 / w ** 2), d, (h, w, p)

    @staticmethod
    def k_fn(d, h, w, p):
        s = torch.sin(d / (2.0 * p))
        return (h * h) * torch.exp(-2.0 * s * s / (w * w))

    @staticmethod
    def jac_fn(d, h, w, p):
        u = d / (2.0 * p)
        s = torch.sin(u)
        s2u = torch.sin(2.0 * u)
        iw2 = 1.0 / (w * w)
        E = torch.exp(-2.0 * s * s * iw2)
        g_w = 4.0 * s * s * iw2 / w
        g_p = d * s2u * iw2 / (p * p)
        dh = 2.0 * h * E
        dw = (h * h) * E * g_w
        dp = (h * h) * E * g_p
        return (dh, dw, dp)

    @staticmethod
    def hess_fn(d, h, w, p):
        u = d / (2.0 * p)
        s = torch.sin(u)
        s2u = torch.sin(2.0 * u)
        c2u = torch.cos(2.0 * u)
        iw2 = 1.0 / (w * w)
        ip = 1.0 / p
        E = torch.exp(-2.0 * s * s * iw2)
        h2E = (h * h) * E

        g_w = 4.0 * s * s * iw2 / w
        g_p = d * s2u * iw2 * ip * ip
        g_ww = -12.0 * s * s * iw2 * iw2
        g_wp = -2.0 * d * s2u * iw2 / w * ip * ip
        g_pp = -d * (d * c2u * ip + 2.0 * s2u) * iw2 * ip * ip * ip

        k_hh = 2.0 * E
        k_hw = 2.0 * h * E * g_w
        k_hp = 2.0 * h * E * g_p
        k_ww = h2E * (g_w * g_w + g_ww)
        k_wp = h2E * (g_w * g_p + g_wp)
        k_pp = h2E * (g_p * g_p + g_pp)
        return (k_hh, k_hw, k_hp, k_ww, k_wp, k_pp)
