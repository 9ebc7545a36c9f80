"""ARD (automatic relevance determination) squared-exponential kernel.

Counterpart of ``gaussian_processes_tpu/models/ard.py``.  Inputs are (n, D)
tensors; theta = (h, w_1..w_D), P = 1 + D:

    k(x, x') = h^2 exp(-1/2 sum_d (x_d - x'_d)^2 / w_d^2)

With s_d = diff_d^2 / w_d^2, E = exp(-1/2 sum_d s_d), t_d = s_d / w_d:

    dK/dh          = 2 h E
    dK/dw_d        = h^2 E t_d
    d2K/dh2        = 2 E
    d2K/dh dw_d    = 2 h E t_d
    d2K/dw_d dw_e  = h^2 E (t_d t_e - delta_de 3 s_d / w_d^2)

``forward`` builds K through ``ops.pairwise.pairwise_matrix_ard``, which is
kernel B6 on a CUDA card; the derivatives are plain tensor code, as in the
JAX package.  The 1-D closed-form switch of csrc/closed_forms.cuh does not
apply (``cuda_family = None``).
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.models.base import Kernel


class ARDGaussianKernel(Kernel):
    """Squared-exponential with output scale h and lengthscales w (D,)."""

    param_names = ("h", "w")  # informational; params is (1 + D,)
    cuda_family = None

    def __init__(self, h, w, *, dtype=None, device=None):
        torch.nn.Module.__init__(self)
        w = torch.as_tensor(w, dtype=dtype, device=device)
        if w.ndim != 1:
            raise ValueError(f"w must be a (D,) vector, got shape {tuple(w.shape)}")
        if dtype is None:  # a Python-number h takes w's dtype
            dtype = torch.promote_types(h.dtype, w.dtype) if torch.is_tensor(h) else w.dtype
        h = torch.as_tensor(h, dtype=dtype, device=w.device)
        self.register_buffer("h", h.reshape(()))
        self.register_buffer("w", w.to(dtype=dtype))

    # -- parameter vector interface (h scalar + w vector) -------------------

    @property
    def n_params(self) -> int:
        return 1 + self.w.shape[0]

    @property
    def params(self) -> torch.Tensor:
        return torch.cat([self.h[None], self.w])

    @classmethod
    def from_params(cls, theta) -> "ARDGaussianKernel":
        theta = torch.as_tensor(theta)
        return cls(theta[0], theta[1:])

    # -- evaluation ----------------------------------------------------------

    @classmethod
    def sym_K(cls):
        raise NotImplementedError("ARD kernels are validated against autodiff, not sympy")

    @staticmethod
    def k_fn(d, h, w):
        raise NotImplementedError("ARD kernels act on (n, D) inputs")

    @staticmethod
    def jac_fn(d, h, w):
        raise NotImplementedError("ARD kernels act on (n, D) inputs")

    @staticmethod
    def hess_fn(d, h, w):
        raise NotImplementedError("ARD kernels act on (n, D) inputs")

    def _sq(self, x1, x2):
        """Per-dimension scaled squared differences s, shape (n, m, D)."""
        x1 = torch.atleast_2d(torch.as_tensor(x1))
        x2 = torch.atleast_2d(torch.as_tensor(x2, device=x1.device))
        diff = x1[:, None, :] - x2[None, :, :]
        return torch.square(diff) / torch.square(self.w)[None, None, :]

    def forward(self, x1, x2):
        from gaussian_processes_tpu_torch.ops.pairwise import pairwise_matrix_ard

        return pairwise_matrix_ard(self, x1, x2)

    def kdiag(self, xo):
        xo = torch.as_tensor(xo)
        return torch.square(self.h).to(device=xo.device, dtype=xo.dtype).expand(xo.shape[0])

    def jacobian(self, x1, x2):
        s = self._sq(x1, x2)  # (n, m, D)
        E = torch.exp(-0.5 * torch.sum(s, dim=-1))
        h2E = torch.square(self.h) * E
        t = s / self.w[None, None, :]  # (n, m, D)
        dh = 2.0 * self.h * E
        dw = h2E[:, :, None] * t  # (n, m, D)
        return torch.cat([dh[None], torch.movedim(dw, -1, 0)], dim=0)  # (1 + D, n, m)

    def hessian_pair(self, x1, x2, p, q):
        """One (n, m) plane H[p, q]; builds only the requested slice."""
        i, j = (p, q) if p <= q else (q, p)
        s = self._sq(x1, x2)  # (n, m, D)
        E = torch.exp(-0.5 * torch.sum(s, dim=-1))
        if i == 0 and j == 0:
            return 2.0 * E
        t = s / self.w[None, None, :]
        if i == 0:  # h x w_{j-1} cross term
            return 2.0 * self.h * E * t[..., j - 1]
        d_, e_ = i - 1, j - 1
        h2E = torch.square(self.h) * E
        val = h2E * t[..., d_] * t[..., e_]
        if d_ == e_:
            val = val - h2E * 3.0 * s[..., d_] / torch.square(self.w[d_])
        return val

    def hessian(self, x1, x2):
        s = self._sq(x1, x2)
        E = torch.exp(-0.5 * torch.sum(s, dim=-1))
        h = self.h
        h2E = torch.square(h) * E
        t = s / self.w[None, None, :]  # (n, m, D)
        D = self.w.shape[0]
        n, m = E.shape

        hh = 2.0 * E  # (n, m)
        hw = 2.0 * h * E[:, :, None] * t  # (n, m, D)
        tt = torch.einsum("nmd,nme->nmde", t, t)  # t_d t_e
        corr = 3.0 * s / torch.square(self.w)[None, None, :]  # 3 s_d / w_d^2
        eye = torch.eye(D, dtype=E.dtype, device=E.device)[None, None]
        ww = h2E[:, :, None, None] * (tt - eye * corr[:, :, :, None])

        H = E.new_zeros((1 + D, 1 + D, n, m))
        H[0, 0] = hh
        H[0, 1:] = torch.movedim(hw, -1, 0)
        H[1:, 0] = torch.movedim(hw, -1, 0)
        H[1:, 1:] = torch.movedim(ww, (-2, -1), (0, 1))
        return H
