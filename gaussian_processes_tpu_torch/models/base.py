"""Kernel base layer.

Counterpart of ``gaussian_processes_tpu/models/base.py``: an abstract kernel
over 1-D inputs with

* ``__call__(x1, x2) -> K``            (n, m) covariance matrix
* ``jacobian(x1, x2) -> dK/dtheta``    (P, n, m)
* ``hessian(x1, x2) -> d2K/dtheta2``   (P, P, n, m)
* ``hessian_pair(x1, x2, p, q)``       one (n, m) plane of the Hessian
* ``params`` / ``with_params(theta)`` (functional set), ``copy()``
* ``sym_K()``                          the sympy expression of k(d), which
  the tests hold the closed forms to

Kernels are ``nn.Module``s whose hyperparameters are registered buffers in
``param_names`` order, so ``kernel.to(device, dtype)`` moves and casts them.
The elementwise closed forms ``k_fn`` / ``jac_fn`` / ``hess_fn`` are static
tensor functions of the difference d = x1_i - x2_j; the plain PyTorch paths
in ``ops/pairwise.py`` evaluate them, and the CUDA kernels of
``csrc/closed_forms.cuh`` mirror them expression for expression.  The
matrix-building methods dispatch to ``ops/pairwise``: the CUDA kernels for
tensors on the card, the plain versions for tensors on the CPU.
"""

from __future__ import annotations

import abc

import torch
from torch import nn


def pairwise_diff(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise difference matrix d[i, j] = x1[i] - x2[j] for 1-D inputs."""
    return x1[:, None] - x2[None, :]


def tri_index(p: int, q: int, n_params: int) -> int:
    """Position of the pair (p, q) in ``hess_fn``'s row-major upper triangle."""
    i, j = (p, q) if p <= q else (q, p)
    return i * n_params - (i * (i - 1)) // 2 + (j - i)


class Kernel(nn.Module, metaclass=abc.ABCMeta):
    """Abstract covariance kernel over 1-D inputs.

    Subclasses set ``param_names`` (the hyperparameters, in order) and
    ``cuda_family`` (the kernel's case in the CUDA closed-form switch), and
    implement the three static closed forms.
    """

    #: ordered hyperparameter names; subclasses override.
    param_names: tuple = ()
    #: case of ``gp::Family`` in csrc/closed_forms.cuh; None = no CUDA form
    cuda_family = None

    def __init__(self, *values, dtype=None, device=None):
        super().__init__()
        if len(values) != len(self.param_names):
            raise TypeError(
                f"{type(self).__name__} takes {len(self.param_names)} "
                f"hyperparameters {self.param_names}, got {len(values)}"
            )
        tensors = [torch.as_tensor(v, dtype=dtype, device=device) for v in values]
        if dtype is None:
            dtype = tensors[0].dtype
            for t in tensors[1:]:
                dtype = torch.promote_types(dtype, t.dtype)
        for name, t in zip(self.param_names, tensors):
            self.register_buffer(name, t.to(dtype=dtype).reshape(()))

    # -- elementwise cores (shared by the plain path; mirrored in CUDA) -----

    @staticmethod
    @abc.abstractmethod
    def k_fn(d: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
        """Elementwise kernel value as a function of the difference d."""

    @staticmethod
    @abc.abstractmethod
    def jac_fn(d: torch.Tensor, *params: torch.Tensor) -> tuple:
        """Elementwise dK/dtheta, one tensor per parameter."""

    @staticmethod
    @abc.abstractmethod
    def hess_fn(d: torch.Tensor, *params: torch.Tensor) -> tuple:
        """Elementwise upper triangle of d2K/dtheta2 in row-major order:
        ((0,0), (0,1), ..., (0,P-1), (1,1), ...)."""

    # -- public API ---------------------------------------------------------

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    @property
    def params(self) -> torch.Tensor:
        """Hyperparameters as a (P,) tensor, ordered as ``param_names``."""
        return torch.stack(self._param_values())

    @classmethod
    def from_params(cls, theta) -> "Kernel":
        """A kernel of this class with the (P,) parameter vector ``theta``."""
        theta = torch.as_tensor(theta)
        return cls(*theta.unbind(0))

    def with_params(self, theta) -> "Kernel":
        """Functional parameter update: a new kernel with params = theta."""
        return type(self).from_params(theta)

    def copy(self) -> "Kernel":
        return type(self)(*(v.clone() for v in self._param_values()))

    def _param_values(self) -> tuple:
        return tuple(getattr(self, name) for name in self.param_names)

    @classmethod
    def sym_K(cls):
        """Sympy expression for k(d) and its symbols: (expr, d_symbol,
        (param_symbols...)) in ``param_names`` order.  Used only by the
        tests to validate the closed forms; never on a hot path."""
        raise NotImplementedError(f"{cls.__name__} has no sympy form")

    def kdiag(self, xo: torch.Tensor) -> torch.Tensor:
        """diag(k(xo, xo)), shape (m,): k(0) for stationary kernels."""
        params = self.params.to(device=xo.device, dtype=xo.dtype)
        k0 = self.k_fn(xo.new_zeros(()), *params.unbind(0))
        return k0.expand(xo.shape[0])

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """Covariance matrix K[i, j] = k(x1[i], x2[j]); shape (n, m)."""
        from gaussian_processes_tpu_torch.ops.pairwise import pairwise_matrix

        return pairwise_matrix(self, x1, x2)

    def jacobian(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """dK/dtheta stacked over parameters; shape (P, n, m)."""
        from gaussian_processes_tpu_torch.ops.pairwise import pairwise_jacobian

        return pairwise_jacobian(self, x1, x2)

    def hessian_pair(self, x1: torch.Tensor, x2: torch.Tensor,
                     p: int, q: int) -> torch.Tensor:
        """One (n, m) slice H[p, q] = d2K/(dtheta_p dtheta_q).

        The chunked log-likelihood Hessian (models/gp.py::
        _hessian_from_pieces_chunked) streams parameter pairs through this
        method; its one-slice peak-memory bound holds because only the
        requested plane is built (element ``tri_index(p, q, P)`` of
        ``hess_fn``'s upper triangle).
        """
        from gaussian_processes_tpu_torch.ops.pairwise import pairwise_hessian

        return pairwise_hessian(self, x1, x2, pair=(p, q))

    def hessian(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """d2K/dtheta2; shape (P, P, n, m), symmetric in the first two axes."""
        from gaussian_processes_tpu_torch.ops.pairwise import pairwise_hessian

        return pairwise_hessian(self, x1, x2)
