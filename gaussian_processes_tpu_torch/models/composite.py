"""Kernel algebra: sum and product combinators.

Counterpart of ``gaussian_processes_tpu/models/composite.py``: composites
keep the full analytic derivative contract.  Jacobians concatenate over the
children's parameter blocks; Hessians are block-diagonal for sums, and for
products use

    (k1 k2)'_p  = k1'_p k2          (p in theta1),  k1 k2'_q  (q in theta2)
    (k1 k2)''   = [[H1 k2,          J1 (x) J2],
                   [(J1 (x) J2)^T,  k1 H2     ]]

The children are ``nn.Module`` fields ``k1`` and ``k2``; ``params`` /
``with_params`` expose the concatenated vector (k1's, then k2's), so the GP,
MLE and sampler layers take a tree as they take a leaf.  The elementwise
``k_fn`` is an instance method (the children own their parameters); K is
built by kernel B1's tree body on a card (``ops.pairwise.pairwise_matrix``
expands the tree into a sum of products of its leaves), and the derivatives
at matrix level from the children, as the JAX package builds them.  ``cuda_family``
stays None: kernel B5 takes leaves only.
"""

from __future__ import annotations

import torch
from torch import nn

from gaussian_processes_tpu_torch.models.base import Kernel


class _CompositeKernel(Kernel):
    """Shared plumbing: concatenated params over (k1, k2)."""

    def __init__(self, k1: Kernel, k2: Kernel):
        nn.Module.__init__(self)
        self.k1 = k1
        self.k2 = k2

    @property
    def param_names(self):  # type: ignore[override]
        return (tuple(f"k1.{n}" for n in self.k1.param_names)
                + tuple(f"k2.{n}" for n in self.k2.param_names))

    @property
    def n_params(self) -> int:
        return self.k1.n_params + self.k2.n_params

    @property
    def params(self) -> torch.Tensor:
        return torch.cat([self.k1.params, self.k2.params])

    def _param_values(self) -> tuple:
        return tuple(self.k1._param_values()) + tuple(self.k2._param_values())

    def with_params(self, theta) -> "_CompositeKernel":
        theta = torch.as_tensor(theta)
        p1 = self.k1.n_params
        return type(self)(self.k1.with_params(theta[:p1]), self.k2.with_params(theta[p1:]))

    def copy(self) -> "_CompositeKernel":
        return type(self)(self.k1.copy(), self.k2.copy())

    # elementwise core as an instance method: children own their params
    def k_fn(self, d, *params):  # type: ignore[override]
        p1 = self.k1.n_params
        return self._combine(self.k1.k_fn(d, *params[:p1]), self.k2.k_fn(d, *params[p1:]))

    def jac_fn(self, d, *params):  # type: ignore[override]
        raise NotImplementedError("composites implement jacobian() directly")

    def hess_fn(self, d, *params):  # type: ignore[override]
        raise NotImplementedError("composites implement hessian() directly")

    @classmethod
    def sym_K(cls):
        raise NotImplementedError("composite kernels are validated against autodiff, not sympy")

    def kdiag(self, xo: torch.Tensor) -> torch.Tensor:
        """diag(k(xo, xo)), composed from the children's."""
        return self._combine(self.k1.kdiag(xo), self.k2.kdiag(xo))


class SumKernel(_CompositeKernel):
    """k(d) = k1(d) + k2(d)."""

    @staticmethod
    def _combine(a, b):
        return a + b

    def jacobian(self, x1, x2):
        return torch.cat([self.k1.jacobian(x1, x2), self.k2.jacobian(x1, x2)])

    def hessian(self, x1, x2):
        H1 = self.k1.hessian(x1, x2)
        H2 = self.k2.hessian(x1, x2)
        P1, P2 = self.k1.n_params, self.k2.n_params
        n, m = H1.shape[-2:]
        H = H1.new_zeros((P1 + P2, P1 + P2, n, m))
        H[:P1, :P1] = H1
        H[P1:, P1:] = H2
        return H

    def hessian_pair(self, x1, x2, p, q):
        """One (n, m) slice; the cross blocks of a sum are identically zero."""
        i, j = (p, q) if p <= q else (q, p)
        P1 = self.k1.n_params
        if j < P1:
            return self.k1.hessian_pair(x1, x2, i, j)
        if i >= P1:
            return self.k2.hessian_pair(x1, x2, i - P1, j - P1)
        return torch.zeros_like(self.k1.hessian_pair(x1, x2, 0, 0))


class ProductKernel(_CompositeKernel):
    """k(d) = k1(d) * k2(d) (e.g. quasi-periodic = SE * periodic)."""

    @staticmethod
    def _combine(a, b):
        return a * b

    def jacobian(self, x1, x2):
        K1 = self.k1(x1, x2)
        K2 = self.k2(x1, x2)
        J1 = self.k1.jacobian(x1, x2)
        J2 = self.k2.jacobian(x1, x2)
        return torch.cat([J1 * K2[None], K1[None] * J2])

    def hessian(self, x1, x2):
        K1 = self.k1(x1, x2)
        K2 = self.k2(x1, x2)
        J1 = self.k1.jacobian(x1, x2)
        J2 = self.k2.jacobian(x1, x2)
        H1 = self.k1.hessian(x1, x2)
        H2 = self.k2.hessian(x1, x2)
        P1, P2 = self.k1.n_params, self.k2.n_params
        n, m = K1.shape
        cross = torch.einsum("pnm,qnm->pqnm", J1, J2)
        H = K1.new_zeros((P1 + P2, P1 + P2, n, m))
        H[:P1, :P1] = H1 * K2[None, None]
        H[P1:, P1:] = K1[None, None] * H2
        H[:P1, P1:] = cross
        H[P1:, :P1] = cross.transpose(0, 1)
        return H

    def hessian_pair(self, x1, x2, p, q):
        """One (n, m) slice of the product rule."""
        i, j = (p, q) if p <= q else (q, p)
        P1 = self.k1.n_params
        if j < P1:
            return self.k1.hessian_pair(x1, x2, i, j) * self.k2(x1, x2)
        if i >= P1:
            return self.k1(x1, x2) * self.k2.hessian_pair(x1, x2, i - P1, j - P1)
        # cross block: dK1/dtheta_i * dK2/dtheta_{j-P1}
        return self.k1.jacobian(x1, x2)[i] * self.k2.jacobian(x1, x2)[j - P1]
