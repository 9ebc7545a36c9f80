"""Precision of the reference's arithmetic.

``float64`` is the reference.  ``tf32`` is the control: float32 storage with
the operands of every matrix product rounded to TF32 (8 exponent bits, 10
mantissa bits, round to nearest even) and the products accumulated in
float32, which is what a tensor core does with TF32 allowed.  The rounding is
done by hand so that the control computes the same on the card and on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to the nearest TF32 value, ties to even."""
    bits = a.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & -0x2000
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    name: str  # "float64" | "tf32"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    def _op(self, a):
        return tf32_round(a) if self.name == "tf32" else a

    def mm(self, a, b):
        return self._op(a) @ self._op(b)

    def gemm_(self, c, a, b, alpha=-1.0):
        """c += alpha a b in place (batched over leading dimensions)."""
        a, b = self._op(a), self._op(b)
        if c.ndim == 2:
            c.addmm_(a, b, alpha=alpha)
        else:
            c.baddbmm_(a, b, alpha=alpha)
        return c


FLOAT64 = Arith("float64")


def arith(name: str) -> Arith:
    if name not in ("float64", "tf32"):
        raise ValueError(f"unknown arithmetic {name!r}")
    return Arith(name)
