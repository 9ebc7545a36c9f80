"""The table of peaks and the work a kernel needs, for roofline shares.

Copied from ``chip_smoke.py`` (``F32_PEAK_FLOPS``, ``HBM_BYTES_PER_S`` and
``bound``): NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit.
A share is stated against these published peaks with the card's power limit
beside it.
"""

from __future__ import annotations

#: float32 outside the tensor cores (TF32 is off in the program)
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` and ``nbytes``: the
    larger of operations over the float32 peak and bytes over the HBM rate."""
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def cholesky_flops(n: int) -> float:
    """The Cholesky factorization's own n^3 / 3 flops, however it is done."""
    return n ** 3 / 3.0


def forward_solve_work(n: int, r: int, itemsize: int = 4):
    """(flops, bytes) of L Y = B for an n x n lower factor and r columns:
    n^2 r flops, the triangle's n^2 / 2 entries read once."""
    return float(n) * n * r, n * n / 2.0 * itemsize
