"""Structured kernel interpolation (SKI / KISS-GP) for scattered inputs.

Counterpart of ``gaussian_processes_tpu/ops/ski.py``.  An m-point uniform
inducing grid g covers the data, and

    K(x, x)  ~=  W K(g, g) W^T

where W (n x m) holds local cubic-convolution interpolation weights, four
nonzeros a row (4^D for a D-dim Kronecker grid).  K(g, g) is Toeplitz (or
Kronecker of Toeplitz), so a matvec with the surrogate covariance is an O(n)
gather and scatter plus FFTs on the grid.  W K_g W^T is PSD by congruence,
so A = K_ski + s^2 I is always SPD.

The scatter W^T v is deterministic: each operator holds its taps sorted
once, with the geometry, by the grid point they land on (a stable sort, so
within a grid point in (point, tap) order); W^T v gathers the weighted
values in that order and sums each grid point's contiguous segment
(``torch.segment_reduce``), in one fixed order, with no atomics.  Its memory
is O(n * taps), however the inputs cluster.

Not ported: ``compensated_plan`` and the two-float helpers (``_tf_*``,
``ski_kron_apply_compensated``): they evaluate the refinement residual in
double-float32 because the TPU has no float64.  ``ski_kron_refine`` here
evaluates its residual in float64 on the card.

f32 scale limitation (JAX package, measured): at n ~ 6e4+ with a smooth
right-hand side, float32 PCG through the SKI operator stalls near its
round-off floor (~1e-2 relative residual); ``ski_kron_refine`` polishes an
N-D solve past it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np
import torch

from gaussian_processes_tpu_torch.ops import krylov, toeplitz


def _segments(rows: torch.Tensor, wts: torch.Tensor, m: int):
    """(seg_pts, seg_w, seg_len): the taps sorted by the grid point they land
    on (stable, so in (point, tap) order within a grid point), each tap's
    input point and weight, (n T,), and the number of taps on each of the m
    grid points.  ``rows``/``wts``: (n, T) tap rows and weights."""
    T = rows.shape[1]
    flat = rows.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    return order // T, wts.reshape(-1)[order], torch.bincount(flat, minlength=m)


def _set_segments(op, segments):
    for name, value in zip(("seg_pts", "seg_w", "seg_len"), segments):
        object.__setattr__(op, name, value)


def _segment_sum(seg_pts, seg_w, seg_len, vn):
    """W^T vn from the sorted taps: (n,) or (n, r) -> (m,) or (m, r).  Each
    grid point's taps are one contiguous segment, summed in the sorted order;
    the lengths come from the geometry, so the call skips their check (a host
    read)."""
    squeeze = vn.ndim == 1
    v2 = vn[:, None] if squeeze else vn
    out = torch.segment_reduce(seg_w.to(v2.dtype)[:, None] * v2[seg_pts], "sum",
                               lengths=seg_len, axis=0, unsafe=True)
    return out[:, 0] if squeeze else out


@dataclasses.dataclass(frozen=True)
class SKIOperator:
    """Frozen interpolation geometry: grid + 4-tap weights per input.

    ``grid``: (m,) uniform inducing grid; ``idx``: (n,) base index of each
    input's 4-tap stencil; ``w``: (n, 4) cubic-convolution weights (rows sum
    to 1).  ``seg_pts``/``seg_w``/``seg_len``: the scatter's sorted taps
    (``_segments``), built from idx and w when not given.  The kernel and noise are not stored: one
    geometry serves every hyperparameter value.
    """

    grid: torch.Tensor
    idx: torch.Tensor
    w: torch.Tensor
    seg_pts: Optional[torch.Tensor] = None
    seg_w: Optional[torch.Tensor] = None
    seg_len: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.seg_pts is None:
            rows = self.idx[:, None].long() + torch.arange(4, device=self.idx.device)
            _set_segments(self, _segments(rows, self.w, self.m))

    @property
    def m(self) -> int:
        return self.grid.shape[0]

    @property
    def n(self) -> int:
        return self.idx.shape[0]


def make_grid(x, num_points: int, dtype=None) -> torch.Tensor:
    """Uniform inducing grid covering x with a 2-cell margin each side, so
    every input's 4-tap cubic stencil is interior."""
    x = torch.as_tensor(x)
    if dtype is None:
        dtype = x.dtype
    if num_points < 8:
        raise ValueError(f"SKI grid needs >= 8 points, got {num_points}")
    lo = torch.min(x)
    hi = torch.max(x)
    span = torch.clamp_min(hi - lo, 1e-12)
    # 2-cell margin on each side out of num_points total cells
    dx = span / (num_points - 5)
    return (lo - 2.0 * dx + dx * torch.arange(num_points, dtype=x.dtype,
                                              device=x.device)).to(dtype)


def _cubic_weights(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic-convolution weights (a = -1/2) for fractional offset t in
    [0, 1) between stencil points 1 and 2; (..., 4) weights for taps at
    distances (1 + t, t, 1 - t, 2 - t).  Exact on quadratics; rows sum to 1."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _stencil(x, grid):
    m = grid.shape[0]
    dx = grid[1] - grid[0]
    pos = (x - grid[0]) / dx
    # clamp the continuous position: an input outside the grid snaps to its
    # edge (constant extrapolation) instead of taking cubic weights of an
    # offset t >> 1, which blow up polynomially
    pos = torch.clamp(pos, 1.0, m - 2.0)
    base = torch.clamp(torch.floor(pos).long(), 1, m - 3)
    t = pos - base.to(pos.dtype)
    return base - 1, _cubic_weights(t).to(x.dtype)


def interpolation_weights(x, grid) -> SKIOperator:
    """The (idx, w) sparse representation of W for inputs x on a grid from
    ``make_grid`` (uniform, 2-cell margins)."""
    x = torch.as_tensor(x)
    grid = torch.as_tensor(grid, device=x.device)
    idx, w = _stencil(x, grid)
    return SKIOperator(grid=grid, idx=idx, w=w)


def interp_matvec(op: SKIOperator, vg: torch.Tensor) -> torch.Tensor:
    """W @ vg: gather the 4 stencil values per row, weight, sum.
    ``vg``: (m,) or (m, r) -> (n,) / (n, r)."""
    squeeze = vg.ndim == 1
    v2 = vg[:, None] if squeeze else vg
    rows = op.idx[:, None].long() + torch.arange(4, device=op.idx.device)  # (n, 4)
    out = torch.einsum("nk,nkr->nr", op.w.to(v2.dtype), v2[rows])
    return out[:, 0] if squeeze else out


def interp_rmatvec(op: SKIOperator, vn: torch.Tensor) -> torch.Tensor:
    """W^T @ vn: each input's weighted value summed into its 4 taps, in the
    sorted taps' fixed order.  ``vn``: (n,) or (n, r) -> (m,) / (m, r)."""
    return _segment_sum(op.seg_pts, op.seg_w, op.seg_len, vn)


def ski_matvec(op: SKIOperator, col, v, shift=0.0) -> torch.Tensor:
    """(W T W^T + shift I) @ v with T the symmetric Toeplitz of first column
    ``col`` on the grid; ``v``: (n,) or (n, r)."""
    core = toeplitz.toeplitz_matvec(col, interp_rmatvec(op, v))
    out = interp_matvec(op, core)
    return out + torch.as_tensor(shift, dtype=out.dtype, device=out.device) * v


def kernel_matvec_ski(kernel, op: SKIOperator, v, noise, jitter: float = 0.0):
    """(K_ski(x, x) + (noise^2 + jitter) I) @ v, the SKI counterpart of
    ``krylov.kernel_matvec``."""
    col = toeplitz.toeplitz_column(kernel, op.grid)
    shift = torch.square(torch.as_tensor(noise, dtype=col.dtype, device=col.device)) + jitter
    return ski_matvec(op, col, v, shift)


def ski_dense(kernel, op: SKIOperator) -> torch.Tensor:
    """Densely assembled W K_g W^T, a test oracle (O(n m + m^2))."""
    Kg = kernel(op.grid, op.grid)
    return interp_matvec(op, interp_matvec(op, Kg).T)


# --- D-dimensional SKI: scattered (n, D) inputs on a Kronecker grid ---------


@dataclasses.dataclass(frozen=True)
class SKIKronOperator:
    """SKI geometry over a D-dim Cartesian inducing grid (full KISS-GP).

    Each input interpolates from a 4^D-tap tensor-product cubic stencil:
    ``kron`` holds the per-dimension grids (``kronecker.KronOperator``,
    row-major), ``idx`` (n, D) the per-dim base indices, ``w`` (n, 4, D) the
    per-dim weights; tap (j_1..j_D) weighs prod_d w[:, j_d, d].
    ``seg_pts``/``seg_w``/``seg_len``: the scatter's sorted taps
    (``_segments``), built when not given.
    """

    kron: object  # kronecker.KronOperator
    idx: torch.Tensor  # (n, D)
    w: torch.Tensor  # (n, 4, D)
    seg_pts: Optional[torch.Tensor] = None
    seg_w: Optional[torch.Tensor] = None
    seg_len: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.seg_pts is None:
            rows, wts = _nd_taps(self)
            _set_segments(self, _segments(rows, wts, math.prod(self.kron.shape)))

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    @property
    def ndim(self) -> int:
        return self.idx.shape[1]


def interpolation_weights_nd(x, axes) -> SKIKronOperator:
    """D-dim SKI geometry for scattered (n, D) inputs; ``axes``: per-dimension
    uniform grids from ``make_grid`` (each with its 2-cell margin)."""
    from gaussian_processes_tpu_torch.ops import kronecker

    x = torch.atleast_2d(torch.as_tensor(x))
    axes = tuple(torch.as_tensor(g, device=x.device) for g in axes)
    stencils = [_stencil(x[:, d], g) for d, g in enumerate(axes)]
    idx = torch.stack([s[0] for s in stencils], dim=-1)  # (n, D)
    w = torch.stack([s[1] for s in stencils], dim=-1)  # (n, 4, D)
    return SKIKronOperator(kron=kronecker.KronOperator(axes=axes), idx=idx, w=w)


def _nd_taps(op: SKIKronOperator):
    """Flat grid index (n, 4^D) and combined weight (n, 4^D) per tap."""
    sizes = op.kron.shape
    D = op.ndim
    strides = [math.prod(sizes[d + 1:]) for d in range(D)]
    idx = op.idx.long()
    rows, wts = [], []
    for taps in itertools.product(range(4), repeat=D):
        rows.append(sum((idx[:, d] + taps[d]) * strides[d] for d in range(D)))
        cw = op.w[:, taps[0], 0]
        for d in range(1, D):
            cw = cw * op.w[:, taps[d], d]
        wts.append(cw)
    return torch.stack(rows, dim=-1), torch.stack(wts, dim=-1)


def interp_matvec_nd(op: SKIKronOperator, vg: torch.Tensor) -> torch.Tensor:
    """W @ vg, vg (m,) or (m, r) a flat grid vector (row-major)."""
    rows, wts = _nd_taps(op)
    squeeze = vg.ndim == 1
    v2 = vg[:, None] if squeeze else vg
    out = torch.einsum("nt,ntr->nr", wts.to(v2.dtype), v2[rows])
    return out[:, 0] if squeeze else out


def interp_rmatvec_nd(op: SKIKronOperator, vn: torch.Tensor) -> torch.Tensor:
    """W^T @ vn -> flat grid vector (m,) / (m, r), in the sorted taps' order."""
    return _segment_sum(op.seg_pts, op.seg_w, op.seg_len, vn)


def ski_kron_matvec(op: SKIKronOperator, cols, v, shift=0.0) -> torch.Tensor:
    """(W ((x)_d T_d) W^T + shift I) @ v for scattered D-dim inputs."""
    from gaussian_processes_tpu_torch.ops import kronecker

    core = kronecker.kron_matvec(cols, interp_rmatvec_nd(op, v))
    out = interp_matvec_nd(op, core)
    return out + torch.as_tensor(shift, dtype=out.dtype, device=out.device) * v


def ski_kron_dense(kernel, op: SKIKronOperator) -> torch.Tensor:
    """Dense W K_g W^T oracle for tests (O(n m + m^2))."""
    from gaussian_processes_tpu_torch.ops import kronecker

    g = kronecker.kron_inputs(op.kron.axes)
    Kg = kernel(g, g)
    return interp_matvec_nd(op, interp_matvec_nd(op, Kg).T)


def _to_float64(op: SKIKronOperator) -> SKIKronOperator:
    from gaussian_processes_tpu_torch.ops import kronecker

    kron = kronecker.KronOperator(axes=tuple(g.double() for g in op.kron.axes))
    return SKIKronOperator(kron=kron, idx=op.idx, w=op.w.double(),
                           seg_pts=op.seg_pts, seg_w=op.seg_w.double(), seg_len=op.seg_len)


def ski_kron_refine(
    kernel,
    op: SKIKronOperator,
    x,
    alpha: torch.Tensor,
    y: torch.Tensor,
    noise,
    *,
    jitter: float = 0.0,
    plan=None,
    rounds: int = 2,
    num_iters: int = 150,
    precond_rank: int = 512,
    tol: float = 1e-7,
    replace_every: int = 10,
    precond_L: Optional[torch.Tensor] = None,
    target: float = 2e-8,
):
    """Mixed-precision iterative refinement of an N-D SKI solve.

    The residual y - A alpha is evaluated in float64 on alpha's device: the
    operator's columns, weights and FFTs in float64, with the per-dimension
    columns computed from the kernel's hyperparameters in float64.  Each
    round solves A d = r by float32 preconditioned CG (pivoted-Cholesky
    Woodbury on the scattered inputs, ``precond_L`` reusing the fit's factor)
    whose matvec is the float64 operator rounded to float32, to the adaptive
    tolerance clip(target / rel, tol, 1e-2), and adds d to the float64
    solution; rounds stop once the residual is below ``target``.

    Returns ``((hi, lo), rel)``: hi = alpha64 in float32 and lo = the rest
    (alpha64 - hi) in float32, so that ``hi + lo`` is the solution as the JAX
    package's two-float pair is, and rel the float64 relative residual.
    ``plan`` is the JAX package's two-float gather plan, which a float64
    residual does not use; it must be None.
    """
    from gaussian_processes_tpu_torch.models.ard import ARDGaussianKernel

    if not isinstance(kernel, ARDGaussianKernel):
        raise NotImplementedError(
            "ski_kron_refine mirrors the Kronecker path's kernel support "
            f"(ARDGaussianKernel); got {type(kernel).__name__}")
    if plan is not None:
        raise ValueError("ski_kron_refine: the float64 residual takes no two-float plan")
    dev = alpha.device
    op64 = _to_float64(op)
    theta = kernel.params.to(dtype=torch.float64, device=dev)
    cols64 = []
    for d, g in enumerate(op64.kron.axes):
        col = torch.exp(-0.5 * torch.square(g - g[0]) / theta[1 + d] ** 2)
        cols64.append(col * theta[0] ** 2 if d == 0 else col)
    shift64 = float(noise) ** 2 + float(jitter)

    def apply64(v):
        return ski_kron_matvec(op64, cols64, v, shift64)

    def mv(v):  # the float32 correction solves' operator
        return apply64(v.double()).to(v.dtype)

    x = torch.as_tensor(x, device=dev)
    L = (precond_L if precond_L is not None
         else krylov.pivoted_cholesky(kernel, x, precond_rank))
    pre = krylov.woodbury_inverse_apply(L, torch.tensor(shift64, dtype=L.dtype, device=dev))

    y64 = torch.as_tensor(y, device=dev).double()
    y_norm = torch.linalg.norm(y64)
    a64 = alpha.double()
    for _ in range(rounds):
        r = y64 - apply64(a64)
        rel = float(torch.linalg.norm(r) / y_norm)
        if rel < target:
            break
        # solve just tightly enough that this round lands at target
        t_k = float(np.clip(target / max(rel, 1e-30), tol, 1e-2))
        d, _ = krylov.pcg(mv, pre, r.to(alpha.dtype)[:, None], num_iters=num_iters, tol=t_k,
                          replace_every=replace_every, early_exit=True)
        a64 = a64 + d[:, 0].double()
    rel = torch.linalg.norm(y64 - apply64(a64)) / y_norm
    hi = a64.to(alpha.dtype)
    return (hi, (a64 - hi.double()).to(alpha.dtype)), rel
