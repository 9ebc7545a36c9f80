"""Left-looking blocked Cholesky with a hand-written tile kernel (B3) as base.

Counterpart of ``gaussian_processes_tpu/ops/blocked_cholesky.py``.  The
factorization is restructured so that all O(N^3) work is large dense matrix
products and only the O(N * 128^2) diagonal tiles run a sequential
factorization.  Per panel k (row offset r = 128 k):

    strip = A[r:, r:r+128] - L[r:, :r] @ L[r:r+128, :r]^T   (GEMM)
    L_kk, L_kk^-1 = chol(strip[:128])                       (B3 tile)
    L[r+128:, k-strip] = strip[128:] @ L_kk^-T              (GEMM)

A (C, n, n) stack (the samplers' C chains) runs the same panels with
batched GEMMs and one B3 launch per panel on the (C, 128, 128) stack of
diagonal tiles.  The factor lives in one buffer and each column strip is
written once.  B3
returns the tile's inverse beside its factor (``chol_tile_inv``), so a panel
takes no separate triangular inverse; the GEMMs stay with PyTorch (cuBLAS),
as the JAX package leaves them to XLA; float32 products run in full float32
(utils/device.py).  Inputs whose size is not a multiple of 128 are padded
with an identity corner, chol(diag(A, I)) = diag(chol(A), I), and sliced
back.

``chol_tile`` is the wrapper of kernel B3 (csrc/chol_tile.cu), which
replaces the Pallas body ``_chol_vmem_body``: for a tensor on the CPU it
evaluates the plain version ``cholesky_reference``; for one on the card it
launches the kernel or raises.  Both follow ``jnp.linalg.cholesky`` on a
matrix that is not positive definite: its lower triangle comes back NaN and
nothing raises (the samplers reject such proposals through the NaN).

``cholesky_blocked`` carries an autograd rule (``_CholeskyBlocked``), the
counterpart of the JAX package's VJP of its Pallas base
(``_pallas_base_bwd``): the forward is the unchanged factorization, the
backward the Cholesky VJP, A_bar = (S + S^T) / 2 with S = L^-T Phi(L^T
L_bar) L^-1 (Phi: the lower triangle, its diagonal halved), by two
``torch.linalg.solve_triangular`` calls, as the JAX package takes XLA's
Cholesky VJP.  ``chol_tile`` itself has none and raises on an input that
requires grad.

Not ported, because they were TPU workarounds: the recursive skeleton
(``_chol_recursive``), the two-level ``_chol_leftlook2`` (a measured
negative), and the blocked TRSM ``solve_triangular_blocked`` (XLA's
triangular solve was latency-bound on the TPU; cuBLAS's is not the problem
here).
"""

from __future__ import annotations

import torch

from gaussian_processes_tpu_torch.ops import _build

#: tile edge of kernel B3 and panel width of ``cholesky_blocked``
TILE = 128


def cholesky_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain lower Cholesky factor of SPD ``A`` (..., n, n): B3's twin.

    A matrix that is not positive definite gives a lower triangle of NaN
    (strict upper triangle zero), as ``jnp.linalg.cholesky`` does.
    """
    L, info = torch.linalg.cholesky_ex(A)
    # a NaN input fails too, whether or not the library's info flags it
    failed = ((info != 0) | torch.isnan(L).any(-1).any(-1))[..., None, None]
    return torch.where(failed, torch.full_like(L, float("nan")).tril(), L)


def chol_tile_inv_reference(A: torch.Tensor):
    """Plain twin of ``chol_tile_inv``: the factor and its triangular inverse
    (a failed tile's inverse is NaN on and below the diagonal, as its factor)."""
    L = cholesky_reference(A)
    eye = torch.eye(TILE, dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False).tril()


def _check_tiles(A: torch.Tensor) -> None:
    if A.shape[-2:] != (TILE, TILE) or A.ndim not in (2, 3):
        raise ValueError(f"chol_tile takes (..., {TILE}, {TILE}) with at most "
                         f"one batch dimension, got {tuple(A.shape)}")


def _launch_tile(A: torch.Tensor, with_inv: bool):
    if A.device.type != "cuda":
        raise RuntimeError(f"no Cholesky tile kernel for device {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chol_tile: float32 or float64, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("chol_tile: the tile must be contiguous")
    if A.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("chol_tile: the CUDA kernel has no autograd rule; "
                           "the input must not require grad")
    if A.data_ptr() % 16:
        # the kernel reads the tile 16 bytes at a time; a view at another
        # offset is copied to a fresh (aligned) allocation
        A = A.clone()
    batch = A.shape[0] if A.ndim == 3 else 1
    L = torch.empty_like(A)
    if with_inv:
        Linv = torch.empty_like(A)
        status = _build.entry("gp_chol_tile_inv", A.dtype)(
            A.device.index, A.data_ptr(), L.data_ptr(), Linv.data_ptr(), batch, TILE,
            _build.stream_of(A),
        )
    else:
        status = _build.entry("gp_chol_tile", A.dtype)(
            A.device.index, A.data_ptr(), L.data_ptr(), batch, TILE, _build.stream_of(A),
        )
    _build.check(status, "gp_chol_tile")
    _build.launch_counts["chol_tile"] += 1
    return (L, Linv) if with_inv else L


def chol_tile(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a (128, 128) tile or a (batch, 128, 128)
    stack of tiles.  The CUDA path is kernel B3, one thread block per tile."""
    _check_tiles(A)
    if A.device.type == "cpu":
        return cholesky_reference(A)
    return _launch_tile(A, with_inv=False)


def chol_tile_inv(A: torch.Tensor):
    """``(L, L^-1)`` of a (128, 128) tile or a (batch, 128, 128) stack: B3
    with the inverse carried along in the same launch."""
    _check_tiles(A)
    if A.device.type == "cpu":
        return chol_tile_inv_reference(A)
    return _launch_tile(A, with_inv=True)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def cholesky_blocked(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A``, (n, n) or a (C, n, n) stack (the
    samplers' per-chain matrices), left-looking over 128-wide panels with
    ``chol_tile`` as the base.  The strict upper triangle is exactly zero.

    A stack runs the same panels on every matrix at once: the panel update
    is one ``baddbmm``, the diagonal tiles one B3 launch on the (C, 128, 128)
    stack, the off-diagonal solve one batched product with the stacked
    inverses.  A matrix that is not positive definite gives NaN in its own
    factor (from its failed tile on), and no other matrix of the stack is
    touched.  Differentiable (``_CholeskyBlocked``)."""
    if A.ndim not in (2, 3) or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"cholesky_blocked takes a square matrix or a stack of them, "
                         f"got {tuple(A.shape)}")
    if A.requires_grad and torch.is_grad_enabled():
        return _CholeskyBlocked.apply(A)
    return _cholesky_blocked(A)


class _CholeskyBlocked(torch.autograd.Function):
    """``cholesky_blocked`` with the Cholesky VJP as its backward."""

    @staticmethod
    def forward(ctx, A):
        L = _cholesky_blocked(A.detach())
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        phi = (L.mT @ L_bar).tril()
        phi.diagonal(dim1=-2, dim2=-1).mul_(0.5)
        # S = L^-T phi L^-1: solve L^T X = phi, then S^T = L^-T X^T
        X = torch.linalg.solve_triangular(L.mT, phi, upper=True)
        S = torch.linalg.solve_triangular(L.mT, X.mT, upper=True).mT
        return 0.5 * (S + S.mT)


def _cholesky_blocked(A: torch.Tensor) -> torch.Tensor:
    n = A.shape[-1]
    n_pad = _round_up(max(n, TILE), TILE)
    if n_pad != n:
        padded = A.new_zeros(A.shape[:-2] + (n_pad, n_pad))
        padded[..., :n, :n] = A
        padded[..., n:, n:].diagonal(dim1=-2, dim2=-1).fill_(1.0)
        A = padded
    # strip - L[r:, :r] @ L[r:r+TILE, :r]^T in one GEMM (one batched GEMM)
    update = torch.addmm if A.ndim == 2 else torch.baddbmm
    out = torch.zeros_like(A)
    nb = n_pad // TILE
    for k in range(nb):
        r = k * TILE
        strip = A[..., r:, r : r + TILE]
        if k > 0:
            strip = update(strip, out[..., r:, :r], out[..., r : r + TILE, :r].mT, alpha=-1.0)
        Lkk, inv_Lkk = chol_tile_inv(strip[..., :TILE, :].contiguous())
        out[..., r : r + TILE, r : r + TILE] = Lkk
        if k + 1 < nb:
            out[..., r + TILE :, r : r + TILE] = strip[..., TILE:, :] @ inv_Lkk.mT
    return out if n_pad == n else out[..., :n, :n].contiguous()


# ---------------------------------------------------------------------------
# Selection: which Cholesky and triangular solve the fit path uses
# ---------------------------------------------------------------------------


def choose_cholesky(A: torch.Tensor):
    """The factorization for ``A``'s device: on a CUDA card always the
    blocked form with the B3 base (no size threshold; the JAX package's
    4096 was measured on the TPU); on the CPU the plain factor."""
    if A.device.type == "cuda":
        return cholesky_blocked
    return cholesky_reference


def _solve(L: torch.Tensor, B: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """L X = B (or L^T X = B with ``trans``) for lower-triangular L."""
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    X = torch.linalg.solve_triangular(L.mT if trans else L, B, upper=trans)
    return X[:, 0] if vec else X


def choose_solve(A: torch.Tensor):
    """The lower-triangular solve ``solve(L, B, *, trans=False)`` for
    ``A``'s device: ``torch.linalg.solve_triangular`` everywhere (the JAX
    package's blocked TRSM was a TPU workaround)."""
    return _solve
