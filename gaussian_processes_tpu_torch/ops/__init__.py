"""Native ops layer: hand-written CUDA kernels and their plain PyTorch twins,
the Krylov solvers of the matrix-free path (``ops.krylov``) and the
structured-grid operators (``ops.toeplitz``, ``ops.kronecker``, ``ops.ski``).

``launch_counts`` counts the launches of each kernel wrapper; it is
``utils.profiling.counts``, which also holds the program's dotted counters.
"""

from gaussian_processes_tpu_torch.ops._build import launch_counts
from gaussian_processes_tpu_torch.ops.blocked_cholesky import (
    chol_tile,
    chol_tile_inv,
    cholesky_blocked,
    cholesky_reference,
    choose_cholesky,
    choose_solve,
)
from gaussian_processes_tpu_torch.ops.pairwise import (
    kernel_jacvec_fused,
    kernel_jacvec_fused_reference,
    kernel_matvec_fused,
    kernel_matvec_fused_reference,
    pairwise_matrix_ard,
    pairwise_matrix_ard_reference,
    pairwise_hessian,
    pairwise_hessian_reference,
    pairwise_jacobian,
    pairwise_jacobian_chains,
    pairwise_jacobian_chains_reference,
    pairwise_jacobian_reference,
    pairwise_matrix,
    pairwise_matrix_chains,
    pairwise_matrix_chains_reference,
    pairwise_matrix_reference,
    tile_program,
)
from gaussian_processes_tpu_torch.ops import kronecker
from gaussian_processes_tpu_torch.ops import ski
from gaussian_processes_tpu_torch.ops import toeplitz

__all__ = [
    "kronecker",
    "ski",
    "toeplitz",
    "tile_program",
    "launch_counts",
    "chol_tile",
    "chol_tile_inv",
    "cholesky_blocked",
    "cholesky_reference",
    "choose_cholesky",
    "choose_solve",
    "kernel_jacvec_fused",
    "kernel_jacvec_fused_reference",
    "kernel_matvec_fused",
    "kernel_matvec_fused_reference",
    "pairwise_matrix_ard",
    "pairwise_matrix_ard_reference",
    "pairwise_hessian",
    "pairwise_hessian_reference",
    "pairwise_jacobian",
    "pairwise_jacobian_chains",
    "pairwise_jacobian_chains_reference",
    "pairwise_jacobian_reference",
    "pairwise_matrix",
    "pairwise_matrix_chains",
    "pairwise_matrix_chains_reference",
    "pairwise_matrix_reference",
]
