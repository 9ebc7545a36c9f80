"""gaussian_processes_tpu_torch — the exact-GP engine in PyTorch and CUDA.

The port of ``gaussian_processes_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100.  Module paths and public names mirror the JAX package's, so each
module's counterpart is easy to find; the JAX package stays the reference the
port is tested against.  This package imports torch and numpy, never JAX.

Layer map:

    models/   GP inference (functional core with its chain-batched value and
              gradient, reference-parity GP object, the matrix-free
              iterative_gp: CG solves and SLQ logdet; the other large-N
              regimes: sgpr (the Titsias bound), rff (random features),
              pathwise (Matheron posterior function draws); classify:
              Laplace classification and count regression) and kernels
              (nn.Modules with analytic derivatives: SE, periodic, Matérn
              3/2 and 5/2, RQ, Sum/Product trees of them; ARD over (n, D))
    inference/ type-II MLE (L-BFGS / Adam), the hyperparameter posterior
              builders, NUTS and ChEES-HMC over many chains in lockstep,
              warmup adaptation, R-hat / ESS diagnostics
    ops/      hand-written CUDA kernels for sm_90a (csrc/) with their plain
              PyTorch twins: pairwise K / dK / d2K (B1, B2; K and dK also
              over a table of chains' parameters), the Cholesky tile (B3)
              under a left-looking blocked factorization (one matrix or a
              stack), the
              fused kernel matvec and Jacobian product (B4, B5) under the
              Krylov solvers (krylov), the ARD K builder (B6); the
              structured-grid operators on torch.fft (toeplitz: uniform 1-D
              grids and the Whittle likelihood; kronecker: Cartesian grids;
              ski: scattered inputs through an inducing grid)
    utils/    device and precision policy, config, metrics, profiling
    convert   JAX-package values (as numpy) -> port objects and operators
    cli       the fit, fit_large, mle, nuts, chees, bayes_grid and sgpr workloads

Everything runs where its input tensors live: the CUDA kernels for tensors
on the card, the plain PyTorch versions for tensors on the CPU.
"""

from gaussian_processes_tpu_torch.utils.device import apply_precision_policy

apply_precision_policy()

from gaussian_processes_tpu_torch.models.base import Kernel, pairwise_diff  # noqa: E402
from gaussian_processes_tpu_torch.models.gaussian import GaussianKernel  # noqa: E402
from gaussian_processes_tpu_torch.models.periodic import PeriodicKernel  # noqa: E402
from gaussian_processes_tpu_torch.models.matern import Matern32Kernel, Matern52Kernel  # noqa: E402
from gaussian_processes_tpu_torch.models.rq import RationalQuadraticKernel  # noqa: E402
from gaussian_processes_tpu_torch.models.composite import ProductKernel, SumKernel  # noqa: E402
from gaussian_processes_tpu_torch.models.ard import ARDGaussianKernel  # noqa: E402
from gaussian_processes_tpu_torch.models.iterative_gp import (  # noqa: E402
    IterativePosterior,
    fit_iterative,
    fit_mle_iterative,
    log_marginal_value_and_grad_iterative,
    predict_diag_iterative,
    predict_mean_iterative,
)
from gaussian_processes_tpu_torch.models.gp import (  # noqa: E402
    GPPosterior,
    build_kxx,
    extend_posterior,
    fit,
    likelihood_value_grad_hessian,
    log_marginal_all,
    log_marginal_hessian,
    log_marginal_likelihood,
    log_marginal_value_and_grad,
    log_marginal_value_and_grad_chains,
    log_predictive_density,
    loo_predictive,
    predict,
    predict_diag,
    predict_mean,
    sample_posterior,
)
from gaussian_processes_tpu_torch.models.pathwise import (  # noqa: E402
    FourierFeatures,
    periodic_harmonic_features,
    prior_features,
    sample_posterior_pathwise,
    sample_posterior_pathwise_iterative,
)
from gaussian_processes_tpu_torch.models.rff import (  # noqa: E402
    RFFPosterior,
    fit_rff,
    predict_rff,
    sample_rff_posterior,
)
from gaussian_processes_tpu_torch.models.classify import (  # noqa: E402
    LaplacePosterior,
    LogisticLikelihood,
    PoissonLikelihood,
    fit_laplace,
    fit_laplace_mle,
    log_marginal_laplace,
    predict_laplace,
)
from gaussian_processes_tpu_torch.models.sgpr import (  # noqa: E402
    SGPRPosterior,
    elbo_sgpr,
    fit_sgpr,
    fit_sgpr_mle,
    kmeans_inducing,
    make_log_posterior_sgpr,
    predict_sgpr,
    predict_sgpr_cov,
    sample_sgpr_posterior,
    select_inducing,
)
from gaussian_processes_tpu_torch.models.gp_object import GP  # noqa: E402
from gaussian_processes_tpu_torch.inference import (  # noqa: E402
    fit_mle,
    fit_mle_restarts,
    make_log_likelihood,
    make_log_posterior,
    sample_nuts,
)

__all__ = [
    "Kernel",
    "pairwise_diff",
    "GaussianKernel",
    "PeriodicKernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "SumKernel",
    "ProductKernel",
    "ARDGaussianKernel",
    "IterativePosterior",
    "fit_iterative",
    "fit_mle_iterative",
    "log_marginal_value_and_grad_iterative",
    "predict_diag_iterative",
    "predict_mean_iterative",
    "GPPosterior",
    "build_kxx",
    "fit",
    "predict",
    "predict_mean",
    "predict_diag",
    "sample_posterior",
    "loo_predictive",
    "extend_posterior",
    "log_predictive_density",
    "log_marginal_likelihood",
    "log_marginal_value_and_grad",
    "log_marginal_value_and_grad_chains",
    "log_marginal_hessian",
    "log_marginal_all",
    "likelihood_value_grad_hessian",
    "FourierFeatures",
    "periodic_harmonic_features",
    "prior_features",
    "RFFPosterior",
    "fit_rff",
    "predict_rff",
    "sample_rff_posterior",
    "sample_posterior_pathwise",
    "sample_posterior_pathwise_iterative",
    "LaplacePosterior",
    "LogisticLikelihood",
    "PoissonLikelihood",
    "fit_laplace",
    "fit_laplace_mle",
    "log_marginal_laplace",
    "predict_laplace",
    "SGPRPosterior",
    "elbo_sgpr",
    "fit_sgpr",
    "fit_sgpr_mle",
    "kmeans_inducing",
    "make_log_posterior_sgpr",
    "predict_sgpr",
    "predict_sgpr_cov",
    "sample_sgpr_posterior",
    "select_inducing",
    "GP",
    "fit_mle",
    "fit_mle_restarts",
    "make_log_likelihood",
    "make_log_posterior",
    "sample_nuts",
]

__version__ = "0.1.0"
