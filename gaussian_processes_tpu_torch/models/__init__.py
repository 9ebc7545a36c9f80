"""Kernels and exact-GP inference (counterpart of ``gaussian_processes_tpu.models``)."""

from gaussian_processes_tpu_torch.models.base import Kernel, pairwise_diff, tri_index
from gaussian_processes_tpu_torch.models.gaussian import GaussianKernel
from gaussian_processes_tpu_torch.models.periodic import PeriodicKernel
from gaussian_processes_tpu_torch.models.matern import Matern32Kernel, Matern52Kernel
from gaussian_processes_tpu_torch.models.rq import RationalQuadraticKernel
from gaussian_processes_tpu_torch.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu_torch.models.ard import ARDGaussianKernel
from gaussian_processes_tpu_torch.models.gp import (
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
from gaussian_processes_tpu_torch.models.gp_object import GP

__all__ = [
    "Kernel",
    "pairwise_diff",
    "tri_index",
    "GaussianKernel",
    "PeriodicKernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "SumKernel",
    "ProductKernel",
    "ARDGaussianKernel",
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
    "GP",
]
