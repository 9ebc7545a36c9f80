"""Inference layer: type-II MLE and fully Bayesian NUTS / ChEES-HMC.

Counterpart of ``gaussian_processes_tpu.inference``.  Chains are an explicit
leading dimension: every sampler step evaluates the log density of all C
chains at once through ``LogDensity.value_and_grad``.
"""

from gaussian_processes_tpu_torch.inference.adaptation import (
    DualAveragingState,
    WelfordState,
    build_warmup_schedule,
)
from gaussian_processes_tpu_torch.inference.chees import CheesResult, CheesState, sample_chees
from gaussian_processes_tpu_torch.inference.diagnostics import ess, split_rhat, summarize
from gaussian_processes_tpu_torch.inference.gp_model import (
    LogDensity,
    init_positions,
    make_log_likelihood,
    make_log_posterior,
    make_log_posterior_iterative,
    make_log_posterior_whittle,
    make_log_posterior_whittle_kron,
    n_hypers,
    pack,
    unpack,
)
from gaussian_processes_tpu_torch.inference.mle import MLEResult, fit_mle, fit_mle_restarts
from gaussian_processes_tpu_torch.inference.nuts import (
    ChainState,
    NUTSResult,
    SamplerState,
    collect,
    init_chain,
    init_sampler_state,
    nuts_transition,
    sample_nuts,
    sample_step,
    warmup,
    warmup_step,
)

__all__ = [
    "DualAveragingState",
    "WelfordState",
    "build_warmup_schedule",
    "CheesResult",
    "CheesState",
    "sample_chees",
    "ess",
    "split_rhat",
    "summarize",
    "LogDensity",
    "init_positions",
    "make_log_likelihood",
    "make_log_posterior",
    "make_log_posterior_iterative",
    "make_log_posterior_whittle",
    "make_log_posterior_whittle_kron",
    "n_hypers",
    "pack",
    "unpack",
    "MLEResult",
    "fit_mle",
    "fit_mle_restarts",
    "ChainState",
    "NUTSResult",
    "SamplerState",
    "collect",
    "init_chain",
    "init_sampler_state",
    "nuts_transition",
    "sample_nuts",
    "sample_step",
    "warmup",
    "warmup_step",
]
