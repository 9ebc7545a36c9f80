"""Utility layer: device policy, config, metrics, profiling, checkpoints."""

from gaussian_processes_tpu_torch.utils.checkpoint import load_pytree, save_pytree

from gaussian_processes_tpu_torch.utils.config import (
    CONFIGS,
    DataConfig,
    FitConfig,
    KernelConfig,
    MeshConfig,
    MLEConfig,
    NUTSConfig,
    RunConfig,
    make_data,
    make_kernel,
)
from gaussian_processes_tpu_torch.utils.device import (
    apply_precision_policy,
    resolve_device,
)
from gaussian_processes_tpu_torch.utils.metrics import MetricsLogger, summarize_nuts
from gaussian_processes_tpu_torch.utils.profiling import timed, trace

__all__ = [
    "CONFIGS",
    "DataConfig",
    "FitConfig",
    "KernelConfig",
    "MeshConfig",
    "MLEConfig",
    "NUTSConfig",
    "RunConfig",
    "make_data",
    "make_kernel",
    "apply_precision_policy",
    "resolve_device",
    "MetricsLogger",
    "summarize_nuts",
    "timed",
    "trace",
    "load_pytree",
    "save_pytree",
]
