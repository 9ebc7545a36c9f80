"""Config / flag system.

Counterpart of ``gaussian_processes_tpu/utils/config.py``: the dataclasses,
the ``CONFIGS`` registry and ``make_data`` are copied unchanged (``make_data``
is numpy only, so both packages draw identical data from one seed);
``make_kernel`` builds the port's kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    family: str = "se"  # "se" | "periodic"
    h: float = 1.0
    w: float = 1.0
    p: float = 1.0  # periodic only


@dataclasses.dataclass(frozen=True)
class DataConfig:
    n: int = 500
    n_test: int = 200
    noise: float = 0.1
    freq: float = 2.0  # sine frequency of the synthetic target
    seed: int = 0
    x_lo: float = -3.14159265
    x_hi: float = 3.14159265
    #: "scattered" = sorted uniform draws; "grid" = endpoint-exclusive
    #: uniform grid (the circulant/Whittle paths' circle closes exactly
    #: at x_hi, and integer `freq` makes the sine circle-compatible)
    layout: str = "scattered"


@dataclasses.dataclass(frozen=True)
class FitConfig:
    noise: float = 0.1
    jitter: float = 1e-6
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLEConfig:
    num_steps: int = 100
    method: str = "lbfgs"
    learning_rate: float = 0.05
    n_restarts: int = 1


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    n_chains: int = 64
    num_warmup: int = 500
    num_samples: int = 1000
    max_depth: int = 8
    target_accept: float = 0.8
    init_step_size: float = 0.05
    prior_std: float = 1.5
    seed: int = 0
    #: split the sampling scans into device dispatches of at most this
    #: many transitions (None = one execution); semantics identical
    chunk_size: Optional[int] = 25


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    n_devices: Optional[int] = None  # None = all addressable
    chain_axis: str = "chain"
    grid_axes: Tuple[str, str] = ("i", "j")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One benchmark workload end to end."""

    name: str
    task: str  # "fit" | "mle" | "nuts" | "fit_large" | "nuts_multihost"
    kernel: KernelConfig = KernelConfig()
    data: DataConfig = DataConfig()
    fit: FitConfig = FitConfig()
    mle: MLEConfig = MLEConfig()
    nuts: NUTSConfig = NUTSConfig()
    mesh: MeshConfig = MeshConfig()
    metrics_path: Optional[str] = None
    profile_dir: Optional[str] = None


#: The five acceptance workloads (BASELINE.json:7-11).
CONFIGS = {
    # 1. SE kernel, N=500 sine, fixed hyperparams: Cholesky fit + predict
    "config1_fit_se500": RunConfig(
        name="config1_fit_se500",
        task="fit",
        data=DataConfig(n=500),
    ),
    # 2. periodic kernel, analytic dK/dtheta, type-II MLE
    "config2_mle_periodic": RunConfig(
        name="config2_mle_periodic",
        task="mle",
        kernel=KernelConfig(family="periodic", h=1.0, w=1.0, p=3.14159265),
        data=DataConfig(n=300),
        mle=MLEConfig(num_steps=100, n_restarts=4),
    ),
    # 3. fully Bayesian: NUTS over (variance, lengthscale, noise), 64 chains
    "config3_nuts_64": RunConfig(
        name="config3_nuts_64",
        task="nuts",
        data=DataConfig(n=500),
        nuts=NUTSConfig(n_chains=64, num_warmup=500, num_samples=1000),
    ),
    # 3b. same workload with the tree-free ChEES-HMC sampler
    "config3_chees_64": RunConfig(
        name="config3_chees_64",
        task="chees",
        data=DataConfig(n=500),
        nuts=NUTSConfig(n_chains=64, num_warmup=500, num_samples=1000),
    ),
    # 4. large-N exact GP: N=65k blocked Cholesky, K tiled through HBM
    "config4_large_n": RunConfig(
        name="config4_large_n",
        task="fit_large",
        data=DataConfig(n=65536),
        fit=FitConfig(jitter=1e-4),
    ),
    # 5. 1024 chains sharded over the mesh, pooled adaptation
    "config5_nuts_sharded": RunConfig(
        name="config5_nuts_sharded",
        task="nuts_multihost",
        data=DataConfig(n=500),
        nuts=NUTSConfig(n_chains=1024, num_warmup=500, num_samples=1000),
    ),
    # beyond the five: sparse SGPR (Titsias bound) at 2^20 scattered
    # points, m=1024 kmeans inducing centers
    "sparse1m_sgpr": RunConfig(
        name="sparse1m_sgpr",
        task="sgpr",
        kernel=KernelConfig(h=1.0, w=0.006),
        data=DataConfig(n=1 << 20, freq=50.0),
        fit=FitConfig(jitter=0.0),
    ),
    # beyond the five: fully Bayesian hyperparameters on a 2^20-point
    # uniform grid via the Whittle (circulant-model) likelihood
    "grid1m_bayes_whittle": RunConfig(
        name="grid1m_bayes_whittle",
        task="bayes_grid",
        kernel=KernelConfig(h=1.0, w=0.006),
        data=DataConfig(n=1 << 20, freq=50.0, layout="grid"),
        nuts=NUTSConfig(n_chains=16, num_warmup=300, num_samples=500,
                        prior_std=1.0, chunk_size=10),
    ),
}


def make_kernel(cfg: KernelConfig, *, dtype=None, device=None):
    from gaussian_processes_tpu_torch.models.gaussian import GaussianKernel
    from gaussian_processes_tpu_torch.models.matern import Matern32Kernel, Matern52Kernel
    from gaussian_processes_tpu_torch.models.periodic import PeriodicKernel
    from gaussian_processes_tpu_torch.models.rq import RationalQuadraticKernel

    opts = dict(dtype=dtype, device=device)
    if cfg.family == "se":
        return GaussianKernel(cfg.h, cfg.w, **opts)
    if cfg.family == "periodic":
        return PeriodicKernel(cfg.h, cfg.w, cfg.p, **opts)
    if cfg.family == "matern32":
        return Matern32Kernel(cfg.h, cfg.w, **opts)
    if cfg.family == "matern52":
        return Matern52Kernel(cfg.h, cfg.w, **opts)
    if cfg.family == "rq":
        # reuse the third slot (p) as the RQ mixture parameter
        return RationalQuadraticKernel(cfg.h, cfg.w, cfg.p, **opts)
    raise ValueError(f"unknown kernel family: {cfg.family!r}")


def make_data(cfg: DataConfig, dtype="float64"):
    import numpy as np

    rng = np.random.default_rng(cfg.seed)
    if cfg.layout == "grid":
        span = cfg.x_hi - cfg.x_lo
        x = (np.arange(cfg.n) * (span / cfg.n) + cfg.x_lo).astype(dtype)
    else:
        x = np.sort(rng.uniform(cfg.x_lo, cfg.x_hi, cfg.n)).astype(dtype)
    f = np.sin(cfg.freq * x)
    y = (f + cfg.noise * rng.standard_normal(cfg.n)).astype(dtype)
    xo = np.linspace(cfg.x_lo, cfg.x_hi, cfg.n_test).astype(dtype)
    return x, y, xo
