"""Command-line runner for the acceptance workloads.

Usage:
    python -m gaussian_processes_tpu_torch.cli config1_fit_se500 --device cuda
    python -m gaussian_processes_tpu_torch.cli config1_fit_se500 --n 16384 --device cuda
    python -m gaussian_processes_tpu_torch.cli config2_mle_periodic
    python -m gaussian_processes_tpu_torch.cli config3_chees_64 --device cuda
    python -m gaussian_processes_tpu_torch.cli config3_nuts_64 --num-samples 200
    python -m gaussian_processes_tpu_torch.cli config4_large_n
    torchrun --nproc-per-node 8 -m gaussian_processes_tpu_torch.cli config4_large_n
    python -m gaussian_processes_tpu_torch.cli grid1m_bayes_whittle
    python -m gaussian_processes_tpu_torch.cli sparse1m_sgpr
    python -m gaussian_processes_tpu_torch.cli config5_nuts_sharded
    torchrun --nproc-per-node 4 -m gaussian_processes_tpu_torch.cli config5_nuts_sharded
    python -m gaussian_processes_tpu_torch.cli --list

Counterpart of ``gaussian_processes_tpu/cli.py``.  The port runs the
``fit`` (BASELINE config #1: build K, factor, solve, predict), ``mle``
(config #2: type-II MLE with restarts), ``nuts`` and ``chees`` tasks
(config #3: the hyperparameter posterior sampled over many chains),
``fit_large`` (config #4: the exact fit at N=65536 through the block-cyclic
factorization over the ranks of a process group, one card each holding
N^2 / W of K and one N x b panel), ``bayes_grid`` (ChEES on the Whittle
posterior of a uniform grid at N=2^20) and ``sgpr`` (the Titsias bound at
N=2^20 scattered points with k-means inducing points) and
``nuts_multihost`` (config #5: NUTS with the chains split over the ranks of
a process group).  ``fit_large`` and
``nuts_multihost`` run over the group that ``parallel.initialize_cluster``
brings up from the launcher's variables; one process is a group of one.
Every task runs on ``cuda`` unless another device is asked for.  Each run
emits JSONL metrics (utils/metrics.py) and an end-of-run summary line;
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the timed part
that carries the program's ``gp.*`` spans (utils/profiling.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

#: tasks of the JAX package's CLI that the port does not run yet
NOT_PORTED: dict = {}


def _apply_overrides(cfg, args):
    nuts = cfg.nuts
    if args.num_samples is not None:
        nuts = dataclasses.replace(nuts, num_samples=args.num_samples)
    if args.num_warmup is not None:
        nuts = dataclasses.replace(nuts, num_warmup=args.num_warmup)
    if args.n_chains is not None:
        nuts = dataclasses.replace(nuts, n_chains=args.n_chains)
    data = cfg.data
    if args.n is not None:
        data = dataclasses.replace(data, n=args.n)
    return dataclasses.replace(
        cfg, nuts=nuts, data=data, metrics_path=args.metrics, profile_dir=args.profile_dir,
    )


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_fit(cfg, kernel, x, y, xo, device):
    """The exact fit (K, the blocked factor, two solves) and its predictions.
    ``fit_large`` (config #4) runs ``fit_blockcyclic`` over the process
    group's ranks as the JAX package runs it over its mesh (block 256 from
    N = 4096 on, else 64): each rank holds N^2 / W of K and one N x b panel,
    17.2 GB in float32 at N=65536 on one card, timed best of 2 after a
    warm-up as the JAX package times it."""
    from gaussian_processes_tpu_torch import fit, predict_diag
    from gaussian_processes_tpu_torch.utils import timed, trace

    summary = {}
    if cfg.task == "fit_large":
        from gaussian_processes_tpu_torch.parallel import (
            fit_blockcyclic,
            make_chain_mesh,
            predict_diag_blockcyclic,
        )

        mesh = make_chain_mesh(cfg.mesh.n_devices, axis="shard", device=device)
        block = 256 if cfg.data.n >= 4096 else 64
        summary.update(mesh=str({"shard": mesh.world_size}), block_size=block)

        def fit_fn(k, x, y):
            return fit_blockcyclic(k, x, y, cfg.fit.noise, mesh, block_size=block,
                                   jitter=cfg.fit.jitter)

        def predict_fn(post):
            return predict_diag_blockcyclic(post, xo, mesh)
    else:
        def fit_fn(k, x, y):
            return fit(k, x, y, cfg.fit.noise, cfg.fit.jitter)

        def predict_fn(post):
            return predict_diag(post, xo)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with trace(cfg.profile_dir):
        wall = timed(fit_fn, kernel, x, y, device=device,
                     **({"iters": 2} if cfg.task == "fit_large" else {}))
    post = fit_fn(kernel, x, y)
    mean, var = predict_fn(post)
    truth = np.sin(cfg.data.freq * xo.cpu().numpy())
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - truth) ** 2)))
    summary.update(fit_wall_s=wall, log_marginal=float(post.log_marginal),
                   pred_rmse_vs_truth=rmse, pred_var_min=float(var.min()))
    if device.type == "cuda":
        summary["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return summary


def _run_sgpr(cfg, kernel, x, y, xo, device):
    """The sparse (Titsias) fit: m = min(1024, max(64, n / 1024)) k-means
    inducing points (5 Lloyd iterations from the config's seed), the fit
    timed best of 2 after a warm-up, and its predictions at xo."""
    from gaussian_processes_tpu_torch.models.sgpr import fit_sgpr, kmeans_inducing, predict_sgpr
    from gaussian_processes_tpu_torch.utils import timed, trace

    m_ind = min(1024, max(64, cfg.data.n // 1024))
    z = kmeans_inducing(torch.Generator().manual_seed(cfg.data.seed), x, m_ind, iters=5)

    def fit_fn(k, xx, yy):
        return fit_sgpr(k, xx, yy, cfg.fit.noise, z, jitter=cfg.fit.jitter)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with trace(cfg.profile_dir):
        wall = timed(fit_fn, kernel, x, y, device=device, iters=2)
    post = fit_fn(kernel, x, y)
    mean, var = predict_sgpr(post, xo)
    truth = np.sin(cfg.data.freq * xo.cpu().numpy())
    summary = {
        "fit_wall_s": wall,
        "elbo": float(post.log_marginal),
        "trace_gap": float(post.trace_gap),
        "m_inducing": m_ind,
        "pred_finite": bool(torch.isfinite(mean).all()) and bool((var > -1e-3).all()),
        "pred_rmse_vs_truth": float(np.sqrt(np.mean((mean.cpu().numpy() - truth) ** 2))),
    }
    if device.type == "cuda":
        summary["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return summary


def _run_mle(cfg, kernel, x, y, device):
    from gaussian_processes_tpu_torch.inference import fit_mle_restarts
    from gaussian_processes_tpu_torch.utils import trace

    # the restarts' starting points come from a generator on the CPU, so a
    # seed starts the same restarts on any device and in either dtype
    generator = torch.Generator().manual_seed(cfg.data.seed)
    _synchronize(device)
    t0 = time.perf_counter()
    with trace(cfg.profile_dir):
        res = fit_mle_restarts(
            kernel, x, y, cfg.fit.noise, generator, n_restarts=cfg.mle.n_restarts,
            num_steps=cfg.mle.num_steps, method=cfg.mle.method,
            learning_rate=cfg.mle.learning_rate, jitter=cfg.fit.jitter,
        )
        _synchronize(device)
    return {
        "mle_wall_s": time.perf_counter() - t0,
        "log_marginal": float(res.log_marginal),
        "theta": torch.exp(res.u).tolist(),
        "converged": bool(res.converged),
    }


def sampler_setup(cfg, kernel, x, y, device, dtype):
    """The sampler tasks' (log posterior, initial positions, generator)."""
    from gaussian_processes_tpu_torch.inference import init_positions, make_log_posterior

    ncfg = cfg.nuts
    if cfg.task == "bayes_grid":
        # the Whittle (circulant-model) likelihood on a uniform grid:
        # deterministic FFT leapfrogs, centered at the prior mean, which sits
        # at the starting point
        from gaussian_processes_tpu_torch.inference import make_log_posterior_whittle
        from gaussian_processes_tpu_torch.ops.toeplitz import is_uniform_grid

        if not is_uniform_grid(x):
            raise ValueError("bayes_grid needs layout='grid'")
        u0 = torch.log(torch.cat([kernel.params, torch.tensor([cfg.fit.noise], dtype=dtype,
                                                               device=device)]))
        log_post = make_log_posterior_whittle(kernel, x, y, prior_mean=u0,
                                              prior_std=ncfg.prior_std, jitter=cfg.fit.jitter)
    else:
        log_post = make_log_posterior(kernel, x, y, prior_std=ncfg.prior_std,
                                      jitter=cfg.fit.jitter)
    generator = torch.Generator(device=device).manual_seed(ncfg.seed)
    init = init_positions(kernel, cfg.fit.noise, generator, n_chains=ncfg.n_chains,
                          spread=0.2, dtype=dtype)
    return log_post, init, generator


def _run_sampler(cfg, kernel, x, y, device, dtype, checkpoint=None):
    from gaussian_processes_tpu_torch.inference import sample_chees, sample_nuts
    from gaussian_processes_tpu_torch.inference.diagnostics import ess, summarize
    from gaussian_processes_tpu_torch.utils import summarize_nuts, trace

    ncfg = cfg.nuts
    log_post, init, generator = sampler_setup(cfg, kernel, x, y, device, dtype)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _synchronize(device)
    t0 = time.perf_counter()
    with trace(cfg.profile_dir):
        if cfg.task == "nuts_multihost":
            from gaussian_processes_tpu_torch.parallel import make_chain_mesh, sample_nuts_sharded

            res = sample_nuts_sharded(
                log_post, init, generator, mesh=make_chain_mesh(device=device),
                num_warmup=ncfg.num_warmup, num_samples=ncfg.num_samples,
                max_depth=ncfg.max_depth, target_accept=ncfg.target_accept,
                init_step_size=ncfg.init_step_size,
                # host chunks, each rank's state written to (and read back
                # from) its own checkpoint file between them
                chunk_size=ncfg.chunk_size, checkpoint=checkpoint)
        elif cfg.task in ("chees", "bayes_grid"):
            res = sample_chees(log_post, init, generator, num_warmup=ncfg.num_warmup,
                               num_samples=ncfg.num_samples,
                               init_step_size=ncfg.init_step_size,
                               **({"init_traj_length": 0.1, "max_leapfrog": 32}
                                  if cfg.task == "bayes_grid" else {}))
        else:
            res = sample_nuts(log_post, init, generator, num_warmup=ncfg.num_warmup,
                              num_samples=ncfg.num_samples, max_depth=ncfg.max_depth,
                              target_accept=ncfg.target_accept,
                              init_step_size=ncfg.init_step_size)
        _synchronize(device)
    wall = time.perf_counter() - t0
    positions = res.positions.detach().cpu().double().numpy()
    theta = np.exp(positions)
    draws = theta.reshape(-1, positions.shape[-1])
    summary = summarize_nuts(res)
    summary.update(
        wall_s=wall,
        samples_per_s=ncfg.num_samples * ncfg.n_chains / wall,
        draws_finite=bool(np.isfinite(positions).all()),
        posterior_mean=draws.mean(0).tolist(),
        posterior_sd=draws.std(0).tolist(),
        # Monte-Carlo standard error of posterior_mean: sd / sqrt(ESS of theta)
        posterior_mean_se=(draws.std(0) / np.sqrt(ess(theta))).tolist(),
        diagnostics=summarize(positions, wall_s=wall),
    )
    if device.type == "cuda":
        summary["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return summary


def load_problem(cfg, device):
    """(x, y, xo, kernel, dtype) of a workload on ``device``."""
    from gaussian_processes_tpu_torch.utils import make_data, make_kernel

    dtype = getattr(torch, cfg.fit.dtype)
    x, y, xo = make_data(cfg.data, dtype=cfg.fit.dtype)
    x, y, xo = (torch.as_tensor(a, device=device) for a in (x, y, xo))
    return x, y, xo, make_kernel(cfg.kernel, dtype=dtype, device=device), dtype


def run_config(cfg, device="cuda", checkpoint: str | None = None) -> dict:
    """Run one workload on ``device`` and return its summary.
    ``checkpoint``: the base path of ``nuts_multihost``'s per-rank
    checkpoints, written after every chunk."""
    from gaussian_processes_tpu_torch.utils import MetricsLogger, resolve_device

    if cfg.task in NOT_PORTED:
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (ROADMAP {NOT_PORTED[cfg.task]})"
        )
    if cfg.task not in ("fit", "fit_large", "mle", "nuts", "chees", "bayes_grid", "sgpr",
                        "nuts_multihost"):
        raise ValueError(f"unknown task {cfg.task!r}")

    device = resolve_device(device)
    if cfg.task in ("fit_large", "nuts_multihost"):
        from gaussian_processes_tpu_torch.parallel import initialize_cluster
        from gaussian_processes_tpu_torch.parallel.multihost import local_device

        # a no-op unless a launcher configured a cluster; gloo for a CPU run
        initialize_cluster(backend="gloo" if device.type == "cpu" else None)
        if device.type == "cuda" and device.index is None:
            device = local_device()  # this rank's card
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu")
    log = MetricsLogger(path=cfg.metrics_path)
    x, y, xo, kernel, dtype = load_problem(cfg, device)
    log.log("start", config=cfg.name, task=cfg.task, n=cfg.data.n,
            device=device_name, dtype=cfg.fit.dtype)

    if cfg.task in ("fit", "fit_large"):
        summary = _run_fit(cfg, kernel, x, y, xo, device)
    elif cfg.task == "mle":
        summary = _run_mle(cfg, kernel, x, y, device)
    elif cfg.task == "sgpr":
        summary = _run_sgpr(cfg, kernel, x, y, xo, device)
    else:
        summary = _run_sampler(cfg, kernel, x, y, device, dtype, checkpoint)
    summary = {"device": device_name, **summary}

    from gaussian_processes_tpu_torch.parallel import is_primary

    if is_primary():  # one summary per run, not one per rank
        log.log("summary", config=cfg.name, **summary)
    log.close()
    return summary


def main(argv=None):
    from gaussian_processes_tpu_torch.utils import CONFIGS

    ap = argparse.ArgumentParser(prog="gaussian_processes_tpu_torch.cli")
    ap.add_argument("config", nargs="?", help="config name (see --list)")
    ap.add_argument("--list", action="store_true", help="list configs")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--n", type=int, default=None, help="override the data size")
    ap.add_argument("--n-chains", type=int, default=None, help="override the chain count")
    ap.add_argument("--num-warmup", type=int, default=None, help="override the warmup steps")
    ap.add_argument("--num-samples", type=int, default=None, help="override the draws")
    ap.add_argument("--metrics", default=None, help="JSONL metrics file")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler Chrome trace dir; the trace carries the gp.* spans")
    ap.add_argument("--checkpoint", default=None,
                    help="nuts_multihost: base path of the per-rank checkpoints")
    args = ap.parse_args(argv)

    if args.list or not args.config:
        for name, c in CONFIGS.items():
            status = (f"not ported: ROADMAP {NOT_PORTED[c.task]}"
                      if c.task in NOT_PORTED else "ported")
            print(f"{name:24s} task={c.task:14s} n={c.data.n:<8d} {status}")
        return 0
    if args.config not in CONFIGS:
        print(f"unknown config {args.config!r}; use --list", file=sys.stderr)
        return 2
    cfg = _apply_overrides(CONFIGS[args.config], args)
    run_config(cfg, device=args.device, checkpoint=args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
