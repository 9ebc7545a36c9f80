#!/usr/bin/env python3
"""Time the kernels and the paths over them on one CUDA card, so that two
trees of gaussian_processes_tpu_torch can be compared in one run.

    python3 kernel_timing.py [--root DIR] [--profile DIR] [--ptxas SOURCE ...]

``--root`` imports ``gaussian_processes_tpu_torch`` from DIR (default: this
checkout).  To compare a parent commit with this one, unpack the parent into
a directory that .gitignore lists (``git archive``) and run parent, this,
this, parent in one call on one card.  The workloads, their data and the
timing are ``chip_smoke.py``'s own, imported from the file beside this one:
device times in ms by CUDA events around back-to-back launches queued
behind a spin kernel, path walls in s by the host clock around a
synchronized call.  The script prints the card's name and power limit and
one JSON line.  ``--profile DIR`` also writes a ``torch.profiler`` breakdown
by kernel of one warm SE and one warm ARD ``fit_iterative`` at N=65536, of
one SE value+grad there, of one exact fit at N=16384, of one gradient +
chunked Hessian at N=4096, of 100 B1 and B6 launches at the pivot
shapes, of one batched value+grad of 64 chains at N=500 and of one warm
Matérn 5/2 and one quasi-periodic tree ``fit_iterative`` at N=65536 to
DIR/profile.json and prints its summary.  ``--ptxas SOURCE ...`` (file
names under the package's csrc/, as matvec_f32.cu) compiles those sources
with ``-Xptxas -v`` and prints each kernel's registers, spills and stack,
and each source's compile seconds, and does nothing else.  Needs a CUDA
card (``--ptxas``: only nvcc); exits 1 without one.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs  # imports only the standard library here


def wall_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def pivot_row_fn(pw, kernel, x):
    """One pivot row as the pivoted Cholesky builds it: ``pivot_rows`` (the
    parameters read once) where the package has it, else
    ``pairwise_matrix`` per row."""
    if hasattr(pw, "pivot_rows"):
        return pw.pivot_rows(kernel, x)
    return lambda xp: pw.pairwise_matrix(kernel, xp, x)[0]


def measure(dev) -> dict:
    return {**measure_exact_and_ard(dev), **measure_products(dev), **measure_chains(dev),
            **measure_new_families(dev)}


def measure_new_families(dev) -> dict:
    """The cases of Matérn 3/2, Matérn 5/2, RQ and the quasi-periodic tree at
    chip_smoke.py's path shapes: B1 at K_N^2 with the diagonal, B2a and one
    B2b plane at GRAD_N^2, B1's pivot row and B4 / B5 at ITER_N (Matérn 5/2
    at r = 1, 8, 9, the others at r = 9, the tree at r = 1, 8), B1 and B2a
    over the chain table, and the Matérn 5/2 and tree ``fit_iterative``
    walls.  Empty for a tree without these families."""
    import dataclasses

    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    if not hasattr(gpx, "Matern52Kernel"):
        return {}
    out = {}
    f32 = torch.float32
    gen = torch.Generator().manual_seed(2)
    cfg1 = CONFIGS["config1_fit_se500"]
    x16 = torch.as_tensor(make_data(dataclasses.replace(cfg1.data, n=cs.K_N), "float32")[0],
                          device=dev)
    x4 = torch.as_tensor(make_data(dataclasses.replace(cfg1.data, n=cs.GRAD_N), "float32")[0],
                         device=dev)
    noise = torch.tensor(cs.ITER_NOISE, dtype=f32, device=dev)
    xs, ys, ks = cs.sine_problem(cs.ITER_N, dev)
    piv = xs[cs.ITER_N // 3:cs.ITER_N // 3 + 1].contiguous()
    u = torch.randn(cs.ITER_N, 9, generator=gen).to(dev)
    for fam, (_, _, pair, _, _, _) in cs.NEW_FAMILY_OPS.items():
        k = cs.new_kernel(fam, cs.NEW_FAMILY_PARAMS[fam], f32, dev)
        out[f"B1_{fam}_{cs.K_N}_ms"] = cs.time_ms(
            lambda: pw.pairwise_matrix(k, x16, x16, noise=noise, jitter=1e-6), 10)
        out[f"B2a_{fam}_{cs.GRAD_N}_ms"] = cs.time_ms(lambda: pw.pairwise_jacobian(k, x4, x4), 10)
        out[f"B2b_{fam}_{cs.GRAD_N}_pair_ms"] = cs.time_ms(
            lambda: pw.pairwise_hessian(k, x4, x4, pair=pair), 10)
        ki = cs.new_kernel(fam, (1.0, float(ks.w), *cs.NEW_FAMILY_PARAMS[fam][2:]), f32, dev)
        row = pivot_row_fn(pw, ki, xs)
        out[f"B1_{fam}_pivot_row_{cs.ITER_N}_ms"] = cs.time_ms(lambda: row(piv), 200)
        out[f"B1_{fam}_pivot_row_call_us"] = cs.call_us(lambda: row(piv))
        for r in ((1, 8, 9) if fam == "matern52" else (9,)):
            v = torch.randn(cs.ITER_N, r, generator=gen).to(dev)
            out[f"B4_{fam}_r{r}_ms"] = cs.time_ms(
                lambda: pw.kernel_matvec_fused(ki, xs, v, noise, cs.ITER_JITTER), 5)
        out[f"B5_{fam}_r9_ms"] = cs.time_ms(lambda: pw.kernel_jacvec_fused(ki, xs, u), 5)
    kt = cs.tree_kernel("qp", f32, dev, se=(1.0, float(ks.w)))
    row = pivot_row_fn(pw, kt, xs)
    out[f"B1_tree_pivot_row_{cs.ITER_N}_ms"] = cs.time_ms(lambda: row(piv), 200)
    out["B1_tree_pivot_row_call_us"] = cs.call_us(lambda: row(piv))
    kt16 = cs.tree_kernel("qp", f32, dev)
    out[f"B1_tree_{cs.K_N}_ms"] = cs.time_ms(
        lambda: pw.pairwise_matrix(kt16, x16, x16, noise=noise, jitter=1e-6), 10)
    for r in (1, 8):
        v = torch.randn(cs.ITER_N, r, generator=gen).to(dev)
        out[f"B4_tree_r{r}_ms"] = cs.time_ms(
            lambda: pw.kernel_matvec_fused(kt, xs, v, noise, cs.ITER_JITTER), 3)
    for fam in ("matern32", "matern52", "rq", "tree"):
        x, template, theta = cs.chain_problem(dev, f32, fam)
        P = template.n_params
        params, diag = theta[:, :P], theta[:, P] ** 2 + 1e-6
        out[f"B1_chains_{fam}_ms"] = cs.time_ms(
            lambda: pw.pairwise_matrix_chains(template, x, params, diag), 50)
        out[f"B2a_chains_{fam}_ms"] = cs.time_ms(
            lambda: pw.pairwise_jacobian_chains(template, x, params), 50)
    k52 = cs.new_kernel("matern52", (1.0, float(ks.w)), f32, dev)
    for key in ("matern52_fit_iterative_wall_s", "matern52_fit_iterative_warm_wall_s"):
        out[key] = wall_s(lambda: gpx.fit_iterative(k52, xs, ys, cs.ITER_NOISE, cs.seed(30),
                                                    **cs.ITER_OPTS))
    for key in ("tree_fit_iterative_wall_s", "tree_fit_iterative_warm_wall_s"):
        out[key] = wall_s(lambda: gpx.fit_iterative(kt, xs, ys, cs.ITER_NOISE, cs.seed(33),
                                                    **cs.ITER_OPTS))
    return out


def measure_chains(dev) -> dict:
    """The samplers' batched evaluation at C = 64, N = 500 (chip_smoke.py's
    chain workload): B1 and B2a over the chain table (SE and periodic), B3
    on the chains' (64, 128, 128) tile stack, the batched blocked factor,
    and the batched value and gradient, device time and host wall; B2a
    contracted where the tree has it (``measure_contract_chains``).  Empty
    for a tree without the chain tables."""
    import torch
    from gaussian_processes_tpu_torch.models import gp
    from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    if not hasattr(pw, "pairwise_matrix_chains"):
        return {}
    out = {}
    for fam in ("se", "periodic"):
        x, template, theta = cs.chain_problem(dev, torch.float32, fam)
        P = template.n_params
        params, diag = theta[:, :P], theta[:, P] ** 2 + 1e-6
        out[f"B1_chains_{fam}_ms"] = cs.time_ms(
            lambda: pw.pairwise_matrix_chains(template, x, params, diag), 50)
        out[f"B2a_chains_{fam}_ms"] = cs.time_ms(
            lambda: pw.pairwise_jacobian_chains(template, x, params), 50)
    x, template, theta = cs.chain_problem(dev, torch.float32, "se")
    K = pw.pairwise_matrix_chains(template, x, theta[:, :2], theta[:, 2] ** 2 + 1e-6)
    tiles = K[:, :128, :128].contiguous()
    out["chol_tile_inv_chains_ms"] = cs.time_ms(lambda: bc.chol_tile_inv(tiles), 50)
    out["cholesky_blocked_chains_ms"] = cs.time_ms(lambda: bc.cholesky_blocked(K), 20)
    out["cholesky_ex_chains_ms"] = cs.time_ms(lambda: torch.linalg.cholesky_ex(K), 20)
    y = torch.sin(2 * x)

    def value_and_grad():
        gp.log_marginal_value_and_grad_chains(template, x, y, theta, 1e-6)

    out["value_and_grad_chains_ms"] = cs.time_ms(value_and_grad, 20)
    value_and_grad()
    out["value_and_grad_chains_wall_s"] = statistics.median(
        wall_s(value_and_grad) for _ in range(15))
    if hasattr(pw, "jacobian_contract_chains"):
        out.update(measure_contract_chains(dev))
    return out


def measure_contract_chains(dev) -> dict:
    """B2a contracted at config #3's and config #5's SE batches, (64, 500^2)
    and (1024, 500^2) float32, on the chains' own alpha and K^-1; beside it
    its plain twin, and the path it replaces: B2a's Jacobians and the two
    einsums over them."""
    import torch
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    out = {}
    for chains in (64, 1024):
        x, template, theta = cs.chain_problem(dev, torch.float32, "se", chains=chains)
        params = theta[:, :2]
        K = pw.pairwise_matrix_chains(template, x, params, theta[:, 2] ** 2 + 1e-6)
        alpha, inv_K = cs.contract_operands(K, x)  # K^-1 row-major, as the value+grad's
        del K

        def jacobian_and_einsums():
            J = pw.pairwise_jacobian_chains(template, x, params)
            quad = torch.einsum("ci,cpij,cj->cp", alpha, J, alpha)
            return 0.5 * (quad - torch.einsum("cij,cpji->cp", inv_K, J))

        tag = f"se_{chains}"
        out[f"B2a_contract_chains_{tag}_ms"] = cs.time_ms(
            lambda: pw.jacobian_contract_chains(template, x, params, alpha, inv_K), 20)
        out[f"B2a_contract_chains_{tag}_plain_ms"] = cs.time_ms(
            lambda: pw.jacobian_contract_chains_reference(template, x, params, alpha, inv_K), 5)
        out[f"B2a_chains_and_einsums_{tag}_ms"] = cs.time_ms(jacobian_and_einsums, 5)
        del alpha, inv_K
        torch.cuda.empty_cache()
    return out


def measure_exact_and_ard(dev) -> dict:
    import dataclasses

    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch import cli
    from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    out = {}
    gen = torch.Generator().manual_seed(0)
    cfg1 = CONFIGS["config1_fit_se500"]
    k = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float32, device=dev)
    x16 = torch.as_tensor(make_data(dataclasses.replace(cfg1.data, n=cs.K_N), "float32")[0],
                          device=dev)
    x4, y4, _ = (torch.as_tensor(a, device=dev)
                 for a in make_data(dataclasses.replace(cfg1.data, n=cs.GRAD_N), "float32"))
    noise = torch.tensor(cs.ITER_NOISE, dtype=torch.float32, device=dev)
    K16 = pw.pairwise_matrix(k, x16, x16, noise=0.1, jitter=1e-6)

    # B3: one tile, 64 tiles, the blocked factorization, the exact fit
    tile = K16[:128, :128].contiguous()
    tiles = torch.stack([K16[i:i + 128, i:i + 128] for i in range(0, 64 * 128, 128)]).contiguous()
    out["chol_tile_ms"] = cs.time_ms(lambda: bc.chol_tile(tile), 200)
    out["cholesky_ex_tile_ms"] = cs.time_ms(lambda: torch.linalg.cholesky_ex(tile), 200)
    out["chol_tile_batch64_ms"] = cs.time_ms(lambda: bc.chol_tile(tiles), 50)
    out["cholesky_ex_batch64_ms"] = cs.time_ms(lambda: torch.linalg.cholesky_ex(tiles), 50)
    out[f"cholesky_blocked_{cs.K_N}_ms"] = cs.time_ms(lambda: bc.cholesky_blocked(K16), 5)
    out[f"linalg_cholesky_{cs.K_N}_ms"] = cs.time_ms(lambda: torch.linalg.cholesky(K16), 5)
    for n in cs.FIT_NS:
        cfg = dataclasses.replace(cfg1, data=dataclasses.replace(cfg1.data, n=n))
        out[f"exact_fit_wall_s_{n}"] = cli.run_config(cfg, device=dev)["fit_wall_s"]

    # the other exact-path kernels
    out[f"B1_{cs.K_N}_ms"] = cs.time_ms(lambda: pw.pairwise_matrix(k, x16, x16, noise=noise,
                                                                  jitter=1e-6), 10)
    out[f"B2a_{cs.GRAD_N}_ms"] = cs.time_ms(lambda: pw.pairwise_jacobian(k, x4, x4), 10)
    out[f"B2b_{cs.GRAD_N}_pair_ms"] = cs.time_ms(
        lambda: pw.pairwise_hessian(k, x4, x4, pair=(0, 1)), 10)
    for p in (0, 1):  # the chunked Hessian's other SE planes
        out[f"B2b_{cs.GRAD_N}_pair_{p}{p}_ms"] = cs.time_ms(
            lambda: pw.pairwise_hessian(k, x4, x4, pair=(p, p)), 10)
    out[f"B2b_{cs.GRAD_N}_all_planes_ms"] = cs.time_ms(lambda: pw.pairwise_hessian(k, x4, x4), 10)

    def grad_and_hessian():  # as chip_smoke.py's exact path times it
        gpx.log_marginal_value_and_grad(k, x4, y4, cfg1.fit.noise, cfg1.fit.jitter)
        gpx.log_marginal_hessian(k, x4, y4, cfg1.fit.noise, cfg1.fit.jitter)

    grad_and_hessian()
    out[f"grad_hess_wall_s_{cs.GRAD_N}"] = statistics.median(
        wall_s(grad_and_hessian) for _ in range(15))
    del K16
    torch.cuda.empty_cache()

    # B4-ARD and the ARD fit
    xa, ya, ka = cs.ard_problem(cs.ITER_N, dev)
    for r in (1, 8, 64):
        v = torch.randn(cs.ITER_N, r, generator=gen).to(dev)
        out[f"B4_ARD_r{r}_ms"] = cs.time_ms(
            lambda: pw.kernel_matvec_fused(ka, xa, v, noise, cs.ITER_JITTER), 5)
    for key in ("ard_fit_iterative_wall_s", "ard_fit_iterative_warm_wall_s"):
        out[key] = wall_s(lambda: gpx.fit_iterative(ka, xa, ya, cs.ITER_NOISE, cs.seed(12),
                                                    **cs.ITER_OPTS))
    xa16 = xa[:cs.K_N].contiguous()
    out[f"B6_{cs.K_N}_ms"] = cs.time_ms(lambda: pw.pairwise_matrix_ard(
        ka, xa16, xa16, noise=noise, jitter=cs.ITER_JITTER), 10)

    # B6 at krylov.pivoted_cholesky's shapes: the column it built before,
    # the row it builds now
    piv = xa[cs.ITER_N // 3:cs.ITER_N // 3 + 1].contiguous()
    out[f"B6_pivot_column_{cs.ITER_N}_ms"] = cs.time_ms(
        lambda: pw.pairwise_matrix_ard(ka, xa, piv), 200)
    out[f"B6_pivot_row_{cs.ITER_N}_ms"] = cs.time_ms(
        lambda: pw.pairwise_matrix_ard(ka, piv, xa), 200)
    return out


def measure_products(dev) -> dict:
    """The SE and periodic products (B4, B5) and the SE paths over them."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    out = {}
    gen = torch.Generator().manual_seed(1)
    noise = torch.tensor(cs.ITER_NOISE, dtype=torch.float32, device=dev)
    xs, ys, ks = cs.sine_problem(cs.ITER_N, dev)
    kp = gpx.PeriodicKernel(1.0, 1.0, 0.5, dtype=torch.float32, device=dev)
    u = torch.randn(cs.ITER_N, 9, generator=gen).to(dev)
    for name, kern, rs in (("SE", ks, (1, 8, 9, 64)), ("periodic", kp, (1, 8))):
        for r in rs:
            v = torch.randn(cs.ITER_N, r, generator=gen).to(dev)
            out[f"B4_{name}_r{r}_ms"] = cs.time_ms(
                lambda: pw.kernel_matvec_fused(kern, xs, v, noise, cs.ITER_JITTER), 10)
        out[f"B5_{name}_r9_ms"] = cs.time_ms(lambda: pw.kernel_jacvec_fused(kern, xs, u), 5)
    # B1 at krylov.pivoted_cholesky's shapes, column and row
    piv = xs[cs.ITER_N // 3:cs.ITER_N // 3 + 1].contiguous()
    out[f"B1_pivot_column_{cs.ITER_N}_ms"] = cs.time_ms(
        lambda: pw.pairwise_matrix(ks, xs, piv), 200)
    row = pivot_row_fn(pw, ks, xs)
    out[f"B1_pivot_row_{cs.ITER_N}_ms"] = cs.time_ms(lambda: row(piv), 200)
    out["B1_pivot_row_call_us"] = cs.call_us(lambda: row(piv))
    for key in ("se_fit_iterative_wall_s", "se_fit_iterative_warm_wall_s"):
        out[key] = wall_s(lambda: gpx.fit_iterative(ks, xs, ys, cs.ITER_NOISE, cs.seed(10),
                                                    **cs.ITER_OPTS))
    for key in ("se_value_and_grad_wall_s", "se_value_and_grad_warm_wall_s"):
        out[key] = wall_s(lambda: gpx.log_marginal_value_and_grad_iterative(
            ks, xs, ys, cs.ITER_NOISE, cs.seed(11), **cs.ITER_OPTS))
    return out


def profile(dev, out_dir: str) -> dict:
    """Device time by kernel of one warm SE fit, SE value+grad and ARD fit
    at ITER_N, of one exact fit at K_N, of one gradient + chunked Hessian
    at GRAD_N, of 100 B1 and B6 launches at each pivot shape of the
    pivoted Cholesky (the kernel alone, without the time between launches),
    and of one batched value+grad of CHAINS chains at CHAIN_N."""
    import dataclasses

    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    xa, ya, ka = cs.ard_problem(cs.ITER_N, dev)
    xs, ys, ks = cs.sine_problem(cs.ITER_N, dev)
    cfg1 = CONFIGS["config1_fit_se500"]
    x, y, _ = (torch.as_tensor(a, device=dev)
               for a in make_data(dataclasses.replace(cfg1.data, n=cs.K_N), "float32"))
    k = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float32, device=dev)
    x4, y4, _ = (torch.as_tensor(a, device=dev)
                 for a in make_data(dataclasses.replace(cfg1.data, n=cs.GRAD_N), "float32"))
    pa = xa[cs.ITER_N // 3:cs.ITER_N // 3 + 1].contiguous()
    ps = xs[cs.ITER_N // 3:cs.ITER_N // 3 + 1].contiguous()

    def times100(fn):
        return lambda: [fn() for _ in range(100)]

    runs = {
        f"se_fit_iterative_{cs.ITER_N}": lambda: gpx.fit_iterative(
            ks, xs, ys, cs.ITER_NOISE, cs.seed(10), **cs.ITER_OPTS),
        f"se_value_and_grad_{cs.ITER_N}": lambda: gpx.log_marginal_value_and_grad_iterative(
            ks, xs, ys, cs.ITER_NOISE, cs.seed(11), **cs.ITER_OPTS),
        f"ard_fit_iterative_{cs.ITER_N}": lambda: gpx.fit_iterative(
            ka, xa, ya, cs.ITER_NOISE, cs.seed(12), **cs.ITER_OPTS),
        f"exact_fit_{cs.K_N}": lambda: gpx.fit(k, x, y, cfg1.fit.noise, cfg1.fit.jitter),
        f"grad_hess_{cs.GRAD_N}": lambda: (
            gpx.log_marginal_value_and_grad(k, x4, y4, cfg1.fit.noise, cfg1.fit.jitter),
            gpx.log_marginal_hessian(k, x4, y4, cfg1.fit.noise, cfg1.fit.jitter)),
        "B6_pivot_column_x100": times100(lambda: pw.pairwise_matrix_ard(ka, xa, pa)),
        "B6_pivot_row_x100": times100(lambda: pw.pairwise_matrix_ard(ka, pa, xa)),
        "B1_pivot_column_x100": times100(lambda: pw.pairwise_matrix(ks, xs, ps)),
        "B1_pivot_row_x100": times100(functools.partial(pivot_row_fn(pw, ks, xs), ps)),
    }
    if hasattr(gpx, "Matern52Kernel"):
        k52 = cs.new_kernel("matern52", (1.0, float(ks.w)), torch.float32, dev)
        kt = cs.tree_kernel("qp", torch.float32, dev, se=(1.0, float(ks.w)))
        runs[f"matern52_fit_iterative_{cs.ITER_N}"] = lambda: gpx.fit_iterative(
            k52, xs, ys, cs.ITER_NOISE, cs.seed(30), **cs.ITER_OPTS)
        runs[f"tree_fit_iterative_{cs.ITER_N}"] = lambda: gpx.fit_iterative(
            kt, xs, ys, cs.ITER_NOISE, cs.seed(33), **cs.ITER_OPTS)
    if hasattr(gpx.models.gp, "log_marginal_value_and_grad_chains"):
        xc, kc, theta = cs.chain_problem(dev, torch.float32, "se")
        yc = torch.sin(2 * xc)
        runs[f"value_and_grad_chains_{cs.CHAINS}x{cs.CHAIN_N}"] = (
            lambda: gpx.models.gp.log_marginal_value_and_grad_chains(kc, xc, yc, theta, 1e-6))
    result = {}
    for name, fn in runs.items():
        fn()  # warm
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall = wall_s(fn)
        by_name = collections.Counter()
        counts = collections.Counter()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                by_name[evt.name] += evt.device_time_total / 1e3
                counts[evt.name] += 1
        result[name] = {"wall_s": wall, "device_ms": sum(by_name.values()),
                        "kernels": [{"name": n[:120], "ms": t, "launches": counts[n]}
                                    for n, t in by_name.most_common(25)]}
    os.makedirs(out_dir, exist_ok=True)
    Path(out_dir, "profile.json").write_text(json.dumps(result, indent=1))
    return {name: {"wall_s": r["wall_s"], "device_ms": r["device_ms"],
                   "top": [(k["name"][:60], round(k["ms"], 3), k["launches"])
                           for k in r["kernels"][:8]]}
            for name, r in result.items()}


def ptxas(sources: list) -> int:
    """Compile kernel sources with ``-Xptxas -v``, one nvcc each, started
    together, and print, per kernel, its registers, spill bytes and stack
    frame, and each source's compile seconds."""
    from gaussian_processes_tpu_torch.ops import _build

    status = 0
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, source in enumerate(sources):
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(_build.CSRC), "-c", "-o", str(Path(tmp) / f"{i}.o"),
                   str(_build.CSRC / source)]
            procs.append((source, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)))
        for source, t0, proc in procs:
            _, err = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                print(err, file=sys.stderr)
                status = 1
                continue
            filt = subprocess.run(["cu++filt"], input=err, capture_output=True, text=True)
            text = filt.stdout if filt.returncode == 0 else err
            kernels = re.findall(
                r"Compiling entry function '(.*?)' for 'sm_90a'.*?(\d+) bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers",
                text, flags=re.S)
            for name, stack, stores, loads, regs in kernels:
                name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\(int\)|^void ", "", name)
                print(json.dumps({"kernel": name.split(">(")[0] + ">", "registers": int(regs),
                                  "spill_stores": int(stores), "spill_loads": int(loads),
                                  "stack": int(stack)}))
            print(json.dumps({"source": source, "kernels": len(kernels), "compile_s": seconds}))
    return status


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--profile", default=None, metavar="DIR")
    parser.add_argument("--ptxas", default=None, nargs="+", metavar="SOURCE")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))  # ahead of this file's directory
    if args.ptxas:
        return ptxas(args.ptxas)

    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    card = cs.card_name_and_power_limit()
    import gaussian_processes_tpu_torch as gpx

    dev = torch.device("cuda", 0)
    print(card, flush=True)
    result = {"root": args.root, "package": str(Path(gpx.__file__).parent), "card": card,
              **measure(dev)}
    if args.profile:
        result["profile"] = profile(dev, args.profile)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
