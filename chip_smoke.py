#!/usr/bin/env python3
"""Bring-up check of gaussian_processes_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from csrc/ (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card, at small
   shapes (SE, periodic and ARD, square and rectangular, sizes that are not
   tile multiples, with and without the diagonal, 1 to 300 right-hand sides,
   B2b's every one-plane form, B4-ARD over D = 1..16 and B5 over n and r
   with bit-identical repeats, B6 over D = 1, 3, 8, 16 at ragged, pivot-row,
   pivot-column and few-row shapes with K(x, x) bitwise symmetric and its
   diagonal exact, B3 with and without its inverse over a batch of 64
   tiles with non-PD and NaN ones, float32 and float64; the same for
   Matérn 3/2, Matérn 5/2 and RQ in B1, B2a, B2b, B4 and B5, and for
   Sum/Product trees of depth 1 and 2 in B1's and B4's tree bodies) and at
   the shapes of the main paths (B1 and B6 also at the pivoted Cholesky's
   pivot row and column, B2b at each SE plane), where it also times both
   with CUDA events, times the PyTorch calls for the same function where
   there are any (``torch.linalg.cholesky_ex`` for B3's factor, followed by
   ``solve_triangular`` for its inverse) and computes each kernel's bound.
   B1 and B2a over a table of 64 chains' parameters and the blocked factor
   of a stack of 64 matrices (B3 on (64, 128, 128) stacks) are held against
   their plain versions at the samplers' N = 500, every family and the
   quasi-periodic tree, float32 and float64, with a non-PD chain that must
   be NaN alone.  B1 (every case) and B4's tree and RQ cases are held
   against the plain versions of their folded element
   (``pairwise_matrix_folded``, ``matvec_folded_reference``), B1 repeated
   bit for bit, its pivot rows (``pivot_rows``) bit for bit its columns;
   RQ's folded log at a = 0.7, 1.5 and 940, and at a = 940 against the
   float64 plain K and K V.
4. Drives the main paths, each with the launch counters reset just before
   it and read just after: the exact-GP path
   (the ``fit`` workload of BASELINE config #1 through the CLI at N=500 and
   N=16384 in float32, fit + predict through the library, the analytic
   gradient and the chunked Hessian of the log marginal likelihood at
   N=4096) and the matrix-free path (the bench's iterative workload, SE at
   N=65536: ``fit_iterative``, both predictions, the stochastic gradient; ARD
   over 8 dimensions: ``fit_iterative`` at N=65536 and the exact fit at
   N=16384; five Adam steps of ``fit_mle_iterative`` at N=16384), then
   through the CLI config #2 (periodic type-II MLE, 4 restarts) and config
   #3 (64 chains at N=500) with ChEES (cut to 150 + 150) and with NUTS (150 +
   150), float32.  Then the
   families and trees ported after SE and periodic: the exact path for
   Matérn 3/2, Matérn 5/2 and RQ (fit + predict at N=16384, gradient and
   chunked Hessian at N=4096 in float32 and float64); the matrix-free path
   for Matérn 5/2 (``fit_iterative``, predictive mean, stochastic gradient)
   and the stochastic gradient of Matérn 3/2 and RQ at N=65536; the
   quasi-periodic tree SE x periodic through ``fit_iterative`` at N=65536;
   config #2's MLE with RQ and a short ChEES run of config #3 with Matérn
   5/2 through the CLI; one batched value and gradient of 64 chains for the
   tree.  Then slice 3 and config #4: the single-card ``fit`` at N=65536
   (``fit-large-twin``: K and its factor, 34.5 GB), then, counted on its
   own, ``fit_large`` through the CLI on the same data (``fit-large``:
   ``fit_blockcyclic`` over the process group of one rank, B1's strip, B3
   under each diagonal block, one 17.2 GB strip);
   bench.py's Toeplitz fits at N=65536 and 2^20 and the Toeplitz gradient
   (B1's grid column, B2a's Jacobian columns); the Whittle posteriors'
   value and gradient at N=2^20 (SE for 1 and 16 chains, the quasi-periodic
   spectrum) and on a 1024^2 torus; ChEES on the Whittle posterior at 2^20
   with benchmarks/demo_bayes1m.py's settings (cut to 150 + 150) and through
   the CLI's
   grid1m_bayes_whittle; bench.py's SKI fit at N=65536 (twice) and its N-D
   SKI fit with one round of ``ski_kron_refine``.  Then slice 4: config
   sparse1m_sgpr through the CLI (N=2^20, m=1024 k-means centres) and
   bench.py's SGPR workload through the library (``sgpr``); ``elbo_sgpr``'s
   value and gradient in theta, noise and z at N=65536, m=512, through B1's
   autograd rule (B2a in its backward), 10 Adam steps of
   ``fit_mle(objective="sgpr")``, the 8-chain value and gradient of
   ``make_log_posterior_sgpr`` and a 16-chain 60 + 60 ChEES run on it
   (``sgpr-grad``); ``fit_laplace`` logistic and Poisson at n=4096 in
   float32 and float64 with the evidence's gradient through the blocked
   factor's autograd rule and 5 Adam steps of ``fit_laplace_mle``
   (``laplace``); the dense pathwise sampler on config #1's fit at N=16384
   and the iterative one on the matrix-free SE workload (``pathwise``);
   bench.py's RFF fit at N=2^20, F=2048 (``rff``, no hand kernel).  Then
   slice 5 over an NCCL process group of one rank (``initialize_cluster``
   with a local address): config #5 through the CLI's nuts_multihost task,
   1024 chains at N=500, its depth cut to 150 + 100 in chunks of 50 with
   every rank's state written to its checkpoint file and read back between
   chunks, and a 128-chain 10 + 10 run so chunked against one pass
   (``multihost-chains``: B1, B2a over the (1024, 3) table, B3 on
   (1024, 128, 128) stacks); the unsharded twins (``row-twins``:
   ``fit_iterative`` on B4 and on B1's strips, ``fit_sgpr``, the iterative
   log posterior on B4 and B5), then, counted on their own,
   ``fit_iterative_sharded`` on the matrix-free SE workload with B1's
   (n / W, 1024) strips, ``fit_sgpr_sharded`` on sparse1m_sgpr's data, and
   the data-sharded log posterior's value and gradient at N=16384, each
   held against its twin (``row-sharded``), and that log posterior with one
   strip of its matvec or of its Jacobian dropped, which its limits must
   catch; last ``dryrun.dryrun_multichip(1)`` (``dryrun``: every
   multi-device path on tiny shapes, the 2-D grid fit and the block-cyclic
   factor among them).
   Slice 5's kernel shapes (the 1024-chain table and stacks, the row
   strip, the block-cyclic strip that config #4's fit builds over the
   group of one rank) are held against their plain versions and timed
   beforehand.
   Requires every kernel of a path to have launched in that path's run.
5. Checks the results against independent plain float64 computations on the
   card (pairwise twins + torch.linalg): true residuals of the iterative
   solves, the predictive mean against the generating function, and at
   N=16384 alpha, the log marginal and its gradient against a dense
   Cholesky, the stochastic ones within 4 of their standard errors; config
   #2's recovered period and noise against the truth and its lml against
   the same task in float64; config #3's posterior means against the
   reference's within 4 Monte-Carlo standard errors, with split R-hat,
   acceptance and divergences; the new families' fits, gradients and
   Hessians with the SE path's limits, their matrix-free solves' true
   residuals, RQ's MLE optimum, the Matérn ChEES run's R-hat and
   acceptance, and the tree's batched value and gradient against the plain
   float64 version on the CPU; config #4's true residual (B4 in float64, no
   float64 K), its peak memory against one strip, its lml against the
   single-card fit's and against ``fit_iterative`` in standard errors; the
   Toeplitz fits' true residuals and lml against the same path in float64;
   the Whittle values and gradients against float64; the N=2^20 posterior
   means against the committed reference draws
   (benchmarks/bayes1m_r5_accept.npz) and a float64 quadrature of the same
   posterior on the card; the SKI fit's repeat bit for bit and the refined
   residual in float64; slice 4's float32 bounds, predictions, gradients
   and evidences against the same computations in float64 (the gradients
   against the plain float64 version's autograd, no kernel), the SGPR
   bound below a dense float64 lml and equal to it with z = x on a grid,
   the pathwise draws' moments against the float64 posterior within
   Monte-Carlo error and every Matheron solve's true residual; config #5's
   posterior means against the float64 quadrature of config #3's posterior
   with R-hat and divergences, its resume bit for bit; the row-sharded
   solve's alpha against fit_iterative's and its true residual, the sharded
   SGPR bound against fit_sgpr's, the data-sharded log posterior against
   the unsharded one.
6. Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.

Any failed check makes the script exit non-zero without the final line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

LOG_2PI = 1.8378770664093453

# float32 kernel vs plain float32 (rtol, atol as a fraction of the plane's
# max): the kernels contract multiply-adds into FMAs, the plain version
# rounds every operation.  float64: the same at float64 round-off.
PAIRWISE_TOL = {"float32": (1e-5, 1e-6), "float64": (1e-11, 1e-12)}
# Cholesky: relative Frobenius distance of a tile's factor from the plain
# factor (forward), and ||L L^T - A|| / ||A|| (backward).  Two float32
# factorizations of a tile differ by up to ~kappa(A) u; config-1 tiles have
# kappa ~ 1e4, and the measured distance reaches 1.0e-5, so float32 takes
# 3e-5 (PERF.md); the backward error does not depend on kappa.
CHOL_TOL = {"float32": 3e-5, "float64": 1e-12}
CHOL_BACKWARD_TOL = {"float32": 1e-6, "float64": 1e-13}
# the blocked factor's backward error, as a multiple of torch.linalg's on
# the same float32 matrix
BLOCKED_BACKWARD_RATIO = 4.0
# B3's inverse: relative Frobenius distance from the plain inverse (two
# inverses of a triangular factor differ by up to ~kappa(L) u) and
# ||L^-1 L - I||_F / ||I||_F
INV_TOL = {"float32": 3e-4, "float64": 1e-11}
INV_RESIDUAL_TOL = {"float32": 1e-5, "float64": 1e-13}
# the main path against the plain float64 computation.  float32: the fit
# to the limits of PERF.md section 2; the gradient's h component cancels 4096 against
# 4083 inside tr(K^-1 dK/dh), so a float32 gradient at kappa(K) ~ 1.6e5 is
# good to ~1e-2 on any float32 path (the CPU's LAPACK path measures 7.7e-3)
FIT_LML_REL, FIT_MEAN_ABS, FIT_RMSE = 1e-3, 1e-2, 0.05
GRAD_REL = {"float32": 2e-2, "float64": 1e-8}
HESS_REL = {"float32": 1e-3, "float64": 1e-8}

# sizes: the fit at config 1's own N and at the single-card N; the analytic
# gradient and chunked Hessian; the main path's K build
FIT_NS = (500, 16384)
GRAD_N = 4096
K_N = 16384
# clock cycles of the spin kernel ahead of each timed run (~0.1 s on an H100)
HOST_AHEAD_CYCLES = 200_000_000

# B4/B5 against plain: |kernel - plain| <= tol * (|K| |V|)_i, the row's sum of
# absolute terms; the kernel sums a row's n products in another order (and
# across tiles in double) than the plain strips' matmuls
PRODUCT_TOL = {"float32": 1e-5, "float64": 1e-12}
# B2a contracted against its float64 twin: |kernel - twin| <= tol * 1/2
# sum_ij |dK_p| (|alpha_i alpha_j| + |K^-1_ij|), a chain's and plane's sum
# of absolute terms before cancellation; the kernel sums the upper triangle
# in registers, blocks and a second pass, the twin the whole square
CONTRACT_TOL = {"float32": 1e-5, "float64": 1e-12}

# the matrix-free workload (bench.py, bench_iterative): N = 65536 sorted
# uniform x on [-pi, pi], y = sin(2x) + 0.1 eps, SE with h = 1 and
# w = 100 * 2 pi / N, noise 0.1, jitter 1e-4, 8 probes, 150 iterations,
# tol 1e-6, pivoted-Cholesky rank 2048; ARD over [-2, 2]^8
ITER_N, ITER_CHECK_N, ARD_DIM = 65536, 16384, 8
ITER_NOISE, ITER_JITTER = 0.1, 1e-4
ITER_OPTS = dict(num_probes=8, num_iters=150, tol=1e-6, jitter=ITER_JITTER,
                 block_size=2048, precond_rank=2048)
# 0.75 x (0.8, 1.4, 3, ...): at (0.8, 1.4, 3, ...) float32 PCG on an H100
# ends with a recurrence residual of 6.7e-6 whose iterate has a true
# residual of 1.5e-4 (the recurrence drifts from the truth between
# replacements); no scale of w reached 1e-6 in 150 iterations, and 0.75 x
# gave the lowest true residual (PERF.md, Findings)
ARD_W = (0.6, 1.05, 2.25, 2.25, 2.25, 2.25, 2.25, 2.25)
N_TEST_MEAN, N_TEST_DIAG = 1000, 64
# limits of the matrix-free path: true relative residual of a solve by a
# plain float64 matvec, RMSE of the mean against sin(2x), alpha against a
# dense float64 solve at N=16384, stochastic estimates in standard errors
ITER_RESIDUAL, ITER_RMSE, ITER_ALPHA_REL, ITER_SE = 1e-4, 0.05, 1e-3, 4.0

# the samplers' batched evaluation: config #3's 64 chains at its N, each
# chain's (h, w[, p], s) drawn around config #3's posterior (BASELINE.md)
CHAINS, CHAIN_N, CHAIN_NONPD = 64, 500, 7
CHAIN_CENTER = {"se": (1.7, 1.16, 0.094), "periodic": (1.0, 1.0, 0.5, 0.1),
                "matern32": (1.7, 1.16, 0.094), "matern52": (1.7, 1.16, 0.094),
                "rq": (1.0, 1.0, 1.5, 0.1), "tree": (1.7, 1.16, 1.0, 1.0, 0.5, 0.094)}
# config #2 (BASELINE.md: the reference recovered p = 0.4998, s = 0.098 on
# sin(2x) data, whose period pi is p = 0.5 in the kernel's units).  Which
# mode a restart climbs into is chaotic in the rounding: from the same four
# starts the float64 run finds p = 0.5 and the float32 run on the card
# p = 1.0 (a local maximum, 11.7 nats lower), and the JAX package's own
# L-BFGS from its own four starts finds p = 0.5 in float32 and the
# degenerate p -> infinity in float64 (PERF.md).  So the float64 run holds
# the period and noise, the float32 run the noise and a converged optimum:
# its lml, in float64, within MLE_LML_NATS of where float64 L-BFGS goes from
# it (the float32 value's own error, ~0.5 nats near p = 0.5, is printed)
MLE_P, MLE_P_TOL, MLE_S, MLE_S_TOL, MLE_LML_NATS = 0.5, 0.01, 0.1, 0.02, 0.1
# config #3: the posterior means of (h, w, s) to within this many
# Monte-Carlo standard errors (sd / sqrt(ESS)) of this run's draws, against
# the float64 quadrature of the same posterior on the card (a grid over u =
# log theta, GRID points per axis between the bounds); the reference's
# published means (BASELINE.md:39) are printed beside: its ChEES h lies
# 0.027 below the quadrature (PERF.md, Findings)
CHEES_REF, NUTS_REF, SAMPLER_SE = (1.704, 1.160, 0.0938), (1.715, 1.162, 0.0938), 4.0
GRID = ((-1.4, 3.4, 97), (-0.6, 0.9, 61), (-2.53, -2.20, 34))
GRID_EDGE_MASS = 1e-4
CHEES_RHAT = 1.01
# ChEES's mean acceptance: its step size adapts the chains' harmonic-mean
# acceptance to 0.651, which leaves the arithmetic mean near 0.95 (the JAX
# package's own ChEES gave 0.945 and the port 0.955 on one CPU problem,
# PERF.md); the reference's 0.759 came from arithmetic pooling.  Above 0.99
# the chains would be frozen
CHEES_ACCEPT = (0.55, 0.99)
NUTS_DIVERGENT = 0.01
# NUTS: 500 warmup + 1000 draws took 106 and 154 s on the card (the same
# draws; the host sets the wall), so the run is cut, first to 200 + 300,
# then to 150 + 150 (the shortest warmup with a mass-matrix window) to make
# room for config #5, with the looser R-hat limit (split R-hat runs near
# 1 + (tau - 1) / (2 n) for n draws a half-chain: the 200 + 300 run's
# tau ~ 4.6 gives ~1.024 at 150 draws, read 1.028; the full run goes
# through the CLI by hand; PERF.md)
NUTS_WARMUP, NUTS_SAMPLES = 150, 150
NUTS_RHAT = 1.01 if NUTS_SAMPLES == 1000 else 1.05
# ChEES: cut from 500 + 1000 (117.6 s on the card) to 500 + 500, then to
# 250 + 250 to make room for config #5's 1024 chains (tau ~ 1.3 at 500 +
# 500: R-hat ~1.001 at 250 draws; read 0.9992) and to 150 + 150 for the
# block-cyclic fit and the dryrun (R-hat ~1.002); its gates stay (PERF.md)
CHEES_WARMUP, CHEES_SAMPLES = 150, 150

# the least time the card could take for a kernel's work: the larger of its
# operations over the float32 peak outside the tensor cores and its bytes
# (each input read once, each output written once) over the HBM rate (NVIDIA
# H100 SXM data sheet, at 700 W)
F32_PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# operations (flops; an FMA is 2, an exp 1) per element (i, j) of each
# closed form, the least the function needs, with every per-call, per-row
# and per-column constant hoisted out (coordinates scaled by 1/w once per
# call; h^2 and a plane's constant applied once per row or folded into the
# exponent's accumulator): ARD over D dimensions is a subtract and a
# multiply-add per dimension and one exp (3D + 1); SE is ARD at D = 1 (4);
# its two Jacobian values E and E d^2 one product more (5); one Hessian
# plane E times at most two products (6); a product with r columns adds 2r
# per element, P Jacobian values 2Pr.  The Cholesky of a b x b tile is
# b^3 / 3, its triangular inverse b^3 / 3 more.
SE_K_OPS, SE_JAC_OPS, SE_HESS_PLANE_OPS = 4, 5, 6
# periodic: subtract, scale by 1 / 2p, sine, scale, square, exp (6); its
# three Jacobian values E, E g^2 and E d sin(2u) add a second sine with its
# argument's product and three products (11); a sine counts 1, as an exp does
PERIODIC_K_OPS, PERIODIC_JAC_OPS = 6, 11
# what the special-function units alone allow: 16 results per SM per clock
# (exponentials, and sines were they taken there), an eighth of the FMA
# lanes, at the clock that F32_PEAK_FLOPS implies (2 flops per lane per
# clock).  Printed beside bound_ms, which counts an exp as one operation.
SFU_PER_S = F32_PEAK_FLOPS / 2 / 8


# Matérn: subtract, scale by s (|d| is an operand modifier), one exp; the
# polynomial in u as FMAs with h^2 folded into its coefficients, then times E:
# 3/2 one FMA and a product (6), 5/2 two FMAs (8).  Their Jacobian values:
# u = t / L (1), 3/2 (1 + u) E as one FMA and u^2 E as two products (7), 5/2
# u E, u^2 E, (1 + u + u^2 / 3) E as an add and an FMA, u^2 (1 + u) E as an
# FMA (11).  RQ: subtract, scale, B = t^2 + 1 as an FMA, log, the exponent
# a log B with log h^2 added (FMA), exp (8); its three values add t^2, 1 / B,
# q = t^2 / B, q B^-a and B^-a (q - L' log B) as an FMA and a product (14).
# One Hessian plane: a Matérn (w, w) value u^2 (u - 3) E (with the shared
# exp, 8); RQ's (a, a) value B^-a ((t^2 / B - ln B)^2 + z^2 / (a^3 B^2)) (16).
# The quasi-periodic tree SE x periodic: both closed forms and their product.
MATERN32_K_OPS, MATERN52_K_OPS, RQ_K_OPS = 6, 8, 8
MATERN32_JAC_OPS, MATERN52_JAC_OPS, RQ_JAC_OPS = 7, 11, 14
MATERN_HESS_PLANE_OPS, RQ_HESS_PLANE_OPS = 8, 16
TREE_K_OPS = SE_K_OPS + PERIODIC_K_OPS + 1
# special-function results per element of the folded element (B1, B4): one
# ex2 per product (a tree of one product: 1), RQ's lg2 one more; the sine is
# reduced by hand on the FMA pipe (sfu_floor_ms: this design's own count)
TREE_SFU, PERIODIC_K_SFU = 1, 1
# per family: K ops, Jacobian ops, the timed Hessian plane and its ops,
# special-function results per element (K; Jacobian)
NEW_FAMILY_OPS = {
    "matern32": (MATERN32_K_OPS, MATERN32_JAC_OPS, (1, 1), MATERN_HESS_PLANE_OPS, 1, 1),
    "matern52": (MATERN52_K_OPS, MATERN52_JAC_OPS, (1, 1), MATERN_HESS_PLANE_OPS, 1, 1),
    "rq": (RQ_K_OPS, RQ_JAC_OPS, (2, 2), RQ_HESS_PLANE_OPS, 2, 2),
}
# the families ported after SE and periodic: their kernels at the exact
# path's hyperparameters (h = 1, w = 1; RQ a = 1.5), and their small-shape
# hyperparameters
NEW_FAMILY_PARAMS = {"matern32": (1.0, 1.0), "matern52": (1.0, 1.0), "rq": (1.0, 1.0, 1.5)}
NEW_FAMILY_SMALL = {"matern32": (1.3, 0.7), "matern52": (1.1, 0.9), "rq": (0.9, 1.1, 1.5)}
# the matrix-free Matérn 5/2, Matérn 3/2 and RQ phases take the SE workload's
# data, lengthscale and solver settings; the tree phase the quasi-periodic
# pair of tests/test_iterative.py, SE x periodic(1.0, 1.3, 2.0), with the SE
# factor at the SE workload's h = 1 and w: with that test's SE(1.2, 0.6) at
# N=65536, K has rank ~50 against a noise of 0.01 and float32 PCG ended at a
# recurrence residual of 8.5e-5 and a true residual of 4.6e-4 in 150
# iterations (my chip call 1, PR 7).  The small-shape checks and the chain
# phase keep SE(1.2, 0.6).
TREE_QP = ((1.2, 0.6), (1.0, 1.3, 2.0))
# config #2's MLE task with the RQ kernel (from h = 1, w = 1, a = 1.5); a short
# ChEES run of config #3 with Matérn 5/2; both float32.  200 + 200 transitions
# took 760 s on the card (822 leapfrogs a transition on average, my chip call
# 1, PR 7), so the run is cut to 50 + 50
MLE_RQ_START = (1.0, 1.0, 1.5)
CHEES_NEW_WARMUP, CHEES_NEW_SAMPLES, CHEES_NEW_RHAT = 50, 50, 1.05


def new_kernel(family, params, dtype, dev):
    import gaussian_processes_tpu_torch as gpx

    cls = {"matern32": gpx.Matern32Kernel, "matern52": gpx.Matern52Kernel,
           "rq": gpx.RationalQuadraticKernel}[family]
    return cls(*params, dtype=dtype, device=dev)


def tree_kernel(name, dtype, dev, se=TREE_QP[0]):
    """The quasi-periodic product SE x periodic (depth 1), a sum of products
    over Matérn, RQ and periodic leaves (depth 2), a product of a sum; ``se``
    is the SE leaf's (h, w)."""
    import gaussian_processes_tpu_torch as gpx

    se = gpx.GaussianKernel(*se, dtype=dtype, device=dev)
    per = gpx.PeriodicKernel(*TREE_QP[1], dtype=dtype, device=dev)
    if name == "qp":
        return gpx.ProductKernel(se, per)
    if name == "sum_of_products":
        return gpx.SumKernel(
            gpx.ProductKernel(gpx.Matern52Kernel(1.0, 0.7, dtype=dtype, device=dev),
                              gpx.RationalQuadraticKernel(1.0, 1.3, 0.7, dtype=dtype,
                                                          device=dev)),
            gpx.ProductKernel(per, gpx.Matern32Kernel(0.8, 2.0, dtype=dtype, device=dev)))
    return gpx.ProductKernel(gpx.SumKernel(se, per),
                             gpx.GaussianKernel(0.5, 2.0, dtype=dtype, device=dev))


TREES = ("qp", "sum_of_products", "product_of_sum")


def ard_ops(dim: int) -> int:
    return 3 * dim + 1

KERNEL_ROWS = [
    # (name, launch counter, timed row, source, replaces[, the paths whose
    # launches it counts, all by default]); B3's rows time the variant with
    # the inverse, the one the paths launch
    ("B1 pairwise K", "pairwise_k", "pairwise_k", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:88"),
    ("B2a pairwise dK/dtheta", "pairwise_jac", "pairwise_jac",
     "gaussian_processes_tpu_torch/csrc/pairwise.cuh", "gaussian_processes_tpu/ops/pairwise.py:270"),
    ("B2b pairwise d2K/dtheta2", "pairwise_hess", "pairwise_hess",
     "gaussian_processes_tpu_torch/csrc/pairwise.cuh", "gaussian_processes_tpu/ops/pairwise.py:277"),
    ("B3 Cholesky tile with its inverse", "chol_tile", "chol_tile_inv",
     "gaussian_processes_tpu_torch/csrc/chol_tile.cu",
     "gaussian_processes_tpu/ops/blocked_cholesky.py:83"),
    ("B4 fused kernel matvec", "kernel_matvec", "kernel_matvec",
     "gaussian_processes_tpu_torch/csrc/matvec.cuh", "gaussian_processes_tpu/ops/pairwise.py:363"),
    ("B4-ARD fused ARD matvec", "kernel_matvec_ard", "kernel_matvec_ard",
     "gaussian_processes_tpu_torch/csrc/ard_matvec.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:398"),
    ("B5 fused Jacobian product", "kernel_jacvec", "kernel_jacvec",
     "gaussian_processes_tpu_torch/csrc/matvec.cuh", "gaussian_processes_tpu/ops/pairwise.py:528"),
    ("B6 ARD pairwise K", "pairwise_ard", "pairwise_ard",
     "gaussian_processes_tpu_torch/csrc/ard_pairwise.cu",
     "gaussian_processes_tpu/ops/pairwise.py:188"),
    # the samplers' and MLE's cases: one launch per batched evaluation (B2a's
    # Jacobians a tree's alone; a leaf takes B2a contracted, below)
    ("B1 pairwise K over a chain table", "pairwise_k_chains", "pairwise_k_chains",
     "gaussian_processes_tpu_torch/csrc/pairwise.cuh", "gaussian_processes_tpu/ops/pairwise.py:88"),
    ("B2a pairwise dK/dtheta over a chain table", "pairwise_jac_chains", "pairwise_jac_chains",
     "gaussian_processes_tpu_torch/csrc/pairwise.cuh", "gaussian_processes_tpu/ops/pairwise.py:270"),
    ("B3 Cholesky tile with its inverse on chain stacks", "chol_tile", "chol_tile_inv_chains",
     "gaussian_processes_tpu_torch/csrc/chol_tile.cu",
     "gaussian_processes_tpu/ops/blocked_cholesky.py:83",
     ("mle", "chees", "nuts", "mle-rq", "chees-matern52", "chains-tree")),
    # the families and trees ported after SE and periodic, one row per case
    *((f"B1 pairwise K, {fam}", f"pairwise_k_{fam}", f"pairwise_k_{fam}",
       "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:88") for fam in NEW_FAMILY_OPS),
    ("B1 pairwise K, Sum/Product tree body (pivot row)", "pairwise_k_tree",
     "pairwise_k_tree_pivot_row", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:88"),
    *((f"B2a pairwise dK/dtheta, {fam}", f"pairwise_jac_{fam}", f"pairwise_jac_{fam}",
       "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:270") for fam in NEW_FAMILY_OPS),
    *((f"B2b pairwise d2K/dtheta2 one plane, {fam}", f"pairwise_hess_{fam}", f"pairwise_hess_{fam}",
       "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:277") for fam in NEW_FAMILY_OPS),
    *((f"B4 fused kernel matvec, {fam}", f"kernel_matvec_{fam}", f"kernel_matvec_{fam}",
       "gaussian_processes_tpu_torch/csrc/matvec.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:363") for fam in NEW_FAMILY_OPS),
    ("B4 fused kernel matvec, Sum/Product tree body", "kernel_matvec_tree", "kernel_matvec_tree",
     "gaussian_processes_tpu_torch/csrc/matvec.cuh", "gaussian_processes_tpu/ops/pairwise.py:363"),
    *((f"B5 fused Jacobian product, {fam}", f"kernel_jacvec_{fam}", f"kernel_jacvec_{fam}",
       "gaussian_processes_tpu_torch/csrc/matvec.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:528") for fam in NEW_FAMILY_OPS),
    *((f"B1 pairwise K over a chain table, {fam}", f"pairwise_k_chains_{fam}",
       f"pairwise_k_chains_{fam}", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:88") for fam in ("matern52", "rq", "tree")),
    *((f"B2a pairwise dK/dtheta over a chain table, {fam}", f"pairwise_jac_chains_{fam}",
       f"pairwise_jac_chains_{fam}", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:270") for fam in ("matern52", "rq")),
    # B2a contracted: a leaf's gradient terms on the samplers' and MLE's paths
    ("B2a contracted over a chain table", "pairwise_jac_contract_chains",
     "pairwise_jac_contract_chains", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:270"),
    *((f"B2a contracted over a chain table, {fam}", f"pairwise_jac_contract_chains_{fam}",
       f"pairwise_jac_contract_chains_{fam}", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
       "gaussian_processes_tpu/ops/pairwise.py:270") for fam in ("matern52", "rq")),
    # slice 3: the grids' first columns (toeplitz_column, jacobian_columns)
    ("B1 pairwise K, grid column (n x 1)", "pairwise_k", "pairwise_k_grid_column",
     "gaussian_processes_tpu_torch/csrc/pairwise.cuh", "gaussian_processes_tpu/ops/pairwise.py:88",
     ("toeplitz",)),
    ("B2a pairwise dK/dtheta, grid columns (P x n x 1)", "pairwise_jac",
     "pairwise_jac_grid_column", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:270", ("toeplitz",)),
    # slice 4: the SGPR sweep's K(z, x_j) and, in its gradient, B1's
    # autograd rule taking dK/dtheta from B2a at the same shape
    ("B1 pairwise K, SGPR cross (m x b, no diagonal)", "pairwise_k", "pairwise_k_sgpr_cross",
     "gaussian_processes_tpu_torch/csrc/pairwise.cuh", "gaussian_processes_tpu/ops/pairwise.py:88",
     ("sgpr", "sgpr-grad")),
    ("B2a pairwise dK/dtheta, SGPR backward (P x m x b)", "pairwise_jac",
     "pairwise_jac_sgpr_backward", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:270", ("sgpr-grad",)),
    # slice 5: config #5's 1024-chain tables and stacks, and one rank's
    # (n / W, block) row strips of the row-sharded matvec
    ("B1 pairwise K over a chain table, 1024 chains", "pairwise_k_chains",
     "pairwise_k_chains_1024", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:88", ("multihost-chains",)),
    ("B2a pairwise dK/dtheta over a chain table, 1024 chains", "pairwise_jac_chains",
     "pairwise_jac_chains_1024", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:270", ("multihost-chains",)),
    ("B3 Cholesky tile with its inverse on 1024-chain stacks", "chol_tile",
     "chol_tile_inv_chains_1024", "gaussian_processes_tpu_torch/csrc/chol_tile.cu",
     "gaussian_processes_tpu/ops/blocked_cholesky.py:83", ("multihost-chains",)),
    ("B2a contracted over a chain table, 1024 chains", "pairwise_jac_contract_chains",
     "pairwise_jac_contract_chains_1024", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:270", ("multihost-chains",)),
    ("B1 pairwise K, row strip (n/W x block, no diagonal)", "pairwise_k", "pairwise_k_row_strip",
     "gaussian_processes_tpu_torch/csrc/pairwise.cuh", "gaussian_processes_tpu/ops/pairwise.py:88",
     ("row-sharded",)),
    # slice 5c: the block-cyclic strip (m_loc b, n_pad) that fit_blockcyclic
    # builds on the fit-large path (W = 1: (N, N))
    ("B1 pairwise K, block-cyclic strip (m_loc b x n_pad, no diagonal)", "pairwise_k",
     "pairwise_k_blockcyclic_strip", "gaussian_processes_tpu_torch/csrc/pairwise.cuh",
     "gaussian_processes_tpu/ops/pairwise.py:88", ("fit-large",)),
]
# the launch counters each main path must move: B1 builds the pivot rows
# and cross-covariances of the matrix-free path, B3 factors its exact ARD
# fit; MLE (one chain) and the samplers evaluate through the chain tables,
# a leaf's gradient terms through B2a contracted
PATH_KERNELS = {
    "exact": ("pairwise_k", "pairwise_jac", "pairwise_hess", "chol_tile"),
    "matrix-free": ("pairwise_k", "chol_tile", "kernel_matvec", "kernel_matvec_ard",
                    "kernel_jacvec", "pairwise_ard"),
    "mle": ("pairwise_k_chains", "pairwise_jac_contract_chains", "chol_tile"),
    "chees": ("pairwise_k_chains", "pairwise_jac_contract_chains", "chol_tile"),
    "nuts": ("pairwise_k_chains", "pairwise_jac_contract_chains", "chol_tile"),
    # the families and trees ported after SE and periodic
    "exact-new": tuple(f"{k}_{fam}" for fam in NEW_FAMILY_OPS
                       for k in ("pairwise_k", "pairwise_jac", "pairwise_hess")) + ("chol_tile",),
    "matrix-free-new": tuple(f"{k}_{fam}" for fam in NEW_FAMILY_OPS
                             for k in ("pairwise_k", "kernel_matvec", "kernel_jacvec")),
    "matrix-free-tree": ("pairwise_k_tree", "kernel_matvec_tree"),
    "mle-rq": ("pairwise_k_chains_rq", "pairwise_jac_contract_chains_rq", "chol_tile"),
    "chees-matern52": ("pairwise_k_chains_matern52", "pairwise_jac_contract_chains_matern52",
                       "chol_tile"),
    # a tree's K from B1's tree body, its dK/dtheta from its SE and periodic
    # leaves' B1 and B2a chain launches
    "chains-tree": ("pairwise_k_chains_tree", "pairwise_k_chains", "pairwise_jac_chains",
                    "chol_tile"),
    # slice 3 and config #4: B1 builds the single-card twin's K and B3
    # factors it; then, counted alone, B1 builds fit_blockcyclic's strip at
    # N=65536 and B3 factors its diagonal blocks; B1
    # builds the grids' (n, 1) columns and 1-D SKI's pivot rows, B6 the N-D
    # SKI's pivot rows; the Whittle densities (analytic spectra and FFTs)
    # launch no hand kernel
    "fit-large-twin": ("pairwise_k", "chol_tile"),
    "fit-large": ("pairwise_k", "chol_tile"),
    "toeplitz": ("pairwise_k", "pairwise_jac"),
    "whittle": (),
    "bayes-grid": (),
    "ski": ("pairwise_k",),
    "ski-refine": ("pairwise_ard",),
    # slice 4: B1 builds SGPR's K(z, x_j), Kuu and cross-covariances, and
    # under autograd B2a gives its theta-backward; Laplace factors B with the
    # blocked factor (B3) forward and backward; the dense pathwise sampler
    # runs on config #1's fit (B1, B3), the iterative one on B4's matvecs
    # and B1's pivot rows; RFF runs no hand kernel, as in the JAX package
    "sgpr": ("pairwise_k",),
    "sgpr-grad": ("pairwise_k", "pairwise_jac"),
    "laplace": ("pairwise_k", "pairwise_jac", "chol_tile"),
    "pathwise": ("pairwise_k", "chol_tile", "kernel_matvec"),
    "rff": (),
    # slice 5: config #5's leapfrogs over the 1024-chain table and stacks;
    # the unsharded twins of the row-sharded calls (B4, B5, and B1's strips
    # and pivot rows), then the row-sharded calls alone: their strips and
    # pivot rows (B1) and the data-sharded gradient's Jacobian strips (B2a)
    "multihost-chains": ("pairwise_k_chains", "pairwise_jac_contract_chains", "chol_tile"),
    "row-twins": ("pairwise_k", "kernel_matvec", "kernel_jacvec"),
    "row-sharded": ("pairwise_k", "pairwise_jac"),
    # slice 5c-5d: dryrun_multichip(1), every multi-device path on tiny
    # shapes: B1 (grid blocks, block-cyclic strips, cross-covariances, pivot
    # rows), B2a (the row-sharded gradient's Jacobian strips), B3 (the dense
    # factors; the samplers' chain tables count under their own names)
    "dryrun": ("pairwise_k", "pairwise_jac", "chol_tile"),
}


def bound(ops: float, nbytes: float) -> dict:
    """``bound_ms`` and ``bound_by`` for work of ``ops`` flops and ``nbytes``."""
    t_ops = ops / F32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sfu_floor_ms(count: float) -> float:
    """The least time for ``count`` special-function results, in ms."""
    return count / SFU_PER_S * 1e3


def card_name_and_power_limit() -> str:
    """The first card's line of ``nvidia-smi --query-gpu=name,power.limit``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Checks:
    """Records every comparison; failures are raised together at the end."""

    def __init__(self):
        self.failed = []

    def __call__(self, name: str, value: float, limit: float) -> float:
        ok = value <= limit
        print(f"  {'ok  ' if ok else 'FAIL'} {name}: {value:.3e} (limit {limit:.1e})",
              flush=True)
        if not ok:
            self.failed.append(name)
        return value


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, by
    CUDA events.  A spin kernel queued first keeps the card busy while the
    host enqueues the calls, so the host's time between launches is not
    counted (a call that waits for the card, as a copy from pageable host
    memory does, defeats this and is timed with its host gaps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_us(fn, iters: int = 1000) -> float:
    """Host wall per call of ``fn()`` in microseconds, over ``iters`` calls
    that end in a synchronize: what a loop of dependent calls (the pivoted
    Cholesky's rows) pays for each, launches and Python together."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def plane_violation(got, want, dtype_name: str) -> tuple:
    """(max |got - want|, max ratio of the error to its allowance); the
    allowance is rtol |want| + afrac max|plane| over the last two axes."""
    rtol, afrac = PAIRWISE_TOL[dtype_name]
    err = (got - want).abs()
    plane_max = want.abs().amax(dim=(-2, -1), keepdim=True)
    allowed = rtol * want.abs() + afrac * plane_max
    return float(err.max()), float((err / allowed).max())


def rel_fro(got, want) -> float:
    import torch

    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def backward(L, A) -> float:
    """||L L^T - A||_F / ||A||_F, accumulated in float64."""
    L = L.double()
    return rel_fro(L @ L.mT, A.double())


def product_violation(got, want, bound, dtype_name: str) -> tuple:
    """(max |got - want|, max ratio of the error to its allowance); the
    allowance is PRODUCT_TOL times the plain product of |K| and |V|."""
    err = (got - want).abs()
    return float(err.max()), float((err / (PRODUCT_TOL[dtype_name] * bound)).max())


def sine_problem(n, dev, dtype_name="float32", seed_=0):
    """bench.py's _sine_problem: sorted uniform x on [-pi, pi], y = sin(2x) +
    0.1 eps, drawn in float64 from ``seed_`` and cast; and the SE kernel with
    ~100 points per lengthscale, w = max(100 * 2 pi / n, 1e-3)."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    rng = np.random.default_rng(seed_)
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(dtype_name)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(n)).astype(dtype_name)
    dtype = getattr(torch, dtype_name)
    k = gpx.GaussianKernel(1.0, max(100.0 * 2 * np.pi / n, 1e-3), dtype=dtype, device=dev)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev), k


def ard_problem(n, dev):
    """x uniform on [-2, 2]^8, y = sin(2 x_0) + 0.5 cos(x_1) + 0.1 eps, seed 1;
    the ARD kernel with h = 1 and w = ARD_W, float32."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (n, ARD_DIM))
    y = np.sin(2 * x[:, 0]) + 0.5 * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    k = gpx.ARDGaussianKernel(1.0, torch.tensor(ARD_W), dtype=torch.float32, device=dev)
    return (torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.float32, device=dev), k)


def seed(i: int):
    import torch

    return torch.Generator().manual_seed(i)


def check_kernels_small(check, dev):
    """Phase 3a: every kernel against its plain version at small shapes."""
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel, PeriodicKernel
    from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("kernels vs plain, small shapes:", flush=True)
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        kernels = {"se": GaussianKernel(1.3, 0.7, dtype=dtype, device=dev),
                   "periodic": PeriodicKernel(0.9, 1.1, 2.0, dtype=dtype, device=dev),
                   **{fam: new_kernel(fam, NEW_FAMILY_SMALL[fam], dtype, dev)
                      for fam in NEW_FAMILY_SMALL},
                   **{f"tree {name}": tree_kernel(name, dtype, dev) for name in TREES}}
        for fam, k in kernels.items():
            for n, m in ((1000, 1000), (777, 1234)):
                x1 = (torch.rand(n, generator=gen, dtype=torch.float64) * 6 - 3).to(dev, dtype)
                x2 = x1 if n == m else (torch.rand(m, generator=gen, dtype=torch.float64) * 6 - 3).to(dev, dtype)
                tag = f"{fam} {n}x{m} {dname}"
                _, v = plane_violation(pw.pairwise_matrix(k, x1, x2),
                                       pw.pairwise_matrix_folded(k, x1, x2), dname)
                check(f"B1 {tag}", v, 1.0)
                got = pw.pairwise_matrix(k, x1, x2, noise=0.1, jitter=1e-6)
                _, v = plane_violation(got, pw.pairwise_matrix_folded(k, x1, x2, noise=0.1, jitter=1e-6),
                                       dname)
                check(f"B1+diag {tag}", v, 1.0)
                same = torch.equal(got, pw.pairwise_matrix(k, x1, x2, noise=0.1, jitter=1e-6))
                check(f"B1+diag {tag} repeat bit-identical (0 = yes)", 0.0 if same else 1.0, 0.0)
                if pw.is_tree(k):  # a tree's derivatives are built from its leaves'
                    continue
                _, v = plane_violation(pw.pairwise_jacobian(k, x1, x2),
                                       pw.pairwise_jacobian_reference(k, x1, x2), dname)
                check(f"B2a {tag}", v, 1.0)
                _, v = plane_violation(pw.pairwise_hessian(k, x1, x2),
                                       pw.pairwise_hessian_reference(k, x1, x2), dname)
                check(f"B2b {tag}", v, 1.0)
                # each one-plane instantiation, the pair in both orders
                worst = 0.0
                for p in range(k.n_params):
                    for q in range(k.n_params):
                        got = pw.pairwise_hessian(k, x1, x2, pair=(p, q))
                        for want in (pw.pairwise_hessian_reference(k, x1, x2, pair=(p, q)),
                                     pw.hessian_plane_folded(k, x1, x2, (p, q))):
                            worst = max(worst, plane_violation(got, want, dname)[1])
                check(f"B2b each plane {tag}", worst, 1.0)
        # B3 on SPD kernel tiles (the diagonal tiles of a config-1 matrix)
        x = torch.sort(torch.rand(512, generator=gen, dtype=torch.float64) * 6 - 3)[0].to(dev)
        K = pw.pairwise_matrix_reference(GaussianKernel(1.0, 1.0, dtype=torch.float64, device=dev),
                                         x, x, noise=0.1, jitter=1e-6)
        tiles = torch.stack([K[i:i + 128, i:i + 128] for i in range(0, 512, 128)]).to(dtype)
        got, want = bc.chol_tile(tiles.contiguous()), bc.cholesky_reference(tiles)
        check(f"B3 spd tiles x4 {dname}", rel_fro(got, want), CHOL_TOL[dname])
        check(f"B3 spd tiles x4 backward {dname}", backward(got, tiles), CHOL_BACKWARD_TOL[dname])
        check(f"B3 upper triangle zero {dname}", float(torch.triu(got, 1).abs().max()), 0.0)
        bad = tiles[0].clone()
        bad[60, 60] = -1.0
        got, want = bc.chol_tile(bad.contiguous()), bc.cholesky_reference(bad)
        same = torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got).any())
        check(f"B3 non-PD tile NaN pattern {dname} (0 = same)", 0.0 if same else 1.0, 0.0)
        check_tile_batch(check, dev, dtype, gen)


def check_tile_batch(check, dev, dtype, gen):
    """B3, with and without its inverse, over a batch of 64 kernel tiles (the
    per-chain factors of the samplers) of which four are not positive
    definite and four hold a NaN."""
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    dname = str(dtype).split(".")[-1]
    k = GaussianKernel(1.0, 1.0, dtype=torch.float64, device=dev)
    xs = torch.sort(torch.rand(16, 512, generator=gen, dtype=torch.float64) * 6 - 3, dim=1)[0]
    Ks = [pw.pairwise_matrix_reference(k, x.to(dev), x.to(dev), noise=0.1, jitter=1e-6) for x in xs]
    batch = torch.stack([Ks[b // 4][(b % 4) * 128:(b % 4 + 1) * 128, (b % 4) * 128:(b % 4 + 1) * 128]
                         for b in range(64)]).to(dtype)
    not_pd, has_nan = (3, 17, 40, 63), (5, 22, 41, 58)
    for b in not_pd:
        batch[b, 60 + b % 7, 60 + b % 7] = -1.0
    for b in has_nan:
        batch[b, 90, 11] = batch[b, 11, 90] = float("nan")
    batch = batch.contiguous()
    good = [b for b in range(64) if b not in not_pd + has_nan]
    bad = list(not_pd + has_nan)
    L = bc.chol_tile(batch)
    L2, Li = bc.chol_tile_inv(batch)
    Lr, Lir = bc.chol_tile_inv_reference(batch)
    tag = f"B3 batch of 64 {dname}"
    check(f"{tag}: good tiles vs plain", rel_fro(L[good], Lr[good]), CHOL_TOL[dname])
    check(f"{tag}: good tiles backward", backward(L[good], batch[good]), CHOL_BACKWARD_TOL[dname])
    same = torch.equal(L[good], L2[good]) and torch.equal(torch.isnan(L), torch.isnan(L2))
    check(f"{tag}: factor with and without the inverse bit-identical (0 = yes)",
          0.0 if same else 1.0, 0.0)
    check(f"{tag}: inverse vs plain", rel_fro(Li[good], Lir[good]), INV_TOL[dname])
    eye = torch.eye(128, dtype=torch.float64, device=dev).expand(len(good), 128, 128)
    check(f"{tag}: ||L^-1 L - I|| / ||I||",
          rel_fro(Li[good].double() @ L[good].double(), eye), INV_RESIDUAL_TOL[dname])
    lower = torch.tril(torch.ones(128, 128, dtype=torch.bool, device=dev))
    nan_ok = all(bool(torch.isnan(t[b][lower]).all()) and bool((t[b][~lower] == 0).all())
                 for t in (L, Li) for b in bad)
    check(f"{tag}: non-PD and NaN tiles all-NaN lower, zero upper (0 = yes)",
          0.0 if nan_ok else 1.0, 0.0)
    check(f"{tag}: NaN pattern as plain (0 = yes)",
          0.0 if torch.equal(torch.isnan(L), torch.isnan(Lr)) else 1.0, 0.0)
    check(f"{tag}: upper triangles zero", float(torch.triu(L[good], 1).abs().max()
                                                + torch.triu(Li[good], 1).abs().max()), 0.0)


def check_kernels_at_slice(check, dev) -> dict:
    """Phase 3b: kernels at the main path's shapes, timed against plain."""
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    print("kernels vs plain at the main path's shapes (float32):", flush=True)
    f32 = torch.float32
    k = GaussianKernel(1.0, 1.0, dtype=f32, device=dev)
    data = CONFIGS["config1_fit_se500"].data
    x16 = torch.as_tensor(make_data(dataclasses.replace(data, n=K_N), "float32")[0], device=dev)
    x4 = torch.as_tensor(make_data(dataclasses.replace(data, n=GRAD_N), "float32")[0], device=dev)
    rows = {}

    def record(key, got, want, kernel_fn, plain_fn, iters, work, planes=True):
        err, v = plane_violation(got, want, "float32") if planes else (
            float((got - want).abs().max()), 0.0)
        rows[key] = {"max_abs_err": err, "ms": time_ms(kernel_fn, iters),
                     "plain_ms": time_ms(plain_fn, iters), **bound(*work), "library_ms": None}
        print(f"  {key}: kernel {rows[key]['ms']:.4f} ms, plain {rows[key]['plain_ms']:.4f} ms, "
              f"max_abs_err {err:.3e}", flush=True)
        return v

    # the noise as a tensor on the card: a Python float is copied from
    # pageable host memory on every call, which waits for the card
    noise = torch.tensor(0.1, dtype=f32, device=dev)
    kern = lambda: pw.pairwise_matrix(k, x16, x16, noise=noise, jitter=1e-6)  # noqa: E731
    plain = lambda: pw.pairwise_matrix_folded(k, x16, x16, noise=noise, jitter=1e-6)  # noqa: E731
    n2 = K_N * K_N
    check(f"B1 {K_N}x{K_N}+diag", record("pairwise_k", kern(), plain(), kern, plain, 10,
                                         (SE_K_OPS * n2 + K_N, 4 * (2 * K_N + n2))), 1.0)

    kern = lambda: pw.pairwise_jacobian(k, x4, x4)  # noqa: E731
    plain = lambda: pw.pairwise_jacobian_reference(k, x4, x4)  # noqa: E731
    g2 = GRAD_N * GRAD_N
    check(f"B2a {GRAD_N}x{GRAD_N}", record("pairwise_jac", kern(), plain(), kern, plain, 10,
                                           (SE_JAC_OPS * g2, 4 * (2 * GRAD_N + 2 * g2))), 1.0)

    kern = lambda: pw.pairwise_hessian(k, x4, x4, pair=(0, 1))  # noqa: E731
    plain = lambda: pw.pairwise_hessian_reference(k, x4, x4, pair=(0, 1))  # noqa: E731
    check(f"B2b {GRAD_N}x{GRAD_N} pair",
          record("pairwise_hess", kern(), plain(), kern, plain, 10,
                 (SE_HESS_PLANE_OPS * g2, 4 * (2 * GRAD_N + g2))), 1.0)
    # the chunked Hessian's other two SE planes, (h, h) and (w, w)
    for p in (0, 1):
        kern = lambda: pw.pairwise_hessian(k, x4, x4, pair=(p, p))  # noqa: E731
        plain = lambda: pw.pairwise_hessian_reference(k, x4, x4, pair=(p, p))  # noqa: E731
        check(f"B2b {GRAD_N}x{GRAD_N} pair ({p}, {p})",
              record(f"pairwise_hess_{p}{p}", kern(), plain(), kern, plain, 10,
                     (SE_HESS_PLANE_OPS * g2, 4 * (2 * GRAD_N + g2))), 1.0)
    kern = lambda: pw.pairwise_hessian(k, x4, x4)  # noqa: E731
    plain = lambda: pw.pairwise_hessian_reference(k, x4, x4)  # noqa: E731
    check(f"B2b {GRAD_N}x{GRAD_N} all planes",
          record("pairwise_hess_all_planes", kern(), plain(), kern, plain, 10,
                 (4 * SE_HESS_PLANE_OPS * g2, 4 * (2 * GRAD_N + 4 * g2))), 1.0)

    K16 = pw.pairwise_matrix(k, x16, x16, noise=0.1, jitter=1e-6)
    tile = K16[:128, :128].contiguous()
    kern = lambda: bc.chol_tile(tile)  # noqa: E731
    plain = lambda: bc.cholesky_reference(tile)  # noqa: E731
    got, want = kern(), plain()
    tile_work = (128 ** 3 / 3, 4 * 2 * 128 * 128)
    record("chol_tile", got, want, kern, plain, 50, tile_work, planes=False)
    rows["chol_tile"]["library_ms"] = time_ms(lambda: torch.linalg.cholesky_ex(tile), 50)
    check("B3 config-1 tile", rel_fro(got, want), CHOL_TOL["float32"])
    check("B3 config-1 tile backward", backward(got, tile), CHOL_BACKWARD_TOL["float32"])
    # with the inverse, as cholesky_blocked launches it (the kernel line's B3
    # row), held against the two library calls it replaces
    eye = torch.eye(128, dtype=f32, device=dev)
    kern = lambda: bc.chol_tile_inv(tile)  # noqa: E731
    plain = lambda: bc.chol_tile_inv_reference(tile)  # noqa: E731
    (got, got_inv), (want, want_inv) = kern(), plain()
    record("chol_tile_inv", torch.stack((got, got_inv)), torch.stack((want, want_inv)), kern,
           plain, 50, (128 ** 3 / 3 + 128 ** 3 / 3, 4 * 3 * 128 * 128), planes=False)
    rows["chol_tile_inv"]["library_ms"] = time_ms(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(tile)[0], eye, upper=False), 50)
    check("B3 config-1 tile with inverse: factor vs plain", rel_fro(got, want), CHOL_TOL["float32"])
    check("B3 config-1 tile inverse vs plain", rel_fro(got_inv, want_inv), INV_TOL["float32"])
    # 64 tiles at once (the per-chain factors of the samplers)
    tiles = torch.stack([K16[i:i + 128, i:i + 128] for i in range(0, 64 * 128, 128)]).contiguous()
    rows["chol_tile_batch64"] = {"ms": time_ms(lambda: bc.chol_tile(tiles), 20),
                                 "library_ms": time_ms(lambda: torch.linalg.cholesky_ex(tiles), 20),
                                 **bound(64 * tile_work[0], 64 * tile_work[1])}
    for key, lib in (("chol_tile", "cholesky_ex"),
                     ("chol_tile_inv", "cholesky_ex + solve_triangular"),
                     ("chol_tile_batch64", "cholesky_ex")):
        print(f"  {key}: kernel {rows[key]['ms']:.4f} ms, {lib} {rows[key]['library_ms']:.4f} ms, "
              f"bound {rows[key]['bound_ms']:.2e} ms", flush=True)

    L = bc.cholesky_blocked(K16)
    b_blocked = backward(L, K16)
    del L
    b_linalg = backward(torch.linalg.cholesky(K16), K16)
    print(f"  backward error at {K_N}: cholesky_blocked {b_blocked:.3e}, "
          f"torch.linalg.cholesky {b_linalg:.3e}", flush=True)
    check(f"cholesky_blocked {K_N} backward / torch.linalg's", b_blocked / b_linalg,
          BLOCKED_BACKWARD_RATIO)
    rows["cholesky_blocked"] = {
        "ms": time_ms(lambda: bc.cholesky_blocked(K16), 3),
        "linalg_cholesky_ms": time_ms(lambda: torch.linalg.cholesky(K16), 3),
    }
    print(f"  cholesky_blocked {K_N}: {rows['cholesky_blocked']['ms']:.3f} ms, "
          f"torch.linalg.cholesky {rows['cholesky_blocked']['linalg_cholesky_ms']:.3f} ms",
          flush=True)
    del K16
    torch.cuda.empty_cache()
    return rows


def check_products_small(check, dev):
    """Phase 3a, matrix-free kernels: B4 (SE, periodic, ARD D=3) and B5
    against their plain versions at small shapes, float32 and float64."""
    import torch
    from gaussian_processes_tpu_torch import ARDGaussianKernel, GaussianKernel, PeriodicKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("matrix-free kernels vs plain, small shapes:", flush=True)
    gen = torch.Generator().manual_seed(1)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64) * 4 - 2

    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        kernels = {"se": GaussianKernel(1.3, 0.7, dtype=dtype, device=dev),
                   "periodic": PeriodicKernel(0.9, 1.1, 2.0, dtype=dtype, device=dev),
                   "ard": ARDGaussianKernel(1.1, torch.tensor([0.8, 1.4, 2.0]), dtype=dtype,
                                            device=dev)}
        for fam, k in kernels.items():
            for n in (1000, 777):
                x = (rand(n, 3) if fam == "ard" else rand(n)).to(dev, dtype)
                for r in (1, 9, 300):
                    v = torch.randn(n, r, generator=gen, dtype=torch.float64).to(dev, dtype)
                    got = pw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
                    want = pw.kernel_matvec_fused_reference(k, x, v, 0.1, 1e-6)
                    bound = pw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
                    _, viol = product_violation(got, want, bound, dname)
                    check(f"B4 {fam} n={n} r={r} {dname}", viol, 1.0)
                    same = torch.equal(got, pw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))
                    check(f"B4 {fam} n={n} r={r} {dname} repeat bit-identical (0 = yes)",
                          0.0 if same else 1.0, 0.0)
                if fam != "ard":
                    u = torch.randn(n, 9, generator=gen, dtype=torch.float64).to(dev, dtype)
                    bound = pw.pairwise_jacobian_reference(k, x, x).abs() @ u.abs()
                    _, viol = product_violation(pw.kernel_jacvec_fused(k, x, u),
                                                pw.kernel_jacvec_fused_reference(k, x, u),
                                                bound, dname)
                    check(f"B5 {fam} n={n} r=9 {dname}", viol, 1.0)


# B6's shapes: ragged tiles, the pivot column and row of the pivoted Cholesky
# at the matrix-free N, and a few rows against many columns
ARD_SHAPES = ((777, 1234), (65536, 1), (1, 65536), (3, 5000))


def check_ard_pairwise_small(check, dev):
    """B6 against the plain version of its arithmetic and the plain ARD K
    over D = 1, 3, 8, 16 and ARD_SHAPES, with and without the diagonal,
    float32 and float64 (one check per (dtype, D) holds the largest
    violation of its 16 comparisons); K(x, x) bitwise symmetric with its
    diagonal exactly h^2 + noise^2 + jitter, in both layouts."""
    import torch
    from gaussian_processes_tpu_torch import ARDGaussianKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("B6 vs plain over D and shapes:", flush=True)
    gen = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for D in (1, 3, 8, 16):
            k = ARDGaussianKernel(1.1, torch.linspace(0.6, 2.4, D, dtype=torch.float64),
                                  dtype=dtype, device=dev)
            worst = 0.0
            for n, m in ARD_SHAPES:
                x1 = (torch.rand(n, D, generator=gen, dtype=torch.float64) * 4 - 2).to(dev, dtype)
                x2 = (torch.rand(m, D, generator=gen, dtype=torch.float64) * 4 - 2).to(dev, dtype)
                for diag in ({}, dict(noise=0.1, jitter=1e-6)):
                    got = pw.pairwise_matrix_ard(k, x1, x2, **diag)
                    d = pw._diag_term(0.1, 1e-6, x1) if diag else None
                    own = pw.pairwise_ard_prescaled_reference(
                        k.h, pw.ard_prescale(k, x1), pw.ard_prescale(k, x2), diag=d)
                    for want in (own, pw.pairwise_matrix_ard_reference(k, x1, x2, **diag)):
                        worst = max(worst, plane_violation(got, want, dname)[1])
            check(f"B6 D={D} {dname}, 4 shapes with and without the diagonal", worst, 1.0)
            exact = True
            h2 = k.h.to(dtype) * k.h.to(dtype)
            for n in (100, 777):  # the flat layout, then the tile
                x = (torch.rand(n, D, generator=gen, dtype=torch.float64) * 4 - 2).to(dev, dtype)
                for diag in ({}, dict(noise=0.2, jitter=1e-6)):
                    K = pw.pairwise_matrix_ard(k, x, x, **diag)
                    want = h2 + pw._diag_term(0.2, 1e-6, x) if diag else h2
                    exact &= torch.equal(K, K.T) and torch.equal(K.diagonal(), want.expand(n))
            check(f"B6 D={D} {dname} K(x, x) symmetric, diagonal exact (0 = yes)",
                  0.0 if exact else 1.0, 0.0)


def check_ard_products_small(check, dev):
    """B4-ARD against its plain version over D = 1, 2, 3, 8, 16, n = 129,
    777, 1000 and r = 1, 8, 9, 64, 300, float32 and float64, each product
    repeated and required bit-identical; one check per (dtype, D) holds the
    largest violation of its 15 shapes."""
    import torch
    from gaussian_processes_tpu_torch import ARDGaussianKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("B4-ARD vs plain over D, n and r:", flush=True)
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for D in (1, 2, 3, 8, 16):
            k = ARDGaussianKernel(1.1, torch.linspace(0.6, 2.4, D, dtype=torch.float64),
                                  dtype=dtype, device=dev)
            worst, same = 0.0, True
            for n in (129, 777, 1000):
                x = (torch.rand(n, D, generator=gen, dtype=torch.float64) * 4 - 2).to(dev, dtype)
                for r in (1, 8, 9, 64, 300):
                    v = torch.randn(n, r, generator=gen, dtype=torch.float64).to(dev, dtype)
                    got = pw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
                    want = pw.kernel_matvec_fused_reference(k, x, v, 0.1, 1e-6)
                    bound_v = pw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
                    worst = max(worst, product_violation(got, want, bound_v, dname)[1])
                    same &= torch.equal(got, pw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))
            check(f"B4-ARD D={D} {dname}, 15 shapes", worst, 1.0)
            check(f"B4-ARD D={D} {dname} repeats bit-identical (0 = yes)", 0.0 if same else 1.0, 0.0)


def check_jac_products_small(check, dev):
    """B5 against its plain version over SE and periodic, n = 129, 777, 1000
    and r = 1, 8, 9, 64, 300, float32 and float64, each product repeated and
    required bit-identical; one check per (dtype, family) holds the largest
    violation of its 15 shapes."""
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel, PeriodicKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("B5 vs plain over n and r:", flush=True)
    gen = torch.Generator().manual_seed(4)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        kernels = {"se": GaussianKernel(1.3, 0.7, dtype=dtype, device=dev),
                   "periodic": PeriodicKernel(0.9, 1.1, 2.0, dtype=dtype, device=dev)}
        for fam, k in kernels.items():
            worst, same = 0.0, True
            for n in (129, 777, 1000):
                x = (torch.rand(n, generator=gen, dtype=torch.float64) * 4 - 2).to(dev, dtype)
                J_abs = pw.pairwise_jacobian_reference(k, x, x).abs()
                for r in (1, 8, 9, 64, 300):
                    u = torch.randn(n, r, generator=gen, dtype=torch.float64).to(dev, dtype)
                    got = pw.kernel_jacvec_fused(k, x, u)
                    want = pw.kernel_jacvec_fused_reference(k, x, u)
                    worst = max(worst, product_violation(got, want, J_abs @ u.abs(), dname)[1])
                    same &= torch.equal(got, pw.kernel_jacvec_fused(k, x, u))
            check(f"B5 {fam} {dname}, 15 shapes", worst, 1.0)
            check(f"B5 {fam} {dname} repeats bit-identical (0 = yes)", 0.0 if same else 1.0, 0.0)


def check_new_products_small(check, dev):
    """B4 and B5 for Matérn 3/2, Matérn 5/2 and RQ, and B4's tree body for
    TREES (depth 1 and 2, a sum of products among them), against the plain
    products and the plain versions of their own arithmetic, n = 129, 777
    and r = 1, 4, 8, 9, 16, 300, float32 and float64, each product repeated
    and required bit-identical; one check per (dtype, kernel, product)
    holds the largest violation of its 12 shapes."""
    import torch
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("B4, B5 for the new families and B4's tree body vs plain over n and r:", flush=True)
    gen = torch.Generator().manual_seed(7)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        kernels = {**{fam: new_kernel(fam, NEW_FAMILY_SMALL[fam], dtype, dev)
                      for fam in NEW_FAMILY_SMALL},
                   **{f"tree {name}": tree_kernel(name, dtype, dev) for name in TREES}}
        for fam, k in kernels.items():
            worst, worst_j, same = 0.0, 0.0, True
            for n in (129, 777):
                x = (torch.rand(n, generator=gen, dtype=torch.float64) * 4 - 2).to(dev, dtype)
                J_abs = None if pw.is_tree(k) else pw.pairwise_jacobian_reference(k, x, x).abs()
                for r in (1, 4, 8, 9, 16, 300):
                    v = torch.randn(n, r, generator=gen, dtype=torch.float64).to(dev, dtype)
                    got = pw.kernel_matvec_fused(k, x, v, 0.1, 1e-6)
                    bound_v = pw.kernel_matvec_fused_reference(k, x, v.abs(), 0.1, 1e-6)
                    for want in (pw.kernel_matvec_fused_reference(k, x, v, 0.1, 1e-6),
                                 pw.matvec_folded_reference(k, x, v) + pw._diag_term(0.1, 1e-6, x) * v):
                        worst = max(worst, product_violation(got, want, bound_v, dname)[1])
                    same &= torch.equal(got, pw.kernel_matvec_fused(k, x, v, 0.1, 1e-6))
                    if J_abs is None:
                        continue
                    got = pw.kernel_jacvec_fused(k, x, v)
                    for want in (pw.kernel_jacvec_fused_reference(k, x, v),
                                 pw.jacvec_folded_reference(k, x, v)):
                        worst_j = max(worst_j, product_violation(got, want, J_abs @ v.abs(),
                                                                 dname)[1])
                    same &= torch.equal(got, pw.kernel_jacvec_fused(k, x, v))
            check(f"B4 {fam} {dname}, 12 shapes", worst, 1.0)
            if not pw.is_tree(k):
                check(f"B5 {fam} {dname}, 12 shapes", worst_j, 1.0)
            check(f"B4/B5 {fam} {dname} repeats bit-identical (0 = yes)", 0.0 if same else 1.0,
                  0.0)
        # k(0) = h^2 on the diagonal, and a Matérn dK/dw is 0 there
        exact = True
        x = (torch.rand(500, generator=gen, dtype=torch.float64) * 4 - 2).to(dev, dtype)
        for fam in NEW_FAMILY_SMALL:
            k = kernels[fam]
            h2 = k.h.to(dtype) * k.h.to(dtype)
            exact &= torch.equal(pw.pairwise_matrix(k, x, x).diagonal(), h2.expand(500))
            if fam != "rq":
                exact &= bool((pw.pairwise_jacobian(k, x, x)[1].diagonal() == 0).all())
        check(f"new families {dname}: K(x, x) diagonal h^2, Matérn dK/dw diagonal 0 (0 = yes)",
              0.0 if exact else 1.0, 0.0)


RQ_A = (0.7, 1.5, 940.0)


def check_rq_log(check, dev):
    """RQ's folded log (the series below B = 17/16, lg2.approx above) at
    a = 0.7, 1.5 and 940 (config #2's RQ run drives a to ~940): B1 and B4
    against their folded plain versions in float32 and float64, over
    [-3, 3] and over [-300, 300] (where B passes 17/16), and at a = 940
    against the float64 plain K and K V."""
    import torch
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("RQ's folded log vs plain, a = 0.7, 1.5, 940:", flush=True)
    gen = torch.Generator().manual_seed(9)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for a in RQ_A:
            k = new_kernel("rq", (0.9, 1.1, a), dtype, dev)
            k64 = new_kernel("rq", (0.9, 1.1, a), torch.float64, dev)
            worst, worst64 = 0.0, 0.0
            for span in (3.0, 300.0):
                x1 = ((torch.rand(777, generator=gen, dtype=torch.float64) * 2 - 1) * span).to(dev, dtype)
                x2 = ((torch.rand(1234, generator=gen, dtype=torch.float64) * 2 - 1) * span).to(dev, dtype)
                got = pw.pairwise_matrix(k, x1, x2)
                worst = max(worst, plane_violation(got, pw.pairwise_matrix_folded(k, x1, x2), dname)[1])
                want64 = pw.pairwise_matrix_reference(k64, x1.double(), x2.double())
                worst64 = max(worst64, plane_violation(got.double(), want64, dname)[1])
                v = torch.randn(777, 9, generator=gen, dtype=torch.float64).to(dev, dtype)
                got = pw.kernel_matvec_fused(k, x1, v, 0.1, 1e-6)
                bound_v = pw.kernel_matvec_fused_reference(k64, x1.double(), v.abs().double(), 0.1, 1e-6)
                want = pw.matvec_folded_reference(k, x1, v) + pw._diag_term(0.1, 1e-6, x1) * v
                worst = max(worst, product_violation(got.double(), want.double(), bound_v, dname)[1])
                want64 = pw.kernel_matvec_fused_reference(k64, x1.double(), v.double(), 0.1, 1e-6)
                worst64 = max(worst64, product_violation(got.double(), want64, bound_v, dname)[1])
            check(f"RQ a={a} {dname}: B1 and B4 vs their folded plain versions", worst, 1.0)
            if a == RQ_A[-1]:
                check(f"RQ a={a} {dname}: B1 and B4 vs the float64 plain K and K V", worst64, 1.0)


def check_new_kernels_at_slice(check, dev, rows):
    """The new families' and the trees' cases at their paths' shapes
    (float32), timed against their plain versions: B1 at 16384^2 with the
    diagonal, B2a and one B2b plane at 4096^2 (the exact paths), B1 pivot
    rows and B4 / B5 at N = 65536 (the matrix-free paths: Matérn 5/2 at
    r = 1, 8, 9, the others at r = 9, the quasi-periodic tree at r = 1, 8)."""
    import dataclasses as dc

    import torch
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    print("new families and trees vs plain at the paths' shapes (float32):", flush=True)
    f32 = torch.float32
    data = CONFIGS["config1_fit_se500"].data
    x16 = torch.as_tensor(make_data(dc.replace(data, n=K_N), "float32")[0], device=dev)
    x4 = torch.as_tensor(make_data(dc.replace(data, n=GRAD_N), "float32")[0], device=dev)
    noise = torch.tensor(0.1, dtype=f32, device=dev)
    n2, g2 = K_N * K_N, GRAD_N * GRAD_N

    def record(key, label, kern, plain, iters, plain_iters, work, sfu=None, err_of=None):
        got, want = kern(), plain()
        err, viol = err_of(got, want) if err_of else plane_violation(got, want, "float32")
        del got, want
        rows[key] = {"max_abs_err": err, "ms": time_ms(kern, iters),
                     "plain_ms": time_ms(plain, plain_iters), "library_ms": None, **bound(*work)}
        if sfu is not None:
            rows[key]["sfu_floor_ms"] = sfu_floor_ms(sfu)
        print(f"  {label}: kernel {rows[key]['ms']:.5f} ms, plain {rows[key]['plain_ms']:.5f} ms, "
              f"bound {rows[key]['bound_ms']:.3e} ms ({rows[key]['bound_by']}), "
              f"max_abs_err {err:.3e}", flush=True)
        check(label, viol, 1.0)
        torch.cuda.empty_cache()

    for fam, (k_ops, j_ops, pair, h_ops, _, _) in NEW_FAMILY_OPS.items():
        k = new_kernel(fam, NEW_FAMILY_PARAMS[fam], f32, dev)
        P = k.n_params
        record(f"pairwise_k_{fam}", f"B1 {fam} {K_N}x{K_N}+diag",
               lambda: pw.pairwise_matrix(k, x16, x16, noise=noise, jitter=1e-6),
               lambda: pw.pairwise_matrix_folded(k, x16, x16, noise=noise, jitter=1e-6), 10, 3,
               (k_ops * n2 + K_N, 4 * (2 * K_N + n2)))
        record(f"pairwise_jac_{fam}", f"B2a {fam} {GRAD_N}x{GRAD_N}",
               lambda: pw.pairwise_jacobian(k, x4, x4),
               lambda: pw.pairwise_jacobian_reference(k, x4, x4), 10, 3,
               (j_ops * g2, 4 * (2 * GRAD_N + P * g2)))
        record(f"pairwise_hess_{fam}", f"B2b {fam} {GRAD_N}x{GRAD_N} pair {pair}",
               lambda: pw.pairwise_hessian(k, x4, x4, pair=pair),
               lambda: pw.pairwise_hessian_reference(k, x4, x4, pair=pair), 10, 3,
               (h_ops * g2, 4 * (2 * GRAD_N + g2)))
    kt = tree_kernel("qp", f32, dev)
    record("pairwise_k_tree_16384", f"B1 tree qp {K_N}x{K_N}+diag",
           lambda: pw.pairwise_matrix(kt, x16, x16, noise=noise, jitter=1e-6),
           lambda: pw.pairwise_matrix_folded(kt, x16, x16, noise=noise, jitter=1e-6), 10, 3,
           (TREE_K_OPS * n2 + K_N, 4 * (2 * K_N + n2)))

    gen = torch.Generator().manual_seed(8)
    x, _, k_se = sine_problem(ITER_N, dev)
    w_iter = float(k_se.w)
    N2 = ITER_N * ITER_N
    piv = x[ITER_N // 3:ITER_N // 3 + 1].contiguous()

    def product_err(bound_fn):
        def err_of(got, want):
            return product_violation(got, want, bound_fn(), "float32")
        return err_of

    kernels = {fam: new_kernel(fam, (1.0, w_iter, *NEW_FAMILY_PARAMS[fam][2:]), f32, dev)
               for fam in NEW_FAMILY_OPS}
    for fam, (k_ops, j_ops, _, _, sfu_k, sfu_j) in NEW_FAMILY_OPS.items():
        k = kernels[fam]
        P = k.n_params
        row = pw.pivot_rows(k, x)
        record(f"pairwise_k_{fam}_pivot_row", f"B1 {fam} pivot row 1x{ITER_N}",
               lambda: row(piv)[None], lambda: pw.pairwise_matrix_folded(k, piv, x),
               200, 50, (k_ops * ITER_N, 4 * (1 + 2 * ITER_N)))
        rows[f"pairwise_k_{fam}_pivot_row"]["call_us"] = call_us(lambda: row(piv))
        for r in ((1, 8, 9) if fam == "matern52" else (9,)):
            v = torch.randn(ITER_N, r, generator=gen).to(dev)
            key = f"kernel_matvec_{fam}" + ("" if r == (1 if fam == "matern52" else 9) else f"_r{r}")
            record(key, f"B4 {fam} N={ITER_N} r={r}",
                   lambda: pw.kernel_matvec_fused(k, x, v, noise, ITER_JITTER),
                   lambda: pw.matvec_folded_reference(k, x, v) + pw._diag_term(noise, ITER_JITTER, x) * v,
                   5, 2,
                   ((k_ops + 2 * r) * N2, 4 * (ITER_N + 2 * ITER_N * r)), sfu_k * N2,
                   product_err(lambda: pw.kernel_matvec_fused_reference(k, x, v.abs(), noise,
                                                                        ITER_JITTER)))

        def jac_bound(u, k=k, block=2048):
            out = torch.zeros(k.n_params, ITER_N, u.shape[1], device=dev)
            for j in range(0, ITER_N, block):
                out += pw.pairwise_jacobian_reference(k, x, x[j:j + block]).abs() @ u[j:j + block].abs()
            return out

        u = torch.randn(ITER_N, 9, generator=gen).to(dev)
        record(f"kernel_jacvec_{fam}", f"B5 {fam} N={ITER_N} r=9",
               lambda: pw.kernel_jacvec_fused(k, x, u), lambda: pw.kernel_jacvec_fused_reference(k, x, u),
               5, 2, ((j_ops + 2 * P * 9) * N2, 4 * (ITER_N + 9 * ITER_N + P * 9 * ITER_N)),
               sfu_j * N2, product_err(lambda: jac_bound(u)))
    kt = tree_kernel("qp", f32, dev, se=(1.0, w_iter))
    row = pw.pivot_rows(kt, x)
    record("pairwise_k_tree_pivot_row", f"B1 tree qp pivot row 1x{ITER_N}",
           lambda: row(piv)[None], lambda: pw.pairwise_matrix_folded(kt, piv, x),
           200, 50, (TREE_K_OPS * ITER_N, 4 * (1 + 2 * ITER_N)))
    rows["pairwise_k_tree_pivot_row"]["call_us"] = call_us(lambda: row(piv))
    same = torch.equal(row(piv), pw.pairwise_matrix(kt, x, piv)[:, 0])
    check("B1 tree pivot row bit-identical to the column (0 = yes)", 0.0 if same else 1.0, 0.0)
    for r in (1, 8):
        v = torch.randn(ITER_N, r, generator=gen).to(dev)
        record("kernel_matvec_tree" + ("" if r == 1 else f"_r{r}"), f"B4 tree qp N={ITER_N} r={r}",
               lambda: pw.kernel_matvec_fused(kt, x, v, noise, ITER_JITTER),
               lambda: pw.matvec_folded_reference(kt, x, v) + pw._diag_term(noise, ITER_JITTER, x) * v,
               5, 2, ((TREE_K_OPS + 2 * r) * N2, 4 * (ITER_N + 2 * ITER_N * r)), TREE_SFU * N2,
               product_err(lambda: pw.kernel_matvec_fused_reference(kt, x, v.abs(), noise,
                                                                    ITER_JITTER)))


def check_products_at_slice(check, dev, rows):
    """Phase 3b, matrix-free kernels at the main path's shapes (float32),
    timed against their plain versions and against the strip matvec (B1
    strips + cuBLAS) that ``kernel_matvec(impl="strip")`` runs."""
    import torch
    from gaussian_processes_tpu_torch import PeriodicKernel
    from gaussian_processes_tpu_torch.ops import krylov
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("matrix-free kernels vs plain at the main path's shapes (float32):", flush=True)
    gen = torch.Generator().manual_seed(2)
    n2 = ITER_N * ITER_N
    x, _, k = sine_problem(ITER_N, dev)
    noise = torch.tensor(ITER_NOISE, dtype=torch.float32, device=dev)

    def record(key, label, kern, plain, bound_fn, iters, plain_iters, work, sfu):
        got, want = kern(), plain()
        err, viol = product_violation(got, want, bound_fn(), "float32")
        del got, want
        rows[key] = {"max_abs_err": err, "ms": time_ms(kern, iters),
                     "plain_ms": time_ms(plain, plain_iters), **bound(*work),
                     "sfu_floor_ms": sfu_floor_ms(sfu), "library_ms": None}
        print(f"  {label}: kernel {rows[key]['ms']:.4f} ms, plain {rows[key]['plain_ms']:.4f} ms, "
              f"bound {rows[key]['bound_ms']:.4f} ms, special-function floor "
              f"{rows[key]['sfu_floor_ms']:.4f} ms, max_abs_err {err:.3e}", flush=True)
        check(label, viol, 1.0)
        torch.cuda.empty_cache()

    def pivot_row(key, label, kern, plain, work):
        err, viol = plane_violation(kern(), plain(), "float32")
        rows[key] = {"max_abs_err": err, "ms": time_ms(kern, 200), "plain_ms": time_ms(plain, 50),
                     "library_ms": None, **bound(*work)}
        print(f"  {label}: kernel {rows[key]['ms']:.5f} ms, plain {rows[key]['plain_ms']:.5f} ms, "
              f"bound {rows[key]['bound_ms']:.2e} ms, max_abs_err {err:.3e}", flush=True)
        check(label, viol, 1.0)

    def matvec_rows(kernel, xk, label, k_ops, sfu_per_elem, keys, dim=1, iters=(5, 2)):
        for r, key in keys:
            v = torch.randn(ITER_N, r, generator=gen).to(dev)
            record(key, f"{label} N={ITER_N} r={r}",
                   lambda: pw.kernel_matvec_fused(kernel, xk, v, noise, ITER_JITTER),
                   lambda: pw.kernel_matvec_fused_reference(kernel, xk, v, noise, ITER_JITTER),
                   lambda: pw.kernel_matvec_fused_reference(kernel, xk, v.abs(), noise,
                                                            ITER_JITTER),
                   *iters, ((k_ops + 2 * r) * n2, 4 * (ITER_N * dim + 2 * ITER_N * r)),
                   sfu_per_elem * n2)

    def jacvec_row(kernel, key, label, jac_ops, sfu_per_elem, bound_fn):
        P, r = kernel.n_params, 9
        u = torch.randn(ITER_N, r, generator=gen).to(dev)
        record(key, f"{label} N={ITER_N} r={r}",
               lambda: pw.kernel_jacvec_fused(kernel, x, u),
               lambda: pw.kernel_jacvec_fused_reference(kernel, x, u),
               lambda: bound_fn(u), 5, 2,
               ((jac_ops + 2 * P * r) * n2, 4 * (ITER_N + r * ITER_N + P * r * ITER_N)),
               sfu_per_elem * n2)

    # r = 1 (the CG solve for alpha) is the row of the kernel JSON line; r = 8
    # (the SLQ probes), r = 9 (the stochastic gradient's [y, probes]) and
    # r = 64 (predict_diag_iterative) beside it
    matvec_rows(k, x, "B4 SE", SE_K_OPS, 1,
                ((1, "kernel_matvec"), (8, "kernel_matvec_r8"), (9, "kernel_matvec_r9"),
                 (64, "kernel_matvec_r64")), iters=(10, 3))
    for r in (1, 8):
        v = torch.randn(ITER_N, r, generator=gen).to(dev)
        strip = lambda: krylov.kernel_matvec(k, x, v, noise, ITER_JITTER, block_size=2048,  # noqa: E731
                                             impl="strip")
        rows[f"strip_matvec_r{r}"] = {"ms": time_ms(strip, 3)}
        print(f"  kernel_matvec(impl='strip') N={ITER_N} r={r}: "
              f"{rows[f'strip_matvec_r{r}']['ms']:.4f} ms", flush=True)
    # B1 at the pivoted Cholesky's shapes: the column K(x, x[piv]) it built
    # before, the row K(x[piv], x) it builds now, through pivot_rows (the
    # parameters read once), bit for bit the column
    piv_se = x[ITER_N // 3:ITER_N // 3 + 1].contiguous()
    pivot_row("pairwise_k_pivot_column", f"B1 pivot column {ITER_N}x1",
              lambda: pw.pairwise_matrix(k, x, piv_se),
              lambda: pw.pairwise_matrix_folded(k, x, piv_se), (SE_K_OPS * ITER_N, 4 * (1 + 2 * ITER_N)))
    row = pw.pivot_rows(k, x)
    pivot_row("pairwise_k_pivot_row", f"B1 pivot row 1x{ITER_N} (pivot_rows)",
              lambda: row(piv_se)[None], lambda: pw.pairwise_matrix_folded(k, piv_se, x),
              (SE_K_OPS * ITER_N, 4 * (1 + 2 * ITER_N)))
    rows["pairwise_k_pivot_row"]["call_us"] = call_us(lambda: row(piv_se))
    same = torch.equal(row(piv_se), pw.pairwise_matrix(k, x, piv_se)[:, 0])
    check("B1 pivot row bit-identical to the column (0 = yes)", 0.0 if same else 1.0, 0.0)
    # SE's dK/dh and dK/dw are >= 0, so the plain product with |U| is the bound
    jacvec_row(k, "kernel_jacvec", "B5 SE", SE_JAC_OPS, 1,
               lambda u: pw.kernel_jacvec_fused_reference(k, x, u.abs()))
    # periodic, two periods over the data: not on the fits' path, timed beside
    kp = PeriodicKernel(1.0, 1.0, 0.5, dtype=torch.float32, device=dev)
    matvec_rows(kp, x, "B4 periodic", PERIODIC_K_OPS, PERIODIC_K_SFU,
                ((1, "kernel_matvec_periodic"), (8, "kernel_matvec_periodic_r8")))

    def periodic_jac_bound(u, block=2048):  # |dK/dp| needs the planes' absolute values
        out = torch.zeros(3, ITER_N, u.shape[1], device=dev)
        for j in range(0, ITER_N, block):
            out += pw.pairwise_jacobian_reference(kp, x, x[j:j + block]).abs() @ u[j:j + block].abs()
        return out

    jacvec_row(kp, "kernel_jacvec_periodic", "B5 periodic", PERIODIC_JAC_OPS, 3,
               periodic_jac_bound)
    xa, _, ka = ard_problem(ITER_N, dev)
    # r = 8 (the SLQ probes) is the row of the kernel JSON line; r = 1 (the
    # CG solve for alpha) and r = 64 (predict_diag_iterative) beside it
    matvec_rows(ka, xa, f"B4-ARD D={ARD_DIM}", ard_ops(ARD_DIM), 1,
                ((8, "kernel_matvec_ard"), (1, "kernel_matvec_ard_r1"),
                 (64, "kernel_matvec_ard_r64")), dim=ARD_DIM)
    xa16 = xa[:K_N].contiguous()
    kern = lambda: pw.pairwise_matrix_ard(ka, xa16, xa16, noise=noise, jitter=ITER_JITTER)  # noqa: E731
    plain = lambda: pw.pairwise_matrix_ard_reference(ka, xa16, xa16, noise=noise,  # noqa: E731
                                                     jitter=ITER_JITTER)
    err, viol = plane_violation(kern(), plain(), "float32")
    rows["pairwise_ard"] = {"max_abs_err": err, "ms": time_ms(kern, 10),
                            "plain_ms": time_ms(plain, 3), "library_ms": None,
                            **bound(ard_ops(ARD_DIM) * K_N * K_N,
                                    4 * (2 * K_N * ARD_DIM + K_N * K_N))}
    print(f"  B6 {K_N}^2 D={ARD_DIM}+diag: kernel {rows['pairwise_ard']['ms']:.4f} ms, plain "
          f"{rows['pairwise_ard']['plain_ms']:.4f} ms, max_abs_err {err:.3e}", flush=True)
    check(f"B6 {K_N}x{K_N} D={ARD_DIM}+diag", viol, 1.0)
    # the pivoted Cholesky's shapes: the column K(x, x[piv]) it built
    # before, the row K(x[piv], x) it builds now, once per rank step
    piv = xa[ITER_N // 3:ITER_N // 3 + 1].contiguous()
    for key, a, b in (("pairwise_ard_pivot_column", xa, piv), ("pairwise_ard_pivot_row", piv, xa)):
        pivot_row(key, f"B6 pivot {key.split('_')[-1]} {a.shape[0]}x{b.shape[0]} D={ARD_DIM}",
                  lambda: pw.pairwise_matrix_ard(ka, a, b),
                  lambda: pw.pairwise_matrix_ard_reference(ka, a, b),
                  (ard_ops(ARD_DIM) * ITER_N, 4 * (ITER_N * ARD_DIM + ARD_DIM + ITER_N)))
    torch.cuda.empty_cache()


def chain_problem(dev, dtype, family, chains=CHAINS, n=CHAIN_N):
    """Config #3's x at ``n`` points, the kernel template, and a (chains,
    P + 1) table of (kernel params..., s) drawn log-normally (sd 0.3, seed
    6) around CHAIN_CENTER."""
    import numpy as np
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel, PeriodicKernel
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    dname = str(dtype).split(".")[-1]
    data = dataclasses.replace(CONFIGS["config3_chees_64"].data, n=n)
    x = torch.as_tensor(make_data(data, dname)[0], device=dev)
    center = np.log(CHAIN_CENTER[family])
    u = center + 0.3 * np.random.default_rng(6).standard_normal((chains, center.size))
    ones = [1.0] * (center.size - 1)
    if family == "tree":
        template = tree_kernel("qp", dtype, dev)
    elif family in NEW_FAMILY_PARAMS:
        template = new_kernel(family, ones, dtype, dev)
    else:
        cls = GaussianKernel if family == "se" else PeriodicKernel
        template = cls(*ones, dtype=dtype, device=dev)
    return x, template, torch.as_tensor(np.exp(u), dtype=dtype, device=dev)


def contract_operands(K, x):
    """alpha = K^-1 sin(2x) and a row-major K^-1 for a (C, n, n) stack K,
    from a float64 factor, in K's dtype: the operands that the chains'
    value+grad hands B2a contracted."""
    import torch

    L = torch.linalg.cholesky(K.double())
    y = torch.sin(2 * x.double())[None, :, None].expand(K.shape[0], -1, 1)
    alpha = torch.cholesky_solve(y, L)[..., 0].to(K.dtype)
    inv_K = torch.cholesky_inverse(L).to(K.dtype).contiguous()
    return alpha, inv_K


def check_contract(check, rows, key, label, template, x, params, alpha, inv_K, j_ops, timed):
    """B2a contracted over a chain table against its float64 twin, within
    CONTRACT_TOL of the sum's size before cancellation; timed beside its
    plain twin in the same dtype and the path it replaced (B2a's Jacobians
    and the two einsums over them).  The bound reads K^-1's upper triangle
    once and evaluates P Jacobian values and P multiply-adds an element of
    it."""
    import torch
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    dname = str(x.dtype).split(".")[-1]
    kern = lambda: pw.jacobian_contract_chains(template, x, params, alpha, inv_K)  # noqa: E731
    got = kern().double()
    x64, p64, a64, w64 = (t.double() for t in (x, params, alpha, inv_K))
    want = pw.jacobian_contract_chains_reference(template, x64, p64, a64, w64)
    J = pw.pairwise_jacobian_chains_reference(template, x64, p64).abs_()
    scale = 0.5 * torch.einsum("cpij,cij->cp", J, (a64[:, :, None] * a64[:, None, :]).abs()
                               + w64.abs())
    del J
    err = float((got - want).abs().max())
    check(f"B2a contracted {label}: |kernel - twin| / the sum before cancellation",
          float(((got - want).abs() / scale).max()), CONTRACT_TOL[dname])
    del want, scale, x64, p64, a64, w64
    if not timed:
        return

    def replaced():
        J = pw.pairwise_jacobian_chains(template, x, params)
        quad = torch.einsum("ci,cpij,cj->cp", alpha, J, alpha)
        return 0.5 * (quad - torch.einsum("cij,cpji->cp", inv_K, J))

    C, P = params.shape
    n = x.shape[0]
    tri = n * (n + 1) // 2
    rows[key] = {
        "max_abs_err": err, "ms": time_ms(kern, 20),
        "plain_ms": time_ms(
            lambda: pw.jacobian_contract_chains_reference(template, x, params, alpha, inv_K), 5),
        "library_ms": None, "replaced_ms": time_ms(replaced, 5),
        **bound(C * (j_ops + 2 * P + 3) * tri,
                x.element_size() * (n + C * (P + n + tri + P)))}
    torch.cuda.empty_cache()


def check_chain_kernels(check, dev, rows):
    """Phase 3c: B1 and B2a over a (C, P) parameter table and the batched
    blocked factor over B3 stacks, at the samplers' shapes (C = 64, N =
    500), SE, periodic, Matérn 3/2 and 5/2, RQ and the quasi-periodic tree
    (its dK/dtheta from its leaves' launches), float32 and float64, against
    their plain versions; in float32 also timed, with the batched value and
    gradient that a leapfrog of config #3 evaluates."""
    import torch
    from gaussian_processes_tpu_torch.models import gp
    from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print(f"chain tables and the batched factor vs plain, C={CHAINS}, N={CHAIN_N}:", flush=True)
    C, n = CHAINS, CHAIN_N
    n2 = n * n
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for fam, k_ops, j_ops in (("se", SE_K_OPS, SE_JAC_OPS),
                                  ("periodic", PERIODIC_K_OPS, PERIODIC_JAC_OPS),
                                  *((f, o[0], o[1]) for f, o in NEW_FAMILY_OPS.items()),
                                  ("tree", TREE_K_OPS, None)):
            x, template, theta = chain_problem(dev, dtype, fam)
            P = template.n_params
            params, diag = theta[:, :P], theta[:, P] ** 2 + 1e-6
            tag = f"{fam} {C}x{n}^2 {dname}"
            kern = lambda: pw.pairwise_matrix_chains(template, x, params, diag)  # noqa: E731
            plain = lambda: pw.pairwise_matrix_chains_folded(template, x, params, diag)  # noqa: E731
            K, Kr = kern(), plain()
            err, v = plane_violation(K, Kr, dname)
            check(f"B1 chain table {tag}", v, 1.0)
            timed = dtype == torch.float32 and fam != "matern32"  # not on a chain path
            key = "pairwise_k_chains" + ("" if fam == "se" else f"_{fam}")
            if timed:
                rows[key] = {"max_abs_err": err, "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 20),
                             "library_ms": None,
                             **bound(C * (k_ops * n2 + n), 4 * (n + C * (P + 1) + C * n2))}
            kern = lambda: pw.pairwise_jacobian_chains(template, x, params)  # noqa: E731
            plain = lambda: pw.pairwise_jacobian_chains_reference(template, x, params)  # noqa: E731
            err, v = plane_violation(kern(), plain(), dname)
            check(f"B2a chain table {tag}" + (" (from its leaves' launches)" if j_ops is None
                                               else ""), v, 1.0)
            if j_ops is None:  # a tree: B2a over its leaves, timed as a whole
                if timed:
                    rows["tree_jacobian_chains"] = {"max_abs_err": err, "ms": time_ms(kern, 20),
                                                    "plain_ms": time_ms(plain, 20)}
                continue
            key = "pairwise_jac_chains" + ("" if fam == "se" else f"_{fam}")
            if timed:
                rows[key] = {"max_abs_err": err, "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 20),
                             "library_ms": None,
                             **bound(C * j_ops * n2, 4 * (n + C * P + C * P * n2))}
            # B2a contracted: this K's value+grad takes its gradient terms there
            alpha, inv_K = contract_operands(K, x)
            check_contract(check, rows, "pairwise_jac_contract_chains" + (
                "" if fam == "se" else f"_{fam}"), tag, template, x, params, alpha, inv_K,
                j_ops, timed)
            del alpha, inv_K
            if fam != "se":
                continue
            # the factor of the SE chains' K, a stack of 64 with a ragged last panel
            # (the forward distance from the plain factor is kappa(K) u, printed)
            L, Lr = bc.cholesky_blocked(K), bc.cholesky_reference(K)
            print(f"  cholesky_blocked stack {tag}: distance from plain {rel_fro(L, Lr):.3e}",
                  flush=True)
            ratio = backward(L, K) / backward(Lr, K)
            check(f"cholesky_blocked stack {tag} backward / torch.linalg's", ratio,
                  BLOCKED_BACKWARD_RATIO)
            bad = K.clone()
            bad[CHAIN_NONPD, 300, 300] = -1.0
            nan = torch.isnan(bc.cholesky_blocked(bad)).flatten(1).any(1)
            only = bool(nan[CHAIN_NONPD]) and int(nan.sum()) == 1
            check(f"cholesky_blocked stack {tag}: NaN in the non-PD chain only (0 = yes)",
                  0.0 if only else 1.0, 0.0)
            # B3 as the factor's first panel launches it: the chains' first
            # diagonal tiles, one (64, 128, 128) stack, factor and inverse
            # (these tiles' condition numbers pass config-1's ~1e4, so the
            # forward distances from plain, ~kappa u, are printed; the
            # backward error is held, and the inverse's residual, ~kappa u
            # as well, against the plain inverse's on the same tiles)
            tiles = K[:, :128, :128].contiguous()
            eye = torch.eye(128, dtype=dtype, device=dev)
            (got, got_inv), (want, want_inv) = bc.chol_tile_inv(tiles), bc.chol_tile_inv_reference(tiles)
            print(f"  B3 chain stack {tag}: distance from plain, factor {rel_fro(got, want):.3e}, "
                  f"inverse {rel_fro(got_inv, want_inv):.3e}", flush=True)
            check(f"B3 chain stack {tag}: backward", backward(got, tiles), CHOL_BACKWARD_TOL[dname])
            eyes = eye.double().expand(C, 128, 128)
            ratio = (rel_fro(got_inv.double() @ got.double(), eyes)
                     / rel_fro(want_inv.double() @ want.double(), eyes))
            check(f"B3 chain stack {tag}: ||L^-1 L - I|| / the plain inverse's", ratio,
                  BLOCKED_BACKWARD_RATIO)
            if not timed:
                continue
            rows["chol_tile_inv_chains"] = {
                "max_abs_err": float(torch.stack((got - want, got_inv - want_inv)).abs().max()),
                "ms": time_ms(lambda: bc.chol_tile_inv(tiles), 50),
                "plain_ms": time_ms(lambda: bc.chol_tile_inv_reference(tiles), 50),
                "library_ms": time_ms(lambda: torch.linalg.solve_triangular(
                    torch.linalg.cholesky_ex(tiles)[0], eye, upper=False), 50),
                **bound(C * 2 * 128 ** 3 / 3, 4 * 3 * C * 128 * 128)}
            rows["cholesky_blocked_chains"] = {
                "ms": time_ms(lambda: bc.cholesky_blocked(K), 20),
                "library_ms": time_ms(lambda: torch.linalg.cholesky_ex(K), 20),
                **bound(C * n ** 3 / 3, 4 * 2 * C * n2)}
            y = torch.sin(2 * x)
            vg = lambda: gp.log_marginal_value_and_grad_chains(template, x, y, theta, 1e-6)  # noqa: E731
            vg()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                vg()
            torch.cuda.synchronize()
            rows["value_and_grad_chains"] = {"ms": time_ms(vg, 20),
                                             "wall_ms": (time.perf_counter() - t0) / 20 * 1e3}
    for key in ("pairwise_k_chains", "pairwise_k_chains_periodic", "pairwise_jac_chains",
                "pairwise_jac_chains_periodic", "chol_tile_inv_chains", "cholesky_blocked_chains",
                "value_and_grad_chains", "pairwise_k_chains_matern52", "pairwise_jac_chains_matern52",
                "pairwise_k_chains_rq", "pairwise_jac_chains_rq", "pairwise_k_chains_tree",
                "tree_jacobian_chains", "pairwise_jac_contract_chains",
                "pairwise_jac_contract_chains_periodic", "pairwise_jac_contract_chains_matern52",
                "pairwise_jac_contract_chains_rq"):
        r = rows[key]
        print(f"  {key}: {r['ms']:.4f} ms" + "".join(
            f", {f} {r[f]:.4f}" for f in ("plain_ms", "library_ms", "replaced_ms", "bound_ms",
                                          "wall_ms")
            if r.get(f) is not None), flush=True)
    torch.cuda.empty_cache()


def run_sampler_path(dev, path) -> dict:
    """Phase 4, MLE and the samplers through the CLI as a user runs them:
    config #2 (periodic MLE, 4 restarts) and config #3 (64 chains, N = 500,
    ChEES with CHEES_WARMUP + CHEES_SAMPLES, NUTS with NUTS_WARMUP +
    NUTS_SAMPLES), float32."""
    from gaussian_processes_tpu_torch import cli
    from gaussian_processes_tpu_torch.utils import CONFIGS

    if path == "mle":
        return cli.run_config(CONFIGS["config2_mle_periodic"], device=dev)
    cfg = CONFIGS[f"config3_{path}_64"]
    warmup, samples = (NUTS_WARMUP, NUTS_SAMPLES) if path == "nuts" else (CHEES_WARMUP,
                                                                         CHEES_SAMPLES)
    print(f"config #3 {path}: {warmup} + {samples} of 500 + 1000", flush=True)
    cfg = dataclasses.replace(cfg, nuts=dataclasses.replace(
        cfg.nuts, num_warmup=warmup, num_samples=samples))
    return cli.run_config(cfg, device=dev)


def plain_lml64_periodic(theta, dev) -> float:
    """Config #2's log marginal likelihood at theta = (h, w, p, s) in
    float64, with the plain pairwise version and torch.linalg."""
    import torch
    from gaussian_processes_tpu_torch import PeriodicKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    cfg = CONFIGS["config2_mle_periodic"]
    x, y, _ = (torch.as_tensor(a, device=dev) for a in make_data(cfg.data, "float64"))
    h, w, p, s = theta
    k = PeriodicKernel(h, w, p, dtype=torch.float64, device=dev)
    L = torch.linalg.cholesky(pw.pairwise_matrix_reference(k, x, x, noise=s, jitter=cfg.fit.jitter))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return float(-0.5 * torch.dot(y, alpha) - torch.log(torch.diagonal(L)).sum()
                 - 0.5 * x.shape[0] * LOG_2PI)


def posterior_means_f64(dev):
    """Config #3's posterior means of theta = (h, w, s) by quadrature in
    float64 on a GRID over u = log theta, with the plain pairwise version
    and torch.linalg (no kernel of the port); and the share of the
    posterior mass on the grid's faces."""
    import math

    import torch
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    cfg = CONFIGS["config3_chees_64"]
    x, y, _ = (torch.as_tensor(a, device=dev) for a in make_data(cfg.data, "float64"))
    n = x.shape[0]
    axes = [torch.linspace(lo, hi, m, dtype=torch.float64) for lo, hi, m in GRID]
    u_all = torch.cartesian_prod(*axes).to(dev)
    k = GaussianKernel(1.0, 1.0, dtype=torch.float64, device=dev)
    log_post = []
    for u in u_all.split(1024):
        theta = torch.exp(u)
        K = pw.pairwise_matrix_chains_reference(k, x, theta[:, :2], theta[:, 2] ** 2 + cfg.fit.jitter)
        L, info = torch.linalg.cholesky_ex(K)
        alpha = torch.cholesky_solve(y[None, :, None].expand(u.shape[0], n, 1), L)[..., 0]
        lml = (-0.5 * (alpha @ y) - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
               - 0.5 * n * math.log(2 * math.pi))
        lml = torch.where(info == 0, lml, torch.full_like(lml, -math.inf))
        log_post.append(lml - 0.5 * torch.sum((u / cfg.nuts.prior_std) ** 2, dim=-1))
    log_post = torch.cat(log_post)
    w = torch.exp(log_post - log_post.max())
    w = w / w.sum()
    mean = (w[:, None] * torch.exp(u_all)).sum(0)
    W = w.reshape(*(m for _, _, m in GRID))
    faces = sum(float(W.select(d, i).sum()) for d in range(3) for i in (0, -1))
    return mean.tolist(), faces


def check_sampler_paths(check, runs, dev) -> dict:
    """Phase 5: config #2's recovered period and noise (the same task in
    float64 on the card) and the float32 run's optimum; config #3's draws
    against a float64 quadrature of the posterior, with R-hat, acceptance
    and divergences."""
    import torch
    from gaussian_processes_tpu_torch import PeriodicKernel, cli
    from gaussian_processes_tpu_torch.inference import fit_mle
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    print("MLE and samplers (float32) on the card:", flush=True)
    s = runs["mle"]
    cfg = CONFIGS["config2_mle_periodic"]
    s64 = cli.run_config(dataclasses.replace(cfg, fit=dataclasses.replace(cfg.fit, dtype="float64")),
                         device=dev)
    lml64 = plain_lml64_periodic(s["theta"], dev)
    x, y, _ = (torch.as_tensor(a, device=dev) for a in make_data(cfg.data, "float64"))
    h, w, p, noise = s["theta"]
    polished = fit_mle(PeriodicKernel(h, w, p, dtype=torch.float64, device=dev), x, y, noise,
                       num_steps=cfg.mle.num_steps, jitter=cfg.fit.jitter)
    print(f"  config #2 float32: {s['mle_wall_s']:.3f} s, theta {[round(t, 5) for t in s['theta']]}, "
          f"lml {s['log_marginal']:.4f} (in float64 {lml64:.4f}; float64 L-BFGS from there "
          f"{float(polished.log_marginal):.4f}); float64 run: {s64['mle_wall_s']:.3f} s, theta "
          f"{[round(t, 5) for t in s64['theta']]}, lml {s64['log_marginal']:.4f}", flush=True)
    for run, (_, _, p_run, s_run) in (("float64", s64["theta"]), ("float32", s["theta"])):
        if run == "float64":
            check(f"config #2 {run} |p - 0.5|", abs(p_run - MLE_P), MLE_P_TOL)
        check(f"config #2 {run} |s - 0.1|", abs(s_run - MLE_S), MLE_S_TOL)
    check("config #2 float32 optimum: |lml - lml after float64 L-BFGS from it|, float64 (nats)",
          abs(float(polished.log_marginal) - lml64), MLE_LML_NATS)
    summary = {"mle": {key: s[key] for key in ("mle_wall_s", "log_marginal", "theta", "converged")},
               "mle_float64": {key: s64[key] for key in ("mle_wall_s", "log_marginal", "theta")}}
    summary["mle"].update(log_marginal_float64=lml64,
                          polished_float64=float(polished.log_marginal))

    exact, faces = posterior_means_f64(dev)
    print(f"  config #3 posterior means by float64 quadrature: {[round(m, 5) for m in exact]}",
          flush=True)
    check("config #3 quadrature: posterior mass on the grid's faces", faces, GRID_EDGE_MASS)
    summary["posterior_mean_quadrature"] = exact
    for path, ref, rhat in (("chees", CHEES_REF, CHEES_RHAT), ("nuts", NUTS_REF, NUTS_RHAT)):
        s = runs[path]
        d = s["diagnostics"]
        print(f"  config #3 {path}: {s['n_samples']} draws x {s['n_chains']} chains in "
              f"{s['wall_s']:.2f} s ({s['samples_per_s']:.1f} samples/s with warmup), accept "
              f"{s['accept_rate']:.3f}, divergent {s['divergence_frac']:.4f}, mean leapfrog "
              f"{s['mean_leapfrog']:.2f}, step {s['step_size']:.4f}, max R-hat {d['max_rhat']:.4f}, "
              f"min ESS {d['min_ess']:.0f} ({d['ess_per_s']:.1f} ESS/s), mean "
              f"{[round(m, 4) for m in s['posterior_mean']]} +- "
              f"{[round(e, 4) for e in s['posterior_mean_se']]}", flush=True)
        check(f"config #3 {path} draws finite (0 = yes)", 0.0 if s["draws_finite"] else 1.0, 0.0)
        check(f"config #3 {path} max split R-hat", d["max_rhat"], rhat)
        se = s["posterior_mean_se"]
        print(f"  config #3 {path}: |mean - reference| / MC standard error "
              f"{[round(abs(m - r) / e, 2) for m, r, e in zip(s['posterior_mean'], ref, se)]} "
              f"against the reference's {list(ref)}", flush=True)
        for i, name in enumerate(("h", "w", "s")):
            check(f"config #3 {path} mean {name}: |mean - quadrature| / MC standard error",
                  abs(s["posterior_mean"][i] - exact[i]) / se[i], SAMPLER_SE)
        if path == "chees":
            check("config #3 chees mean acceptance", s["accept_rate"], CHEES_ACCEPT[1])
            check("config #3 chees mean acceptance (negated)", -s["accept_rate"], -CHEES_ACCEPT[0])
        else:
            check("config #3 nuts divergent fraction", s["divergence_frac"], NUTS_DIVERGENT)
        summary[path] = {key: s[key] for key in (
            "wall_s", "samples_per_s", "accept_rate", "divergence_frac", "mean_leapfrog",
            "step_size", "posterior_mean", "posterior_mean_se", "n_samples")}
        summary[path].update(max_rhat=d["max_rhat"], min_ess=d["min_ess"], ess_per_s=d["ess_per_s"])
    return summary


def run_iterative_path(dev) -> dict:
    """Phase 4, the matrix-free path as a user drives it."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    out = {}
    x, y, k = sine_problem(ITER_N, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = gpx.fit_iterative(k, x, y, ITER_NOISE, seed(10), **ITER_OPTS)
    torch.cuda.synchronize()
    out["fit_wall_s"] = time.perf_counter() - t0
    xo = torch.linspace(-np.pi, np.pi, N_TEST_MEAN, device=dev)
    out["se"] = (x, y, k, post, xo, gpx.predict_mean_iterative(post, xo))
    xd = torch.linspace(-3.0, 3.0, N_TEST_DIAG, device=dev)
    diag_opts = {key: ITER_OPTS[key] for key in ("num_iters", "tol", "jitter", "precond_rank")}
    out["diag"] = gpx.predict_diag_iterative(post, xd, **diag_opts)
    t0 = time.perf_counter()
    out["grad"] = gpx.log_marginal_value_and_grad_iterative(k, x, y, ITER_NOISE, seed(11),
                                                            **ITER_OPTS)
    torch.cuda.synchronize()
    out["grad_wall_s"] = time.perf_counter() - t0

    xa, ya, ka = ard_problem(ITER_N, dev)
    for wall in ("ard_fit_wall_s", "ard_fit_warm_wall_s"):  # first call, then again
        t0 = time.perf_counter()
        out["ard"] = (xa, ya, ka, gpx.fit_iterative(ka, xa, ya, ITER_NOISE, seed(12), **ITER_OPTS))
        torch.cuda.synchronize()
        out[wall] = time.perf_counter() - t0
    xa16, ya16 = xa[:K_N].contiguous(), ya[:K_N].contiguous()
    post_e = gpx.fit(ka, xa16, ya16, ITER_NOISE, ITER_JITTER)
    out["ard_exact"] = (xa16, ya16, float(post_e.log_marginal),
                        *gpx.predict_diag(post_e, xa[K_N:K_N + 100].contiguous()))

    x16, y16, k16 = sine_problem(ITER_CHECK_N, dev)
    k0 = k16.with_params(k16.params * torch.tensor([1.0, 2.0], device=dev))
    mle_opts = {key: ITER_OPTS[key] for key in ("num_probes", "num_iters", "tol", "jitter")}
    out["mle"] = gpx.fit_mle_iterative(k0, x16, y16, 0.3, seed(13), num_steps=5,
                                       learning_rate=0.05, **mle_opts)
    return out


def check_iterative_path(check, out, dev) -> dict:
    """Phase 5, the matrix-free path against plain float64 on the card."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.models import iterative_gp
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("matrix-free path (float32) vs plain float64 on the card:", flush=True)
    summary = {key: out[key] for key in ("fit_wall_s", "grad_wall_s", "ard_fit_wall_s",
                                          "ard_fit_warm_wall_s")}

    def finite(*ts):
        return 0.0 if all(bool(torch.isfinite(t).all()) for t in ts) else 1.0

    x, y, k, post, xo, mean = out["se"]
    res = true_residual(k, x, y, post.alpha)
    rmse = float(torch.sqrt(torch.mean((mean.double() - torch.sin(2 * xo.double())) ** 2)))
    print(f"  SE N={ITER_N}: fit_iterative {out['fit_wall_s']:.3f} s, recurrence residual "
          f"{float(post.solve_residual):.3e}, lml {float(post.log_marginal):.4f}", flush=True)
    check(f"SE N={ITER_N} true relative residual (f64)", res, ITER_RESIDUAL)
    check(f"SE N={ITER_N} mean RMSE vs sin(2x) ({N_TEST_MEAN} points)", rmse, ITER_RMSE)
    m_d, var_d = out["diag"]
    lml_g, grad_g = out["grad"]
    check(f"SE N={ITER_N} outputs finite (0 = yes)",
          finite(post.alpha, post.log_marginal, mean, m_d, var_d, lml_g, grad_g), 0.0)
    check(f"SE N={ITER_N} shapes (0 = yes)", 0.0 if (
        mean.shape == xo.shape and var_d.shape == (N_TEST_DIAG,) and grad_g.shape == (3,)) else 1.0,
        0.0)
    check(f"SE N={ITER_N} min predictive var >= -1e-4 (negated)", -float(var_d.min()), 1e-4)
    print(f"  SE N={ITER_N} value+grad {out['grad_wall_s']:.3f} s: lml {float(lml_g):.4f}, grad "
          f"{np.array2string(grad_g.double().cpu().numpy(), precision=4)}", flush=True)
    summary.update(se_residual=res, se_rmse=rmse, se_lml=float(post.log_marginal))

    xa, ya, ka, post_a = out["ard"]
    res = true_residual(ka, xa, ya, post_a.alpha)
    print(f"  ARD D={ARD_DIM} N={ITER_N}: fit_iterative {out['ard_fit_wall_s']:.3f} s "
          f"(again: {out['ard_fit_warm_wall_s']:.3f} s), recurrence "
          f"residual {float(post_a.solve_residual):.3e}", flush=True)
    check(f"ARD N={ITER_N} true relative residual (f64)", res, ITER_RESIDUAL)
    check(f"ARD N={ITER_N} outputs finite (0 = yes)", finite(post_a.alpha, post_a.log_marginal),
          0.0)
    summary.update(ard_residual=res)

    xa16, ya16, lml_e, m_e, var_e = out["ard_exact"]
    ka64 = ka.with_params(ka.params.double())
    K = pw.pairwise_matrix_ard_reference(ka64, xa16.double(), xa16.double(), noise=ITER_NOISE,
                                         jitter=ITER_JITTER)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(ya16.double()[:, None], L)[:, 0]
    lml64 = float(-0.5 * torch.dot(ya16.double(), alpha) - torch.log(torch.diagonal(L)).sum()
                  - 0.5 * K_N * LOG_2PI)
    del L
    print(f"  ARD exact fit N={K_N}: lml {lml_e:.4f} (f64 plain {lml64:.4f})", flush=True)
    check(f"ARD exact N={K_N} lml rel vs f64", abs(lml_e - lml64) / abs(lml64), FIT_LML_REL)
    check(f"ARD exact N={K_N} outputs finite (0 = yes)", finite(m_e, var_e), 0.0)
    check(f"ARD exact N={K_N} min predictive var >= -1e-4 (negated)", -float(var_e.min()), 1e-4)

    # N=16384: alpha, lml and gradient against a dense float64 Cholesky
    x16, y16, k16 = sine_problem(ITER_CHECK_N, dev)
    post16 = gpx.fit_iterative(k16, x16, y16, ITER_NOISE, seed(20), **ITER_OPTS)
    est = iterative_gp.log_marginal_estimate_iterative(k16, x16, y16, ITER_NOISE, seed(21),
                                                       **ITER_OPTS)
    k64, x64, y64 = k16.with_params(k16.params.double()), x16.double(), y16.double()
    L = torch.linalg.cholesky(pw.pairwise_matrix_reference(k64, x64, x64, noise=ITER_NOISE,
                                                           jitter=ITER_JITTER))
    alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]
    lml64 = float(-0.5 * torch.dot(y64, alpha) - torch.log(torch.diagonal(L)).sum()
                  - 0.5 * ITER_CHECK_N * LOG_2PI)
    Kinv = torch.cholesky_inverse(L)
    del L
    J = pw.pairwise_jacobian_reference(k64, x64, x64)
    grad64 = 0.5 * torch.stack([
        alpha @ (J[0] @ alpha) - (Kinv * J[0]).sum(),
        alpha @ (J[1] @ alpha) - (Kinv * J[1]).sum(),
        2 * ITER_NOISE * (alpha @ alpha - torch.trace(Kinv)),
    ])
    del J, Kinv
    torch.cuda.empty_cache()
    r = est.logdet_terms.shape[0]
    se_lml = 0.5 * float(est.logdet_terms.double().std()) / r ** 0.5
    se_grad = 0.5 * est.trace_terms.double().std(dim=1) / r ** 0.5
    a_rel = float(torch.linalg.norm(post16.alpha.double() - alpha) / torch.linalg.norm(alpha))
    print(f"  N={ITER_CHECK_N}: lml {float(est.lml):.4f} +- {se_lml:.4f} (dense f64 {lml64:.4f}); "
          f"grad {np.array2string(est.grad.double().cpu().numpy(), precision=4)} +- "
          f"{np.array2string(se_grad.cpu().numpy(), precision=4)} (dense f64 "
          f"{np.array2string(grad64.cpu().numpy(), precision=4)})", flush=True)
    check(f"N={ITER_CHECK_N} alpha rel vs dense f64", a_rel, ITER_ALPHA_REL)
    check(f"N={ITER_CHECK_N} lml |est - dense| / its standard error",
          abs(float(est.lml) - lml64) / se_lml, ITER_SE)
    for p, name in enumerate(("h", "w", "s")):
        check(f"N={ITER_CHECK_N} grad[{name}] |est - dense| / its standard error",
              float((est.grad[p].double() - grad64[p]).abs() / se_grad[p]), ITER_SE)
    summary.update(alpha_rel_16k=a_rel, lml_16k=(float(est.lml), se_lml, lml64))

    _, noise_f, _, trace = out["mle"]
    print(f"  fit_mle_iterative N={ITER_CHECK_N}, 5 Adam steps: lml trace "
          f"{[round(v, 3) for v in trace]}, noise {float(noise_f):.4f}", flush=True)
    check("MLE lml trace rises every step (count of falls)",
          float(sum(b <= a for a, b in zip(trace, trace[1:]))), 0.0)
    check("MLE lml finite (0 = yes)", 0.0 if all(np.isfinite(trace)) else 1.0, 0.0)
    summary.update(mle_trace=trace)
    return summary


def plain_fit64(x, y, xo, noise, jitter, k=None):
    """Independent float64 fit + predictive mean: twins + torch.linalg; the
    kernel ``k`` (in float64), SE with h = w = 1 by default."""
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    if k is None:
        k = GaussianKernel(1.0, 1.0, dtype=torch.float64, device=x.device)
    K = pw.pairwise_matrix_reference(k, x, x, noise=noise, jitter=jitter)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    lml = (-0.5 * torch.dot(y, alpha) - torch.log(torch.diagonal(L)).sum()
           - 0.5 * x.shape[0] * LOG_2PI)
    return float(lml), pw.pairwise_matrix_reference(k, xo, x) @ alpha


def plain_grad_hess64(x, y, noise, jitter, k=None):
    """Independent float64 gradient and Hessian of the log marginal
    likelihood in theta = (kernel params..., s), written from the formulas;
    the kernel ``k`` (in float64), SE with h = w = 1 by default."""
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    n = x.shape[0]
    if k is None:
        k = GaussianKernel(1.0, 1.0, dtype=torch.float64, device=x.device)
    L = torch.linalg.cholesky(pw.pairwise_matrix_reference(k, x, x, noise=noise, jitter=jitter))
    Kinv = torch.cholesky_inverse(L)
    alpha = Kinv @ y
    eye = torch.eye(n, dtype=torch.float64, device=x.device)
    J = torch.cat([pw.pairwise_jacobian_reference(k, x, x), (2 * noise * eye)[None]])
    T = J.shape[0]
    Ja = J @ alpha
    grad = 0.5 * (Ja @ alpha - (Kinv[None] * J).sum(dim=(1, 2)))
    W = Kinv @ J
    H = torch.zeros(T, T, dtype=torch.float64, device=x.device)
    for p in range(T):
        for q in range(T):
            t = -(Ja[p] @ (Kinv @ Ja[q])) + 0.5 * (W[q] * W[p].T).sum()
            if p < T - 1 and q < T - 1:
                Hpq = pw.pairwise_hessian_reference(k, x, x, pair=(p, q))
            else:
                Hpq = 2 * eye if p == q else None
            if Hpq is not None:
                t = t + 0.5 * alpha @ (Hpq @ alpha) - 0.5 * (Kinv * Hpq).sum()
            H[p, q] = t
    return grad, H


def run_new_exact_path(dev) -> dict:
    """Phase 4, the exact path for Matérn 3/2, Matérn 5/2 and RQ (h = 1,
    w = 1; RQ a = 1.5) through the library on config #1's data: ``fit`` and
    ``predict_diag`` at K_N in float32, the analytic gradient and the
    chunked Hessian at GRAD_N in float32 and float64."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    cfg1 = CONFIGS["config1_fit_se500"]
    fit = cfg1.fit
    out = {}
    for fam, params in NEW_FAMILY_PARAMS.items():
        data = dataclasses.replace(cfg1.data, n=K_N)
        x, y, xo = (torch.as_tensor(a, device=dev) for a in make_data(data, "float32"))
        k = new_kernel(fam, params, torch.float32, dev)
        post = gpx.fit(k, x, y, fit.noise, fit.jitter)
        out[f"fit_{fam}"] = (x, y, xo, float(post.log_marginal), *gpx.predict_diag(post, xo))
        data = dataclasses.replace(cfg1.data, n=GRAD_N)
        x, y, _ = (torch.as_tensor(a, device=dev) for a in make_data(data, "float32"))
        for dtype in (torch.float32, torch.float64):
            k = new_kernel(fam, params, dtype, dev)
            xd, yd = x.to(dtype), y.to(dtype)
            _, grad = gpx.log_marginal_value_and_grad(k, xd, yd, fit.noise, fit.jitter)
            hess = gpx.log_marginal_hessian(k, xd, yd, fit.noise, fit.jitter)
            out[f"grad_hess_{fam}_{str(dtype).split('.')[-1]}"] = (x, y, grad, hess)
    return out


def check_new_exact_path(check, out, dev):
    """Phase 5: the new families' exact path against plain float64 on the
    card, with the limits of the SE path (PERF.md section 2)."""
    import numpy as np
    import torch

    print("exact path, Matérn 3/2, Matérn 5/2, RQ (float32 and float64) vs plain float64:",
          flush=True)
    noise, jitter = 0.1, 1e-6
    for fam, params in NEW_FAMILY_PARAMS.items():
        k64 = new_kernel(fam, params, torch.float64, dev)
        x, y, xo, lml32, mean32, var32 = out[f"fit_{fam}"]
        lml64, mean64 = plain_fit64(x.double(), y.double(), xo.double(), noise, jitter, k64)
        rmse = float(torch.sqrt(torch.mean((mean32.double() - torch.sin(2 * xo.double())) ** 2)))
        print(f"  {fam} N={K_N}: lml {lml32:.6f} (f64 plain {lml64:.6f}), rmse {rmse:.5f}",
              flush=True)
        check(f"{fam} N={K_N} fit lml rel vs f64", abs(lml32 - lml64) / abs(lml64), FIT_LML_REL)
        check(f"{fam} N={K_N} mean max-abs vs f64", float((mean32.double() - mean64).abs().max()),
              FIT_MEAN_ABS)
        check(f"{fam} N={K_N} rmse vs sin(2x)", rmse, FIT_RMSE)
        finite = bool(torch.isfinite(mean32).all() and torch.isfinite(var32).all())
        check(f"{fam} N={K_N} outputs finite, shape {tuple(mean32.shape)} (0 = yes)",
              0.0 if finite and mean32.shape == xo.shape else 1.0, 0.0)
        check(f"{fam} N={K_N} min predictive var >= -1e-4 (negated)", -float(var32.min()), 1e-4)
        x, y = out[f"grad_hess_{fam}_float32"][:2]
        g64, h64 = plain_grad_hess64(x.double(), y.double(), noise, jitter, k64)
        for dname in ("float32", "float64"):
            _, _, grad, hess = out[f"grad_hess_{fam}_{dname}"]
            print(f"  {fam} N={GRAD_N} {dname} grad "
                  f"{np.array2string(grad.double().cpu().numpy(), precision=6)} (f64 plain "
                  f"{np.array2string(g64.cpu().numpy(), precision=6)})", flush=True)
            check(f"{fam} N={GRAD_N} {dname} grad rel (norm) vs plain f64",
                  float((grad.double() - g64).norm() / g64.norm()), GRAD_REL[dname])
            check(f"{fam} N={GRAD_N} {dname} hessian rel (norm) vs plain f64",
                  float((hess.double() - h64).norm() / h64.norm()), HESS_REL[dname])


def run_new_iterative_path(dev) -> dict:
    """Phase 4, the matrix-free path for the new families on the SE
    workload's data, lengthscale and solver settings at ITER_N: Matérn 5/2
    ``fit_iterative``, its predictive mean and stochastic gradient, and the
    stochastic gradient of Matérn 3/2 and RQ (a = 1.5)."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    x, y, k_se = sine_problem(ITER_N, dev)
    w = float(k_se.w)
    out = {"x": x, "y": y, "w": w}
    k = new_kernel("matern52", (1.0, w), torch.float32, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = gpx.fit_iterative(k, x, y, ITER_NOISE, seed(30), **ITER_OPTS)
    torch.cuda.synchronize()
    out["fit_wall_s"] = time.perf_counter() - t0
    xo = torch.linspace(-np.pi, np.pi, N_TEST_MEAN, device=dev)
    out["fit"] = (k, post, xo, gpx.predict_mean_iterative(post, xo))
    for fam in NEW_FAMILY_PARAMS:
        kf = new_kernel(fam, (1.0, w, *NEW_FAMILY_PARAMS[fam][2:]), torch.float32, dev)
        t0 = time.perf_counter()
        out[f"grad_{fam}"] = gpx.log_marginal_value_and_grad_iterative(
            kf, x, y, ITER_NOISE, seed(31), **ITER_OPTS)
        torch.cuda.synchronize()
        out[f"grad_{fam}_wall_s"] = time.perf_counter() - t0
    return out


def true_residual(k, x, y, alpha) -> float:
    """||(K + (s^2 + jitter) I) alpha - y|| / ||y|| by a plain float64 matvec."""
    import torch
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    k64 = k.with_params(k.params.double())
    y64 = y.double()
    r = pw.kernel_matvec_fused_reference(k64, x.double(), alpha.double(), ITER_NOISE,
                                         ITER_JITTER) - y64
    return float(torch.linalg.norm(r) / torch.linalg.norm(y64))


def check_new_iterative_path(check, out) -> dict:
    import numpy as np
    import torch

    print("matrix-free path, new families (float32) vs plain float64 on the card:", flush=True)
    x, y = out["x"], out["y"]
    k, post, xo, mean = out["fit"]
    res = true_residual(k, x, y, post.alpha)
    rmse = float(torch.sqrt(torch.mean((mean.double() - torch.sin(2 * xo.double())) ** 2)))
    print(f"  matern52 N={ITER_N} (w = {out['w']:.4e}): fit_iterative {out['fit_wall_s']:.3f} s, "
          f"recurrence residual {float(post.solve_residual):.3e}, true residual {res:.3e}, "
          f"lml {float(post.log_marginal):.4f}", flush=True)
    check(f"matern52 N={ITER_N} true relative residual (f64)", res, ITER_RESIDUAL)
    check(f"matern52 N={ITER_N} mean RMSE vs sin(2x) ({N_TEST_MEAN} points)", rmse, ITER_RMSE)
    summary = {"matern52_fit_wall_s": out["fit_wall_s"], "matern52_residual": res,
               "matern52_rmse": rmse}
    for fam in NEW_FAMILY_PARAMS:
        lml, grad = out[f"grad_{fam}"]
        print(f"  {fam} N={ITER_N} value+grad {out[f'grad_{fam}_wall_s']:.3f} s: lml "
              f"{float(lml):.4f}, grad {np.array2string(grad.double().cpu().numpy(), precision=4)}",
              flush=True)
        ok = bool(torch.isfinite(lml)) and bool(torch.isfinite(grad).all())
        check(f"{fam} N={ITER_N} value+grad finite, shape ({len(NEW_FAMILY_PARAMS[fam]) + 1},) "
              "(0 = yes)", 0.0 if ok and grad.shape == (len(NEW_FAMILY_PARAMS[fam]) + 1,) else 1.0,
              0.0)
        summary[f"{fam}_grad_wall_s"] = out[f"grad_{fam}_wall_s"]
    return summary


def run_tree_iterative_path(dev) -> dict:
    """Phase 4, the matrix-free path for the quasi-periodic tree at ITER_N
    on the SE workload's data, lengthscale (the SE leaf's) and solver
    settings: ``fit_iterative`` (B4's tree body, B1's tree body for the
    pivot rows) and its predictive mean."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    x, y, k_se = sine_problem(ITER_N, dev)
    k = tree_kernel("qp", torch.float32, dev, se=(1.0, float(k_se.w)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = gpx.fit_iterative(k, x, y, ITER_NOISE, seed(33), **ITER_OPTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xo = torch.linspace(-np.pi, np.pi, N_TEST_MEAN, device=dev)
    return {"x": x, "y": y, "k": k, "post": post, "xo": xo, "wall_s": wall,
            "mean": gpx.predict_mean_iterative(post, xo)}


def check_tree_iterative_path(check, out) -> dict:
    import torch

    post, xo, mean = out["post"], out["xo"], out["mean"]
    res = true_residual(out["k"], out["x"], out["y"], post.alpha)
    rmse = float(torch.sqrt(torch.mean((mean.double() - torch.sin(2 * xo.double())) ** 2)))
    print(f"  tree SE x periodic N={ITER_N}: fit_iterative {out['wall_s']:.3f} s, recurrence "
          f"residual {float(post.solve_residual):.3e}, true residual {res:.3e}, lml "
          f"{float(post.log_marginal):.4f}", flush=True)
    check(f"tree N={ITER_N} true relative residual (f64)", res, ITER_RESIDUAL)
    check(f"tree N={ITER_N} mean RMSE vs sin(2x) ({N_TEST_MEAN} points)", rmse, ITER_RMSE)
    check(f"tree N={ITER_N} outputs finite (0 = yes)",
          0.0 if bool(torch.isfinite(post.alpha).all() and torch.isfinite(mean).all()) else 1.0,
          0.0)
    return {"tree_fit_wall_s": out["wall_s"], "tree_residual": res, "tree_rmse": rmse}


def run_new_sampler_path(dev, path) -> dict:
    """Phase 4 through the CLI with a kernel override: config #2's MLE task
    with RQ ("mle-rq"), and config #3's ChEES with Matérn 5/2 cut to
    CHEES_NEW_WARMUP + CHEES_NEW_SAMPLES ("chees-matern52"), float32."""
    from gaussian_processes_tpu_torch import cli
    from gaussian_processes_tpu_torch.utils import CONFIGS, KernelConfig

    if path == "mle-rq":
        h, w, a = MLE_RQ_START
        cfg = dataclasses.replace(CONFIGS["config2_mle_periodic"],
                                  kernel=KernelConfig(family="rq", h=h, w=w, p=a))
        return cli.run_config(cfg, device=dev)
    cfg = CONFIGS["config3_chees_64"]
    cfg = dataclasses.replace(cfg, kernel=KernelConfig(family="matern52"),
                              nuts=dataclasses.replace(cfg.nuts, num_warmup=CHEES_NEW_WARMUP,
                                                       num_samples=CHEES_NEW_SAMPLES))
    return cli.run_config(cfg, device=dev)


def check_new_sampler_paths(check, runs, dev) -> dict:
    """Phase 5: RQ's MLE (finite; its float32 optimum's float64 lml within
    MLE_LML_NATS of where float64 L-BFGS goes from it) and the Matérn 5/2
    ChEES run (finite draws, split R-hat, acceptance)."""
    import math

    import torch
    from gaussian_processes_tpu_torch.inference import fit_mle
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    s = runs["mle-rq"]
    cfg = CONFIGS["config2_mle_periodic"]
    x, y, _ = (torch.as_tensor(a, device=dev) for a in make_data(cfg.data, "float64"))
    h, w, a, noise = s["theta"]
    k = new_kernel("rq", (h, w, a), torch.float64, dev)
    L = torch.linalg.cholesky(pw.pairwise_matrix_reference(k, x, x, noise=noise,
                                                           jitter=cfg.fit.jitter))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    lml64 = float(-0.5 * torch.dot(y, alpha) - torch.log(torch.diagonal(L)).sum()
                  - 0.5 * x.shape[0] * LOG_2PI)
    polished = fit_mle(k, x, y, noise, num_steps=cfg.mle.num_steps, jitter=cfg.fit.jitter)
    print(f"  config #2 with RQ, float32: {s['mle_wall_s']:.3f} s, theta "
          f"{[round(t, 5) for t in s['theta']]}, lml {s['log_marginal']:.4f} (in float64 "
          f"{lml64:.4f}; float64 L-BFGS from there {float(polished.log_marginal):.4f})", flush=True)
    finite = all(math.isfinite(t) for t in s["theta"]) and math.isfinite(s["log_marginal"])
    check("config #2 with RQ: theta and lml finite (0 = yes)",
          0.0 if finite and math.isfinite(lml64) else 1.0, 0.0)
    check("config #2 with RQ float32 optimum: |lml - lml after float64 L-BFGS from it|, "
          "float64 (nats)", abs(float(polished.log_marginal) - lml64), MLE_LML_NATS)
    summary = {"mle_rq": {key: s[key] for key in ("mle_wall_s", "log_marginal", "theta")}}
    summary["mle_rq"].update(log_marginal_float64=lml64,
                             polished_float64=float(polished.log_marginal))
    s = runs["chees-matern52"]
    d = s["diagnostics"]
    print(f"  config #3 with Matérn 5/2, ChEES {CHEES_NEW_WARMUP} + {CHEES_NEW_SAMPLES}: "
          f"{s['wall_s']:.2f} s, accept {s['accept_rate']:.3f}, max R-hat {d['max_rhat']:.4f}, "
          f"mean leapfrog {s['mean_leapfrog']:.2f}, mean "
          f"{[round(m, 4) for m in s['posterior_mean']]}", flush=True)
    check("config #3 with Matérn 5/2 draws finite (0 = yes)", 0.0 if s["draws_finite"] else 1.0,
          0.0)
    check("config #3 with Matérn 5/2 max split R-hat", d["max_rhat"], CHEES_NEW_RHAT)
    check("config #3 with Matérn 5/2 chees mean acceptance", s["accept_rate"], CHEES_ACCEPT[1])
    check("config #3 with Matérn 5/2 chees mean acceptance (negated)", -s["accept_rate"],
          -CHEES_ACCEPT[0])
    summary["chees_matern52"] = {key: s[key] for key in (
        "wall_s", "accept_rate", "mean_leapfrog", "step_size", "posterior_mean")}
    summary["chees_matern52"]["max_rhat"] = d["max_rhat"]
    return summary


def run_chains_tree_path(dev) -> dict:
    """Phase 4: one batched value and gradient of CHAINS chains at CHAIN_N for
    the quasi-periodic tree, float32 and float64, as a sampler's leapfrog
    evaluates it."""
    import torch
    from gaussian_processes_tpu_torch.models import gp

    out = {}
    for dtype in (torch.float32, torch.float64):
        x, template, theta = chain_problem(dev, dtype, "tree")
        y = torch.sin(2 * x)
        out[str(dtype).split(".")[-1]] = (x, y, theta, *gp.log_marginal_value_and_grad_chains(
            template, x, y, theta, 1e-6))
    return out


def check_chains_tree_path(check, out):
    """Phase 5: the tree's batched value and gradient against the plain
    version (the CPU path: plain twins and LAPACK) in float64."""
    import torch
    from gaussian_processes_tpu_torch.models import gp

    x, y, theta, _, _ = out["float64"]
    template = tree_kernel("qp", torch.float64, "cpu")
    lml64, grad64 = gp.log_marginal_value_and_grad_chains(template, x.cpu(), y.cpu(),
                                                          theta.cpu(), 1e-6)
    for dname, (lml_tol, grad_tol) in (("float32", (1e-3, 2e-2)), ("float64", (1e-9, 1e-8))):
        _, _, _, lml, grad = out[dname]
        lml_rel = float(((lml.cpu().double() - lml64).abs() / lml64.abs()).max())
        grad_rel = float((grad.cpu().double() - grad64).abs().max() / grad64.abs().max())
        print(f"  tree value+grad, {CHAINS} chains at N={CHAIN_N}, {dname}: lml rel {lml_rel:.3e}, "
              f"grad (max abs / max) {grad_rel:.3e}", flush=True)
        check(f"tree chains {dname}: lml rel vs plain f64", lml_rel, lml_tol)
        check(f"tree chains {dname}: grad max-abs / max vs plain f64", grad_rel, grad_tol)


def run_main_path(dev) -> dict:
    """Phase 4: the main path, as a user drives it.  Returns its outputs."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch import cli
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data, timed

    cfg1 = CONFIGS["config1_fit_se500"]
    out = {}
    for n in FIT_NS:
        cfg = dataclasses.replace(cfg1, data=dataclasses.replace(cfg1.data, n=n))
        out[f"cli_{n}"] = cli.run_config(cfg, device=dev)
        x, y, xo = (torch.as_tensor(a, device=dev) for a in make_data(cfg.data, "float32"))
        k = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float32, device=dev)
        post = gpx.fit(k, x, y, cfg.fit.noise, cfg.fit.jitter)
        mean, var = gpx.predict_diag(post, xo)
        out[f"fit_{n}"] = (x, y, xo, float(post.log_marginal), mean, var)
    cfg = dataclasses.replace(cfg1, data=dataclasses.replace(cfg1.data, n=GRAD_N))
    x, y, _ = (torch.as_tensor(a, device=dev) for a in make_data(cfg.data, "float32"))
    for dtype in (torch.float32, torch.float64):
        k = gpx.GaussianKernel(1.0, 1.0, dtype=dtype, device=dev)
        xd, yd = x.to(dtype), y.to(dtype)

        def grad_and_hessian():
            _, grad = gpx.log_marginal_value_and_grad(k, xd, yd, cfg.fit.noise, cfg.fit.jitter)
            return grad, gpx.log_marginal_hessian(k, xd, yd, cfg.fit.noise, cfg.fit.jitter)

        grad, hess = grad_and_hessian()
        wall = timed(grad_and_hessian, device=dev, warmup=1, iters=3)
        out[f"grad_hess_{str(dtype).split('.')[-1]}"] = (x, y, grad, hess, wall)
    return out


def check_main_path(check, out, noise, jitter):
    """Phase 5: the float32 main path against plain float64 on the card."""
    import numpy as np
    import torch

    print("main path (float32) vs plain float64 on the card:", flush=True)
    for n in FIT_NS:
        s = out[f"cli_{n}"]
        x, y, xo, lml32, mean32, var32 = out[f"fit_{n}"]
        lml64, mean64 = plain_fit64(x.double(), y.double(), xo.double(), noise, jitter)
        print(f"  N={n}: cli fit {s['fit_wall_s'] * 1e3:.3f} ms, lml {s['log_marginal']:.6f} "
              f"(f64 plain {lml64:.6f}), rmse {s['pred_rmse_vs_truth']:.5f}", flush=True)
        check(f"N={n} cli lml rel vs f64", abs(s["log_marginal"] - lml64) / abs(lml64), FIT_LML_REL)
        check(f"N={n} fit lml rel vs f64", abs(lml32 - lml64) / abs(lml64), FIT_LML_REL)
        check(f"N={n} mean max-abs vs f64", float((mean32.double() - mean64).abs().max()),
              FIT_MEAN_ABS)
        check(f"N={n} rmse vs sin(2x)", s["pred_rmse_vs_truth"], FIT_RMSE)
        finite = bool(torch.isfinite(mean32).all() and torch.isfinite(var32).all())
        check(f"N={n} outputs finite, shape {tuple(mean32.shape)} (0 = yes)",
              0.0 if finite and mean32.shape == xo.shape else 1.0, 0.0)
        check(f"N={n} min predictive var >= -1e-4 (negated)", -float(var32.min()), 1e-4)
    x, y = out["grad_hess_float32"][:2]
    g64, h64 = plain_grad_hess64(x.double(), y.double(), noise, jitter)
    print(f"  plain f64 grad {np.array2string(g64.cpu().numpy(), precision=6)}", flush=True)
    for dname in ("float32", "float64"):
        _, _, grad, hess, wall = out[f"grad_hess_{dname}"]
        print(f"  N={GRAD_N} {dname} value_and_grad + chunked hessian: {wall * 1e3:.3f} ms "
              f"(best of 3); grad {np.array2string(grad.double().cpu().numpy(), precision=6)}",
              flush=True)
        check(f"N={GRAD_N} {dname} grad rel (norm) vs plain f64",
              float((grad.double() - g64).norm() / g64.norm()), GRAD_REL[dname])
        check(f"N={GRAD_N} {dname} hessian rel (norm) vs plain f64",
              float((hess.double() - h64).norm() / h64.norm()), HESS_REL[dname])


# ---------------------------------------------------------------------------
# Slice 3 (structured grids) and config #4's fit_large on one card
# ---------------------------------------------------------------------------

# config #4: the exact fit at N=65536 (jitter 1e-4).  Its true residual
# ||(K + s^2 I) alpha - y|| / ||y||, with B4 in float64 (no float64 K), is
# gated: an H100 measured 1.27e-3 (A's condition ~ 2.4e6 in float32 with a
# solution of norm 2542 against ||y|| ~ 182), so 1e-2 leaves a factor 8 for
# the rounding and rejects a solve that misses a tile.  The normwise
# backward error ||r|| / (||A||_2 ||alpha|| + ||y||) (||A||_2 by power
# iteration with B4) is printed beside it, not gated: measured 3.8e-9, it
# sits far below sqrt(n) u = 1.5e-5 because alpha lies in A's small
# eigenvalues, so ||A||_2 ||alpha|| ~ 6e7 against ||A alpha|| = ||y||
FIT_LARGE_RESIDUAL = 1e-2
FIT_LARGE_POWER_ITERS = 30
# config #4 runs through fit_blockcyclic (the CLI, over the process group):
# its peak memory at W = 1 within 1.25 x the one (N, N) float32 strip
# (17.18 GB at N=65536; the single-card fit holds K and its factor, 34.4 GB),
# so a strip-sized temporary fails it; its lml within the fit's own limit
# (PERF.md section 2) of the single-card fit's on the same data, which it
# differs from by the right- against left-looking order of float32 sums
FIT_LARGE_PEAK_GB = 1.25 * 65536 ** 2 * 4 / 1e9
FIT_LARGE_LML_REL = 1e-3
# kernel B1 on the block-cyclic strip of config #4 (blocks of 256): at the
# W = 1 of the fit-large path, (N, N), held to its plain version in row
# chunks of BC_CHUNK (the plain version's (N, N) temporaries would not fit
# beside the 17.2 GB strip); in float64 on rank 0's (8192, N) strip over
# BC_STRIP_RANKS ranks
BC_BLOCK, BC_CHUNK, BC_STRIP_RANKS = 256, 8192, 8
# bench.py's toeplitz workload: linspace x on [-pi, pi], y = sin(50 x) +
# 0.1 eps, SE with h = 1 and w = max(100 * 2 pi / N, 1e-4), noise 0.1,
# jitter 1e-4, 8 probes, tol 1e-6; (N, iterations)
TOEPLITZ_RUNS = ((65536, 150), (1 << 20, 200))
# the float32 lml against the float64 run of the same path on the card with
# the same draws on the float32 run's own grid: the SLQ quadrature and
# y^T alpha in float32 at |lml| ~ 1e5..1e6 (an H100 measured 9e-7 at 65536
# and 1.1e-5 at 2^20).  The true residual takes ITER_RESIDUAL, the float64
# operator being the float32 run's own (its grid cast up): a float64 grid's
# spacing differs from the float32 grid's by up to 2% at 2^20
TOEPLITZ_LML_REL = 1e-4
# the stochastic gradient at N=65536, float32 against float64 with the same
# draws: the limit of the exact path's float32 gradient (GRAD_REL)
TOEPLITZ_GRAD_REL = 2e-2
# bench.py's whittle workload (SE, h = 1, w = 0.006 at N = 2^20, prior sd
# 1, jitter 1e-6; 16 chains jittered by 0.01 around the prior mean), the
# quasi-periodic SE x periodic spectrum for one chain, and the 2-D torus at
# 1024^2 (ARD-SE, w = (0.01, 0.01), y = sin(2 pi 20 g1) cos(2 pi 13 g2) + 0.1 eps)
WHITTLE_N, WHITTLE_2D, WHITTLE_CHAINS = 1 << 20, 1024, 16
WHITTLE_QP = ((1.0, 2.0), (1.0, 1.0, 0.5))
# float32 against float64 on the card (the float32 problem cast up), per
# chain: the centered value's absolute error in nats (a sum of 2^19 per-bin
# float32 differences; an H100 measured 0.14) and the gradient's relative
# error in norm (measured 6e-5)
WHITTLE_VALUE_NATS, WHITTLE_GRAD_REL = 0.5, 1e-3
# bayes-grid (a): benchmarks/demo_bayes1m.py's settings, against the
# committed reference draws (13,000 x 16 ChEES draws of u = log(h, w, s))
BAYES_REF = "benchmarks/bayes1m_r5_accept.npz"
BAYES_PRIOR_A, BAYES_PRIOR_B = (0.7, 0.04, 0.1), (1.0, 0.006, 0.1)
# (a) is cut from the demo's 400 + 400 (36.0 s) to 200 + 200 and then to
# 150 + 150 (a mass-matrix window stays) to make room for config #5; its
# gates stay
BAYES_WARMUP, BAYES_SAMPLES, BAYES_RHAT, BAYES_SE = 150, 150, 1.05, 4.0
# the float64 Whittle posterior on the card by a product grid over u, this
# many points per axis within this many of (a)'s posterior standard
# deviations of (a)'s mean; the mass left on the grid's faces is printed
BAYES_QUAD_POINTS, BAYES_QUAD_HALF, BAYES_QUAD_EDGE = 17, 6.0, 1e-4
# The reference's noise mean 0.100147 lies ~113 of its Monte-Carlo standard
# errors (one posterior sd) above the float64 quadrature of the same
# posterior on an H100, which the port's float32 run meets: s is held to
# the quadrature, h and w to the reference as well.
# (b): the config's grid is built from x_lo = -3.14159265, whose float32
# points put dx = x[1] - x[0] at 6.1989e-6 against 5.9605e-6 for (a)'s
# (the true spacing is 5.9921e-6).  The SE spectrum depends on w only as
# w / dx, so the reference's draws carry over to (b)'s likelihood with w
# scaled by the ratio of the two dx, then reweighted by the prior ratio
BAYES_RHAT_B = 1.05
# bench.py's ski workload: N = 65536 sorted uniform x (seed 3), m = 16384,
# 300 iterations, pivoted-Cholesky rank 2048, tol 1e-6, run twice
SKI_N, SKI_M, SKI_ITERS, SKI_RANK = 65536, 16384, 300, 2048
# the scatter W^T V on clustered inputs (3/4 of SKI_N points within one grid
# cell, r = 9 columns, as the fit's [y, probes]): two calls bit-identical,
# and against float64 within sqrt(taps on the busiest grid point) u ~ 1.3e-5
# (a sequential float32 sum of ~5e4 terms) with a factor 8
SKI_CLUSTER_R, SKI_CLUSTER_REL = 9, 1e-4
# bench.py's ski_refine workload: n = 16384 in [-1, 1]^2 (seed 7), 64^2 grid,
# ARD w = (0.15, 0.15), rank 256, 150 iterations, one refinement round.
# The limit is set from the card: the float32 fit's residual 5.2e-5 went to
# 1.6e-8 in one round on an H100 (the float32 correction solve to the
# adaptive tolerance 1e-7 bounds what one round can reach, ~rel * 1e-4)
SKI_REF_N, SKI_REF_M1, SKI_REF_RANK, SKI_REF_ITERS = 16384, 64, 256, 150
SKI_REF_RESIDUAL = 1e-7


class Float64Draws:
    """The matrix-free path's draws from a seeded CPU generator, taken in
    float64 and cast, so that a float32 and a float64 run see the same
    numbers (to the cast)."""

    def __init__(self, seed_):
        import torch

        self.generator = torch.Generator().manual_seed(seed_)

    def rademacher(self, shape, dtype, device):
        import torch

        bits = torch.randint(0, 2, shape, generator=self.generator)
        return (2 * bits - 1).to(dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        import torch

        return torch.randn(shape, generator=self.generator, dtype=torch.float64).to(
            dtype=dtype, device=device)

    def uniform(self, shape, dtype, device):
        import torch

        return torch.rand(shape, generator=self.generator, dtype=torch.float64).to(
            dtype=dtype, device=device)


def synced_wall(fn):
    """(result, seconds) of ``fn()`` on the host clock, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peak_gb(fn):
    """(result, peak device memory in GB) of ``fn()``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def profile_top(fn, top: int = 8) -> list:
    """Device time of one call of ``fn()`` by kernel name, from
    ``torch.profiler``'s CUDA kernel events: [(name, ms, launches)], largest
    first, with the total first."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = rows.get(ev.name, (0.0, 0))
            rows[ev.name] = (ms + ev.device_time / 1e3, count + 1)
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
    total = sum(ms for ms, _ in rows.values())
    return [("total", total, sum(c for _, c in rows.values()))] + [
        (name[:90], ms, count) for name, (ms, count) in ranked[:top]]


def profile_wall(fn):
    """(host wall of one warm call in ms, ``profile_top`` of another)."""
    fn()
    _, wall = synced_wall(fn)
    return wall * 1e3, profile_top(fn)


def print_profile(label, rows):
    print(f"  profile, {label}: {rows[0][1]:.3f} ms of device time in {rows[0][2]} kernels",
          flush=True)
    for name, ms, count in rows[1:]:
        print(f"    {ms:9.3f} ms {count:6d}x {name}", flush=True)


def run_fit_large_twin_path(dev) -> dict:
    """The single-card ``fit`` on config #4's data at N=65536, one warm call
    for its wall and peak memory: the lml that the block-cyclic fit is held
    to."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    cfg = CONFIGS["config4_large_n"]
    x, y, _ = (torch.as_tensor(a, device=dev) for a in make_data(cfg.data, "float32"))
    k = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float32, device=dev)
    noise, jitter = cfg.fit.noise, cfg.fit.jitter
    gpx.fit(k, x, y, noise, jitter)
    (twin, wall), peak = peak_gb(lambda: synced_wall(lambda: gpx.fit(k, x, y, noise, jitter)))
    return dict(x=x, y=y, k=k, lml=float(twin.log_marginal), fit_wall_s=wall, fit_peak_gb=peak,
                noise=noise, jitter=jitter)


def run_fit_large_path(dev) -> dict:
    """Config #4 through the CLI at N=65536 (fit_large: fit_blockcyclic over
    the process group, here one rank).  A spy on the library's entry points
    counts the CLI's block-cyclic fits and predictions and keeps the alpha
    of its last fit, the one its predictions use."""
    from gaussian_processes_tpu_torch import cli, parallel
    from gaussian_processes_tpu_torch.utils import CONFIGS

    out = {"fits": 0, "predictions": 0}
    fit, predict = parallel.fit_blockcyclic, parallel.predict_diag_blockcyclic

    def fit_spy(*args, **kwargs):
        post = fit(*args, **kwargs)
        out.update(fits=out["fits"] + 1, alpha=post.alpha, world_size=post.world_size)
        return post

    def predict_spy(*args, **kwargs):
        out["predictions"] += 1
        return predict(*args, **kwargs)

    with _swap(parallel, "fit_blockcyclic", fit_spy), \
            _swap(parallel, "predict_diag_blockcyclic", predict_spy):
        out["cli"] = cli.run_config(CONFIGS["config4_large_n"], device=dev)
    return out


def check_fit_large_path(check, twin, out, launches, dev) -> dict:
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.models import iterative_gp
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("fit-large (config #4, float32, fit_blockcyclic over the process group):", flush=True)
    s = out["cli"]
    x, y, k, alpha = twin["x"], twin["y"], twin["k"], out["alpha"]
    noise, jitter = twin["noise"], twin["jitter"]
    n = x.shape[0]
    # the block-cyclic calls alone launch B1 in that window: one strip a
    # fit, one K(xo, x) a prediction
    calls = out["fits"] + out["predictions"]
    print(f"  the CLI made {out['fits']} block-cyclic fits and {out['predictions']} "
          f"predictions; B1 launched {launches.get('pairwise_k', 0)} times, B3 "
          f"{launches.get('chol_tile', 0)}", flush=True)
    check("fit-large: block-cyclic fits + predictions - B1 launches (<= 0: one strip a fit)",
          calls - launches.get("pairwise_k", 0), 0.0)
    check("fit-large: block-cyclic fits made by the CLI, 1 - count (<= 0: at least one)",
          1.0 - out["fits"], 0.0)
    lml_rel = abs(s["log_marginal"] - twin["lml"]) / abs(twin["lml"])
    print(f"  N={n}, W={out['world_size']} ({s['mesh']}), block {s['block_size']}: cli "
          f"fit_wall_s {s['fit_wall_s']:.4f} s (best of 2 after a warm-up) against the "
          f"single-card fit's {twin['fit_wall_s']:.4f} s; peak memory {s['peak_memory_gb']:.2f} "
          f"GB against {twin['fit_peak_gb']:.2f}; lml {s['log_marginal']:.4f} against "
          f"{twin['lml']:.4f} (rel {lml_rel:.3e}); rmse {s['pred_rmse_vs_truth']:.5f}",
          flush=True)
    check(f"fit-large N={n} rmse vs sin(2x)", s["pred_rmse_vs_truth"], FIT_RMSE)
    check(f"fit-large N={n} peak memory (GB, 1.25 x one float32 strip)", s["peak_memory_gb"],
          FIT_LARGE_PEAK_GB)
    check(f"fit-large N={n} lml vs the single-card fit's (relative)", lml_rel, FIT_LARGE_LML_REL)
    # ||A||_2 by power iteration (B4, float32); the residual by B4 in float64
    v = torch.ones(n, device=dev) / math.sqrt(n)
    for _ in range(FIT_LARGE_POWER_ITERS):
        v = pw.kernel_matvec_fused(k, x, v, noise, jitter)
        lam = float(torch.linalg.norm(v))
        v = v / lam
    k64 = k.with_params(k.params.double())
    a64, y64 = alpha.double(), y.double()
    r = pw.kernel_matvec_fused(k64, x.double(), a64, noise, jitter) - y64
    rn, yn, an = (float(torch.linalg.norm(t)) for t in (r, y64, a64))
    omega = rn / (lam * an + yn)
    print(f"  true residual (B4, float64): ||r|| / ||y|| = {rn / yn:.3e}; ||A||_2 ~ {lam:.1f}, "
          f"||alpha|| = {an:.4e}, backward error {omega:.3e}", flush=True)
    check(f"fit-large N={n} true residual ||r|| / ||y|| (B4, float64)", rn / yn,
          FIT_LARGE_RESIDUAL)
    finite = bool(np.isfinite(s["log_marginal"]))
    check(f"fit-large N={n} lml finite (0 = yes)", 0.0 if finite else 1.0, 0.0)
    # the dense/iterative crossover on config #4's data: the exact fit and
    # fit_iterative's estimate (SLQ standard error from its probes) for the
    # kernel of config #4 (w = 1) and for the matrix-free workload's (w =
    # 100 * 2 pi / N).  At w = 1 the damped Woodbury shift (1.5e3 eps
    # lam_max ~ 4.6 against s^2 + jitter = 0.0101) leaves the preconditioned
    # SLQ an error of ~2e5 nats, so the gate is at the workload's kernel
    summary = {"fit_wall_s": s["fit_wall_s"], "peak_memory_gb": s["peak_memory_gb"],
               "lml": s["log_marginal"], "backward_error": omega, "relative_residual": rn / yn,
               "mesh": s["mesh"], "block_size": s["block_size"], "lml_rel_to_fit": lml_rel,
               "fit_twin_wall_s": twin["fit_wall_s"], "fit_twin_peak_gb": twin["fit_peak_gb"]}
    for label, kern, lml_dense in (
            ("w=1", k, twin["lml"]),
            ("w=100*2pi/N", k.with_params(torch.tensor([1.0, 100 * 2 * math.pi / n], device=dev)),
             None)):
        if lml_dense is None:
            (lml_dense, dense_s) = synced_wall(
                lambda: float(gpx.fit(kern, x, y, noise, jitter).log_marginal))
        else:
            dense_s = twin["fit_wall_s"]
        est, wall = synced_wall(lambda: iterative_gp.log_marginal_estimate_iterative(
            kern, x, y, noise, Float64Draws(40), **ITER_OPTS))
        terms = est.logdet_terms.double().cpu().numpy()
        se = 0.5 * terms.std(ddof=1) / math.sqrt(terms.size)
        lml_it = float(est.lml)
        print(f"  {label}: dense fit {dense_s:.3f} s, lml {lml_dense:.4f}; fit_iterative's "
              f"value+grad {wall:.3f} s, lml {lml_it:.4f} +- {se:.4f} (SLQ standard error): "
              f"{abs(lml_dense - lml_it) / se:.2f} standard errors apart", flush=True)
        summary[label] = {"dense_lml": lml_dense, "dense_s": dense_s, "iterative_lml": lml_it,
                          "iterative_se": se, "iterative_s": wall}
    check(f"fit-large N={n} dense lml vs fit_iterative, w = 100*2pi/N (standard errors)",
          abs(summary["w=100*2pi/N"]["dense_lml"] - summary["w=100*2pi/N"]["iterative_lml"])
          / summary["w=100*2pi/N"]["iterative_se"], ITER_SE)
    return summary


def toeplitz_problem(n, dev, dtype_name="float32"):
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    rng = np.random.default_rng(0)
    x = np.linspace(-np.pi, np.pi, n)
    y = np.sin(50 * x) + 0.1 * rng.standard_normal(n)
    dtype = getattr(torch, dtype_name)
    k = gpx.GaussianKernel(1.0, max(100.0 * 2 * np.pi / n, 1e-4), dtype=dtype, device=dev)
    return (torch.as_tensor(x, dtype=dtype, device=dev),
            torch.as_tensor(y, dtype=dtype, device=dev), k)


TOEPLITZ_OPTS = dict(num_probes=8, tol=1e-6, jitter=1e-4, structure="toeplitz")


def run_toeplitz_path(dev) -> dict:
    """bench.py's toeplitz workload: ``fit_iterative(structure="toeplitz")``
    at N=65536 and 2^20, twice each (the second warm), and the stochastic
    gradient at N=65536 (the Jacobian columns from B2a at (P, n, 1))."""
    import gaussian_processes_tpu_torch as gpx

    out = {}
    for n, iters in TOEPLITZ_RUNS:
        x, y, k = toeplitz_problem(n, dev)
        for wall in ("first_s", "wall_s"):
            post, out[f"{n}_{wall}"] = synced_wall(lambda: gpx.fit_iterative(
                k, x, y, 0.1, Float64Draws(50), num_iters=iters, **TOEPLITZ_OPTS))
        out[n] = (x, y, k, post)
    n, iters = TOEPLITZ_RUNS[0]
    x, y, k, _ = out[n]
    out["grad"], out["grad_s"] = synced_wall(lambda: gpx.log_marginal_value_and_grad_iterative(
        k, x, y, 0.1, Float64Draws(51), num_iters=iters, **TOEPLITZ_OPTS))
    return out


def check_toeplitz_path(check, out, dev, rows) -> dict:
    """The Toeplitz fits and gradient against the same path in float64 on
    the card; B1's grid column and B2a's Jacobian columns at N=2^20 against
    their plain versions, timed, into ``rows`` (the kernels' line)."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.ops import toeplitz

    print("toeplitz (float32) vs float64 on the card:", flush=True)
    summary = {}
    for n, iters in TOEPLITZ_RUNS:
        x, y, k, post = out[n]
        # the float32 run's own grid, data and parameters in float64: its
        # operator, without the float32 rounding of the column and the FFTs
        x64, y64, k64 = x.double(), y.double(), k.with_params(k.params.double())
        col64 = toeplitz.toeplitz_column(k64, x64)
        shift = 0.1 ** 2 + 1e-4
        a64 = post.alpha.double()
        r = toeplitz.toeplitz_matvec(col64, a64, shift) - y64
        res = float(torch.linalg.norm(r) / torch.linalg.norm(y64))
        # ||A||_2 <= max |spectrum of the circulant embedding| + shift
        norm_a = float(torch.max(torch.abs(toeplitz._embed_fft(col64)))) + shift
        omega = float(torch.linalg.norm(r)) / (norm_a * float(torch.linalg.norm(a64))
                                               + float(torch.linalg.norm(y64)))
        p64 = gpx.fit_iterative(k64, x64, y64, 0.1, Float64Draws(50), num_iters=iters,
                                **TOEPLITZ_OPTS)
        lml, lml64 = float(post.log_marginal), float(p64.log_marginal)
        col_ms = time_ms(lambda: toeplitz.toeplitz_column(k, x), 50)
        print(f"  N={n} ({iters} iterations, w = {float(k.w):.3e}): fit {out[f'{n}_wall_s']:.4f} s "
              f"(first {out[f'{n}_first_s']:.4f} s), recurrence residual "
              f"{float(post.solve_residual):.3e}, true residual (f64) {res:.3e}, lml {lml:.4f} "
              f"(f64 {lml64:.4f}); backward error {omega:.3e}; B1 column (n x 1) "
              f"{col_ms * 1e3:.2f} us", flush=True)
        check(f"toeplitz N={n} true relative residual (f64)", res, ITER_RESIDUAL)
        check(f"toeplitz N={n} lml rel vs the float64 path", abs(lml - lml64) / abs(lml64),
              TOEPLITZ_LML_REL)
        summary[n] = {"wall_s": out[f"{n}_wall_s"], "first_s": out[f"{n}_first_s"],
                      "residual": res, "backward_error": omega, "lml": lml, "lml64": lml64,
                      "column_ms": col_ms}
    n, iters = TOEPLITZ_RUNS[0]
    x, y, k, _ = out[n]
    lml, grad = out["grad"]
    lml64, grad64 = gpx.log_marginal_value_and_grad_iterative(
        k.with_params(k.params.double()), x.double(), y.double(), 0.1, Float64Draws(51),
        num_iters=iters, **TOEPLITZ_OPTS)
    gerr = float((grad.double() - grad64).norm() / grad64.norm())
    print(f"  N={n} value+grad {out['grad_s']:.4f} s: lml {float(lml):.4f} (f64 "
          f"{float(lml64):.4f}), grad {grad.tolist()} (f64 {grad64.tolist()})", flush=True)
    check(f"toeplitz N={n} value+grad lml rel vs the float64 path",
          abs(float(lml) - float(lml64)) / abs(float(lml64)), TOEPLITZ_LML_REL)
    check(f"toeplitz N={n} gradient rel (norm) vs the float64 path", gerr, TOEPLITZ_GRAD_REL)
    summary["grad"] = {"wall_s": out["grad_s"], "grad_rel": gerr}
    # B1's (n, 1) grid column and B2a's (P, n, 1) Jacobian columns at 2^20
    n, iters = TOEPLITZ_RUNS[-1]
    x, y, k, _ = out[n]
    x0 = x[:1]
    for key, label, kern_fn, plain_fn, ops, nbytes in (
            ("pairwise_k_grid_column", f"B1 grid column {n}x1",
             lambda: pw.pairwise_matrix(k, x, x0), lambda: pw.pairwise_matrix_folded(k, x, x0),
             SE_K_OPS * n, 4 * (1 + 2 * n)),
            ("pairwise_jac_grid_column", f"B2a Jacobian columns 2x{n}x1",
             lambda: pw.pairwise_jacobian(k, x, x0),
             lambda: pw.pairwise_jacobian_reference(k, x, x0),
             SE_JAC_OPS * n, 4 * (1 + n + 2 * n))):
        got, want = kern_fn(), plain_fn()
        err, ratio = plane_violation(got, want, "float32")
        rows[key] = {"max_abs_err": err, "ms": time_ms(kern_fn, 50),
                     "plain_ms": time_ms(plain_fn, 10), **bound(ops, nbytes), "library_ms": None}
        print(f"  {label}: kernel {rows[key]['ms'] * 1e3:.2f} us, plain "
              f"{rows[key]['plain_ms'] * 1e3:.2f} us, bound {rows[key]['bound_ms'] * 1e3:.2f} us "
              f"({rows[key]['bound_by']}), max abs err {err:.3e}", flush=True)
        check(f"{label} vs plain (error / allowance)", ratio, 1.0)
    prof = profile_top(lambda: gpx.fit_iterative(k, x, y, 0.1, Float64Draws(50),
                                                 num_iters=iters, **TOEPLITZ_OPTS))
    print_profile(f"one Toeplitz fit at N={n}", prof)
    summary["profile"] = prof
    return summary


def whittle_problem(dev, dtype_name="float32"):
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    n = WHITTLE_N
    rng = np.random.default_rng(1)
    x = np.arange(n) * (2 * np.pi / n) - np.pi
    y = np.sin(50 * x) + 0.1 * rng.standard_normal(n)
    dtype = getattr(torch, dtype_name)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    k = gpx.GaussianKernel(1.0, 0.006, dtype=dtype, device=dev)
    qp = gpx.ProductKernel(gpx.GaussianKernel(*WHITTLE_QP[0], dtype=dtype, device=dev),
                           gpx.PeriodicKernel(*WHITTLE_QP[1], dtype=dtype, device=dev))
    m = WHITTLE_2D
    g = np.arange(m) / m
    G1, G2 = np.meshgrid(g, g, indexing="ij")
    y2 = (np.sin(2 * np.pi * 20 * G1) * np.cos(2 * np.pi * 13 * G2)
          + 0.1 * rng.standard_normal((m, m))).reshape(-1)
    k2 = gpx.ARDGaussianKernel(1.0, torch.tensor([0.01, 0.01]), dtype=dtype, device=dev)
    return t(x), t(y), k, qp, t(g), t(y2), k2


def whittle_densities(dev, dtype_name):
    """The densities on the float32 problem; for "float64" the same grids,
    data and parameters cast up (the float32 grid's own spacing)."""
    import numpy as np
    import torch
    from gaussian_processes_tpu_torch.inference import (
        make_log_posterior_whittle,
        make_log_posterior_whittle_kron,
    )
    from gaussian_processes_tpu_torch.ops.kronecker import KronOperator

    dtype = getattr(torch, dtype_name)
    x, y, k, qp, g, y2, k2 = (a.to(dtype) for a in whittle_problem(dev, "float32"))
    def u32(*theta):  # positions rounded to float32 first, as the float32 run has them
        return torch.log(torch.tensor(theta, device=dev)).to(dtype)

    u0, uq, u2 = u32(1.0, 0.006, 0.1), u32(*WHITTLE_QP[0], *WHITTLE_QP[1], 0.1), u32(
        1.0, 0.01, 0.01, 0.1)
    eps = np.random.default_rng(2).standard_normal((WHITTLE_CHAINS, 4))

    def chains(u):
        return (u[None].float() + 0.01 * torch.as_tensor(eps[:, :u.shape[0]], dtype=torch.float32,
                                                          device=dev)).to(dtype)

    lp = make_log_posterior_whittle(k, x, y, prior_mean=u0, prior_std=1.0, jitter=1e-6)
    lq = make_log_posterior_whittle(qp, x, y, prior_mean=uq, prior_std=1.0, jitter=1e-6)
    l2 = make_log_posterior_whittle_kron(k2, KronOperator(axes=(g, g)), y2, prior_mean=u2,
                                         prior_std=1.0, jitter=1e-6)
    return {"se_1": (lp, u0), f"se_{WHITTLE_CHAINS}": (lp, chains(u0)), "qp_1": (lq, uq),
            "2d_1": (l2, u2), f"2d_{WHITTLE_CHAINS}": (l2, chains(u2))}


def run_whittle_path(dev) -> dict:
    """The Whittle posteriors' value+grad at N=2^20 (1 and 16 chains, and
    the quasi-periodic spectrum for one chain) and on the 1024^2 torus."""
    out = {}
    for name, (lp, u) in whittle_densities(dev, "float32").items():
        out[name], out[f"{name}_peak_gb"] = peak_gb(lambda: lp.value_and_grad(u))
        out[f"{name}_ms"] = time_ms(lambda: lp.value_and_grad(u), 3 if "qp" in name else 20)
    return out


def check_whittle_path(check, out, dev) -> dict:
    print("whittle (float32) vs float64 on the card:", flush=True)
    summary = {}
    dens64 = whittle_densities(dev, "float64")
    for name, (lp64, u64) in dens64.items():
        v32, g32 = out[name]
        v64, g64 = lp64.value_and_grad(u64)
        verr = float((v32.double() - v64).abs().max())
        gerr = float(((g32.double() - g64).norm(dim=-1) / g64.norm(dim=-1)).max())
        print(f"  {name}: value+grad {out[f'{name}_ms']:.3f} ms per batched evaluation, peak "
              f"{out[f'{name}_peak_gb']:.2f} GB; value {float(v32.reshape(-1)[0]):.4f} "
              f"(f64 {float(v64.reshape(-1)[0]):.4f})", flush=True)
        check(f"whittle {name} value abs error vs f64 (nats)", verr, WHITTLE_VALUE_NATS)
        check(f"whittle {name} grad rel error vs f64 (norm, worst chain)", gerr, WHITTLE_GRAD_REL)
        check(f"whittle {name} peak memory (GB, of 80)", out[f"{name}_peak_gb"], 80.0)
        summary[name] = {"ms": out[f"{name}_ms"], "peak_gb": out[f"{name}_peak_gb"],
                         "value_err": verr, "grad_rel": gerr}
    lp, u = whittle_densities(dev, "float32")[f"se_{WHITTLE_CHAINS}"]
    rows = profile_top(lambda: lp.value_and_grad(u))
    print_profile(f"one {WHITTLE_CHAINS}-chain Whittle value+grad at N={WHITTLE_N}", rows)
    summary["profile"] = rows
    return summary


def bayes_problem(dev):
    """benchmarks/demo_bayes1m.py's data: the endpoint-exclusive grid of
    2^20 points on [-pi, pi), y = sin(50 x) + 0.1 eps (seed 0), float32."""
    import numpy as np
    import torch

    n = 1 << 20
    rng = np.random.default_rng(0)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(np.float32)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


def run_bayes_grid_path(dev, warmup=BAYES_WARMUP, samples=BAYES_SAMPLES, cli_draws=None) -> dict:
    """(a) ChEES on the Whittle posterior at demo_bayes1m.py's settings
    through the library; (b) the CLI's grid1m_bayes_whittle."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch import cli
    from gaussian_processes_tpu_torch.inference import (
        init_positions,
        make_log_posterior_whittle,
        sample_chees,
    )
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    x, y = bayes_problem(dev)
    k0 = gpx.GaussianKernel(*BAYES_PRIOR_A[:2], dtype=torch.float32, device=dev)
    u0 = torch.log(torch.tensor(BAYES_PRIOR_A, device=dev))
    lp = make_log_posterior_whittle(k0, x, y, prior_mean=u0, prior_std=1.0, jitter=1e-6)
    gen = torch.Generator(device=dev).manual_seed(0)
    init = init_positions(k0, BAYES_PRIOR_A[2], gen, n_chains=16, spread=0.01)
    res, wall = synced_wall(lambda: sample_chees(
        lp, init, gen, num_warmup=warmup, num_samples=samples, init_step_size=0.005,
        init_traj_length=0.1, max_leapfrog=128))
    cfg = CONFIGS["grid1m_bayes_whittle"]
    if cli_draws is not None:
        cfg = dataclasses.replace(cfg, nuts=dataclasses.replace(
            cfg.nuts, num_warmup=cli_draws[0], num_samples=cli_draws[1]))
    xb, yb, _ = make_data(cfg.data, "float32")
    return {"a": (res, wall, warmup, samples), "b": cli.run_config(cfg, device=dev),
            "b_draws": (cfg.nuts.num_warmup, cfg.nuts.num_samples), "data": (x, y),
            "b_data": (torch.as_tensor(xb, device=dev), torch.as_tensor(yb, device=dev))}


def reference_draws():
    """The committed reference: positions (13000, 16, 3) in u-space."""
    import numpy as np
    from pathlib import Path

    return np.load(Path(__file__).resolve().parent / BAYES_REF)["positions"].astype(np.float64)


def mean_and_se(theta):
    """Posterior mean of (S, C, D) draws and its Monte-Carlo standard error
    sd / sqrt(ESS)."""
    import numpy as np
    from gaussian_processes_tpu_torch.inference.diagnostics import ess

    flat = theta.reshape(-1, theta.shape[-1])
    return flat.mean(0), flat.std(0) / np.sqrt(ess(theta))


def whittle_lml_nodes64(x, y, hw, s):
    """The float64 Whittle log-likelihood of (x, y) under the SE kernel with
    jitter 1e-6 (as ``toeplitz.whittle_log_marginal``), at each (h, w) row of
    ``hw`` (Q, 2) and each noise of ``s`` (S,): (Q, S).  The kernel part of
    the spectrum is computed once per (h, w) node; the noise enters every bin
    additively."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import toeplitz

    f64 = torch.float64
    x64, y64, hw = x.double(), y.double(), hw.to(f64)
    n = x64.shape[0]
    kern = gpx.GaussianKernel(1.0, 1.0, dtype=f64, device=x.device)
    with torch.no_grad():
        lam_k = toeplitz.whittle_spectrum_params(kern, hw, hw.new_zeros((hw.shape[0], 1)), x64)
        mult = toeplitz._rfft_multiplicity(n, f64, x.device)
        p_y = toeplitz.periodogram(y64) / n
        return torch.stack([-0.5 * torch.sum(mult * (p_y / lam + torch.log(lam)), dim=-1)
                            for lam in (lam_k + (torch.square(si) + 1e-6) for si in s.to(f64))],
                           dim=-1) - 0.5 * n * math.log(2.0 * math.pi)


def whittle_quadrature64(x, y, prior_means, center, sd):
    """Posterior means of theta = exp(u), u = log(h, w, s), under the float64
    Whittle posterior of (x, y) with each of ``prior_means`` (prior sd 1), by
    a product grid over u (BAYES_QUAD_POINTS per axis within
    BAYES_QUAD_HALF ``sd`` of ``center``): a list of (means (3,), mass on
    the grid's faces).  The likelihood is ``whittle_lml_nodes64``, which
    tests/test_torch_whittle.py holds to the JAX package's
    ``whittle_log_marginal`` at N=2^20 on this data."""
    import numpy as np
    import torch

    dev, f64 = x.device, torch.float64
    steps = np.linspace(-BAYES_QUAD_HALF, BAYES_QUAD_HALF, BAYES_QUAD_POINTS)
    axes = [torch.tensor(center[i] + sd[i] * steps, dtype=f64, device=dev) for i in range(3)]
    U = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)  # (P, P, P, 3)
    hw = torch.exp(U[:, :, 0, :2].reshape(-1, 2))
    lml = whittle_lml_nodes64(x, y, hw, torch.exp(axes[2])).reshape(U.shape[:3])
    out = []
    for mu in prior_means:
        lp = lml - 0.5 * torch.sum((U - torch.as_tensor(mu, dtype=f64, device=dev)) ** 2, -1)
        p = torch.exp(lp - lp.max())
        p = p / p.sum()
        inner = p[1:-1, 1:-1, 1:-1].sum()
        out.append((torch.einsum("abc,abcd->d", p, torch.exp(U)).cpu().numpy(),
                    float(1.0 - inner)))
    return out


def check_bayes_grid_path(check, out) -> dict:
    import numpy as np
    from gaussian_processes_tpu_torch.inference.diagnostics import ess, split_rhat

    print("bayes-grid (float32, N=2^20, 16 chains):", flush=True)
    ref_u = reference_draws()
    ref_theta = np.exp(ref_u)
    ref_mean, ref_se = mean_and_se(ref_theta)
    res, wall, warmup, samples = out["a"]
    u = res.positions.double().cpu().numpy()
    theta = np.exp(u)
    mean, se = mean_and_se(theta)
    rhat = float(split_rhat(u).max())
    frozen = int(np.sum(u.std(0).max(-1) < 1e-6))
    lf = res.num_leapfrog.double()
    e = ess(u)
    print(f"  (a) demo_bayes1m settings, {warmup} + {samples} draws: {wall:.1f} s, "
          f"{samples * 16 / wall:.1f} samples/s (with warmup), min ESS {e.min():.0f} "
          f"({e.min() / wall:.2f} ESS/s), mean leapfrog {float(lf.mean()):.2f} (collection), "
          f"step {float(res.step_size):.3e}, T {float(res.traj_length):.3e}, accept "
          f"{float(res.accept_prob.double().mean()):.3f}", flush=True)
    print(f"      mean (h, w, s) {np.array2string(mean, precision=6)} +- "
          f"{np.array2string(se, precision=6)}; reference {np.array2string(ref_mean, precision=6)}"
          f" +- {np.array2string(ref_se, precision=6)}", flush=True)
    check("bayes-grid (a) max split R-hat", rhat, BAYES_RHAT)
    check("bayes-grid (a) frozen chains", float(frozen), 0.0)
    check("bayes-grid (a) non-finite draws", float(np.sum(~np.isfinite(u))), 0.0)
    flat_u = u.reshape(-1, 3)
    x, y = out["data"]
    ((quad_a, edge_a),) = whittle_quadrature64(x, y, (np.log(BAYES_PRIOR_A),), flat_u.mean(0),
                                               flat_u.std(0))
    print(f"      float64 quadrature {np.array2string(quad_a, precision=6)} (mass on the grid's "
          f"faces {edge_a:.1e}); reference minus quadrature in its own MC SE "
          f"{np.array2string((ref_mean - quad_a) / ref_se, precision=2)}", flush=True)
    check("bayes-grid (a) quadrature mass on the grid's faces", edge_a, BAYES_QUAD_EDGE)
    z = np.abs(mean - ref_mean) / np.sqrt(se ** 2 + ref_se ** 2)
    for name, zi in zip("hw", z):
        check(f"bayes-grid (a) posterior mean {name} vs reference (combined MC SE)", float(zi),
              BAYES_SE)
    zq = np.abs(mean - quad_a) / se
    for name, zi in zip("hws", zq):
        check(f"bayes-grid (a) posterior mean {name} vs float64 quadrature (MC SE)", float(zi),
              BAYES_SE)
    # (b): the config's prior mean log(1, 0.006, 0.1) against the reference's
    # log(0.7, 0.04, 0.1), both sd 1, and its grid's float32 spacing: the
    # reference mapped to (b)'s dx and reweighted by the prior ratio
    b = out["b"]
    xb, yb = out["b_data"]
    dx_a, dx_b = float(x[1] - x[0]), float(xb[1] - xb[0])
    mu_a, mu_b = np.log(BAYES_PRIOR_A), np.log(BAYES_PRIOR_B)
    ref_ub = ref_u + np.array([0.0, math.log(dx_b / dx_a), 0.0])
    logw = (-0.5 * np.sum((ref_ub - mu_b) ** 2, -1) + 0.5 * np.sum((ref_u - mu_a) ** 2, -1))
    wts = np.exp(logw - logw.max()).reshape(-1)
    wts /= wts.sum()
    ref_theta_b = np.exp(ref_ub)
    flat = ref_theta_b.reshape(-1, 3)
    rw_mean = wts @ flat
    # the weights' own efficiency (Kish) on top of the chains' autocorrelation
    kish = 1.0 / np.sum(wts ** 2) / wts.size
    rw_se = np.sqrt(wts @ (flat - rw_mean) ** 2) / np.sqrt(ess(ref_theta_b) * kish)
    b_u = np.log(np.array(b["posterior_mean"]))
    ((quad_b, edge_b),) = whittle_quadrature64(
        xb, yb, (mu_b,), b_u, np.array(b["diagnostics"]["sd"]))
    b_mean, b_se = np.array(b["posterior_mean"]), np.array(b["posterior_mean_se"])
    d = b["diagnostics"]
    print(f"  (b) CLI grid1m_bayes_whittle, {out['b_draws'][0]} + {out['b_draws'][1]} draws: "
          f"{b['wall_s']:.1f} s, {b['samples_per_s']:.1f} samples/s, max R-hat "
          f"{d['max_rhat']:.4f}, min ESS {d['min_ess']:.0f} ({d['ess_per_s']:.2f} ESS/s), mean "
          f"leapfrog {b['mean_leapfrog']:.2f}, step {b['step_size']:.3e}, accept "
          f"{b['accept_rate']:.3f}", flush=True)
    print(f"      mean {np.array2string(b_mean, precision=6)} +- "
          f"{np.array2string(b_se, precision=6)}; the reference at dx {dx_b:.4e} (not "
          f"{dx_a:.4e}), reweighted {np.array2string(rw_mean, precision=6)} +- "
          f"{np.array2string(rw_se, precision=6)}; float64 quadrature of (b)'s posterior "
          f"{np.array2string(quad_b, precision=6)} (faces {edge_b:.1e})", flush=True)
    check("bayes-grid (b) draws finite (0 = yes)", 0.0 if b["draws_finite"] else 1.0, 0.0)
    fields = {"posterior_mean", "posterior_mean_se", "samples_per_s", "mean_leapfrog",
              "step_size", "diagnostics", "wall_s"}
    check("bayes-grid (b) summary fields missing", float(len(fields - set(b))), 0.0)
    check("bayes-grid (b) max split R-hat", d["max_rhat"], BAYES_RHAT_B)
    check("bayes-grid (b) quadrature mass on the grid's faces", edge_b, BAYES_QUAD_EDGE)
    zb = np.abs(b_mean - rw_mean) / np.sqrt(b_se ** 2 + rw_se ** 2)
    for name, zi in zip("hw", zb):
        check(f"bayes-grid (b) posterior mean {name} vs the reweighted reference "
              "(combined MC SE)", float(zi), BAYES_SE)
    zbq = np.abs(b_mean - quad_b) / b_se
    for name, zi in zip("hws", zbq):
        check(f"bayes-grid (b) posterior mean {name} vs float64 quadrature (MC SE)", float(zi),
              BAYES_SE)
    return {"a": {"wall_s": wall, "samples_per_s": samples * 16 / wall,
                  "ess_per_s": float(e.min() / wall), "max_rhat": rhat,
                  "mean_leapfrog": float(lf.mean()), "step_size": float(res.step_size),
                  "traj_length": float(res.traj_length), "posterior_mean": mean.tolist(),
                  "quadrature": quad_a.tolist(), "z_reference": z.tolist(),
                  "z_quadrature": zq.tolist()},
            "b": {"wall_s": b["wall_s"], "samples_per_s": b["samples_per_s"],
                  "ess_per_s": d["ess_per_s"], "max_rhat": d["max_rhat"],
                  "mean_leapfrog": b["mean_leapfrog"], "step_size": b["step_size"],
                  "posterior_mean": b["posterior_mean"], "quadrature": quad_b.tolist(),
                  "z_reference": zb.tolist(), "z_quadrature": zbq.tolist(),
                  "dx": [dx_a, dx_b]}}


def ski_problem(dev):
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import ski

    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(-np.pi, np.pi, SKI_N)).astype(np.float32)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(SKI_N)).astype(np.float32)
    x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    k = gpx.GaussianKernel(1.0, max(100.0 * 2 * np.pi / SKI_N, 1e-4), dtype=torch.float32,
                           device=dev)
    return x, y, k, ski.interpolation_weights(x, ski.make_grid(x, SKI_M))


def run_ski_path(dev) -> dict:
    """bench.py's ski workload, twice."""
    import gaussian_processes_tpu_torch as gpx

    x, y, k, op = ski_problem(dev)
    out = {"problem": (x, y, k, op)}
    for run in (0, 1):
        out[run] = synced_wall(lambda: gpx.fit_iterative(
            k, x, y, 0.1, Float64Draws(60), num_probes=8, num_iters=SKI_ITERS, tol=1e-6,
            jitter=1e-4, precond_rank=SKI_RANK, structure=op))
    return out


def check_ski_path(check, out) -> dict:
    import torch
    from gaussian_processes_tpu_torch.ops import ski, toeplitz

    print(f"ski (float32, N={SKI_N} scattered, m={SKI_M}):", flush=True)
    x, y, k, op = out["problem"]
    (p0, w0), (p1, w1) = out[0], out[1]
    op64 = ski.SKIOperator(grid=op.grid.double(), idx=op.idx, w=op.w.double(),
                           seg_pts=op.seg_pts, seg_w=op.seg_w.double(), seg_len=op.seg_len)
    col64 = toeplitz.toeplitz_column(k.with_params(k.params.double()), op64.grid)
    y64 = y.double()
    res = [float(torch.linalg.norm(ski.ski_matvec(op64, col64, p.alpha.double(), 0.01 + 1e-4)
                                   - y64) / torch.linalg.norm(y64)) for p in (p0, p1)]
    same = bool(torch.equal(p0.alpha, p1.alpha)) and float(p0.log_marginal) == float(
        p1.log_marginal)
    print(f"  fit_iterative {w0:.3f} s, again {w1:.3f} s; lml {float(p0.log_marginal):.4f}, "
          f"{float(p1.log_marginal):.4f}; recurrence residual {float(p0.solve_residual):.3e}; "
          f"true residual of the SKI operator (f64) {res[0]:.3e}, {res[1]:.3e}; the two runs "
          f"{'bit-identical' if same else 'differ'}", flush=True)
    check(f"ski N={SKI_N} lml finite (0 = yes)",
          0.0 if bool(torch.isfinite(p0.log_marginal)) else 1.0, 0.0)
    check(f"ski N={SKI_N} second run bit-identical to the first (0 = yes)",
          0.0 if same else 1.0, 0.0)
    return {"wall_s": [w0, w1], "lml": float(p0.log_marginal), "residual": res,
            "clustered_scatter": check_ski_clustered_scatter(check, x.device)}


def check_ski_clustered_scatter(check, dev) -> dict:
    """W^T V on clustered inputs: memory O(n * taps), repeats bit for bit."""
    import numpy as np
    import torch
    from gaussian_processes_tpu_torch.ops import ski

    rng = np.random.default_rng(11)
    x = rng.uniform(-np.pi, np.pi, SKI_N)
    x[: 3 * SKI_N // 4] = 0.5 + 1e-5 * rng.standard_normal(3 * SKI_N // 4)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    op = ski.interpolation_weights(x, ski.make_grid(x, SKI_M))
    op64 = ski.SKIOperator(grid=op.grid.double(), idx=op.idx, w=op.w.double(),
                           seg_pts=op.seg_pts, seg_w=op.seg_w.double(), seg_len=op.seg_len)
    v = torch.randn((SKI_N, SKI_CLUSTER_R), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a = ski.interp_rmatvec(op, v)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    same = bool(torch.equal(a, ski.interp_rmatvec(op, v)))
    ref = ski.interp_rmatvec(op64, v.double())
    rel = float(torch.linalg.norm(a.double() - ref) / torch.linalg.norm(ref))
    ms = time_ms(lambda: ski.interp_rmatvec(op, v), 20)
    busiest = int(op.seg_len.max())
    print(f"  clustered W^T V (N={SKI_N}, {busiest} taps on the busiest of {SKI_M} grid "
          f"points, r={SKI_CLUSTER_R}): {ms:.4f} ms, {peak_mb:.1f} MB above the inputs "
          f"(a table padded to the busiest point: {SKI_M * busiest * 12 / 2 ** 20:.0f} MB), "
          f"rel error vs float64 {rel:.3e}, repeat {'bit-identical' if same else 'differs'}",
          flush=True)
    check("ski clustered W^T V repeat bit-identical (0 = yes)", 0.0 if same else 1.0, 0.0)
    check("ski clustered W^T V rel error vs float64", rel, SKI_CLUSTER_REL)
    return {"ms": ms, "peak_mb": peak_mb, "busiest_taps": busiest, "rel": rel}


def run_ski_refine_path(dev) -> dict:
    """bench.py's ski_refine workload: the N-D SKI fit, then one round of
    ``ski_kron_refine`` on the fit's preconditioner."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import krylov, ski

    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (SKI_REF_N, 2)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
         + 0.1 * rng.standard_normal(SKI_REF_N)).astype(np.float32)
    x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    k = gpx.ARDGaussianKernel(1.0, torch.tensor([0.15, 0.15]), dtype=torch.float32, device=dev)
    op = ski.interpolation_weights_nd(x, (ski.make_grid(x[:, 0], SKI_REF_M1),
                                          ski.make_grid(x[:, 1], SKI_REF_M1)))
    L = krylov.pivoted_cholesky(k, x, SKI_REF_RANK)
    post, fit_s = synced_wall(lambda: gpx.fit_iterative(
        k, x, y, 0.1, Float64Draws(70), num_probes=8, num_iters=SKI_REF_ITERS, tol=1e-7,
        jitter=1e-4, precond_rank=SKI_REF_RANK, structure=op, replace_every=10, precond_L=L))
    refined, ref_s = synced_wall(lambda: ski.ski_kron_refine(
        k, op, x, post.alpha, y, 0.1, jitter=1e-4, rounds=1, num_iters=SKI_REF_ITERS,
        precond_L=L))
    return {"fit": (post, fit_s), "refine": (refined, ref_s), "problem": (x, y, k, op)}


def check_ski_refine_path(check, out) -> dict:
    import torch
    from gaussian_processes_tpu_torch.ops import kronecker, ski

    print(f"ski-refine (float32 fit, float64 residual; n={SKI_REF_N}, 2-D, "
          f"{SKI_REF_M1}^2 grid):", flush=True)
    x, y, k, op = out["problem"]
    post, fit_s = out["fit"]
    ((hi, lo), rel), ref_s = out["refine"]
    op64 = ski._to_float64(op)
    cols64 = kronecker.kron_columns(k.with_params(k.params.double()), op64.kron)
    y64 = y.double()

    def rel64(a):
        r = ski.ski_kron_matvec(op64, cols64, a, 0.01 + 1e-4) - y64
        return float(torch.linalg.norm(r) / torch.linalg.norm(y64))

    fit_res, pair_res = rel64(post.alpha.double()), rel64(hi.double() + lo.double())
    print(f"  fit {fit_s:.3f} s, residual (f64) {fit_res:.3e}; refine (1 round) {ref_s:.3f} s, "
          f"residual {float(rel):.3e} (hi + lo recomputed {pair_res:.3e})", flush=True)
    check(f"ski-refine n={SKI_REF_N} refined residual (f64)", float(rel), SKI_REF_RESIDUAL)
    return {"fit_s": fit_s, "fit_residual": fit_res, "refine_s": ref_s,
            "refined_residual": float(rel)}


# ---------------------------------------------------------------------------
# Slice 4: SGPR, its gradient, Laplace, pathwise sampling, RFF
# ---------------------------------------------------------------------------

# config sparse1m_sgpr (N = 2^20 scattered, m = 1024 k-means centres, block
# 8192) through the CLI, then bench.py's bench_sgpr (_sine_problem(2^20,
# seed 7), w = max(100 * 2 pi / n, 1e-3), k-means from seed 0)
SGPR_N, SGPR_M, SGPR_BLOCK = 1 << 20, 1024, 8192
# float32 bound vs the same fit in float64 with the same z and the same
# pinv cutoff (sqrt of float32's eps: a float64 fit at its own cutoff keeps
# directions float32 drops: 3.8e-2 lower on the config's data on an H100
# 80GB HBM3 at 700 W, PERF.md; C accumulates 128 float32 GEMMs; the JAX
# package measured 1.6e-3 relative at n = 2e5 against float64 at the same
# cutoff);
# predictive means vs float64 (its 1e-2 at m = 64); a variance below
# -1e-3 is broken numerics, not round-off; RMSE of the config's mean
# against sin(50x) (w = 0.006 is about the spacing of 1024 centres)
SGPR_BOUND_REL, SGPR_MEAN_ABS, SGPR_VAR_FLOOR, SGPR_RMSE = 1e-2, 1e-2, -1e-3, 0.05
# the bound never above the dense float64 lml (a dense factor fits at
# 16384); with z = x on a uniform grid of 1024 (Kuu's condition ~56, so no
# direction is truncated) equal to it: the float64 CPU run gives 3.6e-14
SGPR_DENSE_N, SGPR_EXACT_N, SGPR_EXACT_REL = 16384, 1024, 1e-8
# elbo_sgpr's value and gradient (theta, noise, z) at N = 65536, m = 512:
# float32 through the kernels vs the plain float64 version (no kernel) at
# float32's cutoff, float64 vs it at float64's, GRAD_REL's limits; then 10
# Adam steps of fit_mle(objective="sgpr"), the 8-chain value and gradient
# of make_log_posterior_sgpr, and 16 chains of ChEES on bench.py's sine data
# at N = 16384 with m = 128 (R-hat 1.05, acceptance as config #3's).  The
# ChEES run is float64: with w ~ 0.5 against a centre spacing of 0.05,
# Kuu's spectrum falls through float32's cutoff and the float32 bound is
# rough (along w it moves 168 nats over +-0.01 where float64's moves 1.09;
# CPU measurement), which collapsed float32 ChEES's step to 1e-6.  Its
# chains run on u = u* + L z, u* the L-BFGS optimum of the bound and L L^T
# the Laplace covariance there (a fixed dense mass matrix: a warmup under
# 150 steps adapts none, and the posterior's scales span 20x), from z ~
# N(0, I); 60 + 60 with up to 8 leapfrogs a transition.  Cut from 100 + 100
# with up to 32 in the identity frame, which ran 806 s on an H100 80GB HBM3
# at 700 W (PERF.md): the 16 chains evaluate one after another; then from
# 80 + 80 (60.8 s) to make room for config #5 (tau ~ 1.8: R-hat ~1.013)
SGPR_GRAD_N, SGPR_GRAD_M, SGPR_MLE_STEPS, SGPR_POST_CHAINS = 65536, 512, 10, 8
SGPR_CHEES = dict(chains=16, n=16384, m=128, warmup=60, samples=60, max_leapfrog=8,
                  spread=1.0)
SGPR_CHEES_RHAT = 1.05
# Laplace at n = 4096 (the unrolled factorizations' autograd graph is ~6 GB
# in float32 there): logistic labels sign(sin 2x) with 10% flipped, Poisson
# counts of 0.1 exp(1 + sin 2x); the float32 evidence within 1e-3 of float64
LAPLACE_N, LAPLACE_LML_REL, LAPLACE_MLE_STEPS = 4096, 1e-3, 5
# pathwise: config #1's kernel and noise at N = 16384, 1024 query points,
# 256 draws, F = 2048; the draws' mean and variance within 5 Monte-Carlo
# standard errors (plus, for the variance, the feature error: the exact
# variance under the run's own features minus predict_diag's)
PATH_N, PATH_Q, PATH_S, PATH_F, PATH_SE = 16384, 1024, 256, 2048, 5.0
# the iterative sampler on the matrix-free SE workload, 64 draws: each
# draw's Matheron solve to a true residual of ITER_RESIDUAL's 1e-4
PATH_ITER_S = 64
# RFF: bench.py's bench_rff (_sine_problem(2^20, seed 5), F = 2048, block
# 16384, jitter 1e-6), float32 vs float64 with the same features
RFF_N, RFF_F, RFF_BLOCK, RFF_LML_REL, RFF_MEAN_ABS = 1 << 20, 2048, 16384, 1e-2, 1e-2


class PlainKernel:
    """Mixed in before a kernel class: K from the plain PyTorch version
    (``pairwise_matrix_reference``), no hand kernel, autograd throughout."""

    def forward(self, x1, x2):
        from gaussian_processes_tpu_torch.ops import pairwise as pw

        return pw.pairwise_matrix_reference(self, x1, x2)


def plain_se(h, w, dtype, dev):
    import gaussian_processes_tpu_torch as gpx

    cls = type("PlainGaussianKernel", (PlainKernel, gpx.GaussianKernel), {})
    return cls(h, w, dtype=dtype, device=dev)


def sgpr_config_data(dev, n=SGPR_N, dtype_name="float32", layout="scattered"):
    import torch
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    data = dataclasses.replace(CONFIGS["sparse1m_sgpr"].data, n=n, layout=layout)
    return tuple(torch.as_tensor(a, device=dev) for a in make_data(data, dtype_name))


def check_slice4_kernels(check, dev, rows):
    """B1 at the SGPR sweep's shape, (m, b) = (1024, 8192) with no
    diagonal, and B2a at its backward's (P, m, b): timed against plain."""
    import torch
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print("slice 4's kernel shapes (float32):", flush=True)
    x = sgpr_config_data(dev, SGPR_BLOCK)[0]
    z = torch.linspace(-math.pi, math.pi, SGPR_M, device=dev)
    k = GaussianKernel(1.0, 0.006, dtype=torch.float32, device=dev)
    nm = SGPR_M * SGPR_BLOCK
    for key, kern, plain, iters, work in (
            ("pairwise_k_sgpr_cross", lambda: pw.pairwise_matrix(k, z, x),
             lambda: pw.pairwise_matrix_folded(k, z, x), 20,
             (SE_K_OPS * nm, 4 * (SGPR_M + SGPR_BLOCK + nm))),
            ("pairwise_jac_sgpr_backward", lambda: pw.pairwise_jacobian(k, z, x),
             lambda: pw.pairwise_jacobian_reference(k, z, x), 20,
             (SE_JAC_OPS * nm, 4 * (SGPR_M + SGPR_BLOCK + 2 * nm)))):
        got, want = kern(), plain()
        err, v = plane_violation(got, want, "float32")
        rows[key] = {"max_abs_err": err, "ms": time_ms(kern, iters),
                     "plain_ms": time_ms(plain, iters), **bound(*work), "library_ms": None}
        print(f"  {key}: kernel {rows[key]['ms']:.4f} ms, plain {rows[key]['plain_ms']:.4f} ms, "
              f"bound {rows[key]['bound_ms']:.4f} ms, max_abs_err {err:.3e}", flush=True)
        check(f"{key} vs plain", v, 1.0)


def run_sgpr_path(dev) -> dict:
    """Config sparse1m_sgpr through the CLI on the card, then bench.py's
    SGPR workload through the library (k-means, the fit, predictions)."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.cli import run_config
    from gaussian_processes_tpu_torch.utils import CONFIGS

    out = {"cli": run_config(CONFIGS["sparse1m_sgpr"], device=dev)}
    x, y, xo = sgpr_config_data(dev)
    z = gpx.kmeans_inducing(seed(CONFIGS["sparse1m_sgpr"].data.seed), x, SGPR_M, iters=5)
    k = gpx.GaussianKernel(1.0, 0.006, dtype=torch.float32, device=dev)
    post = gpx.fit_sgpr(k, x, y, 0.1, z)
    out["config"] = (x, y, xo, z, post, gpx.predict_sgpr(post, xo))
    out["profile"] = profile_wall(lambda: gpx.fit_sgpr(k, x, y, 0.1, z))
    xb, yb, kb = sine_problem(SGPR_N, dev, seed_=7)
    (zb, km_s) = synced_wall(lambda: gpx.kmeans_inducing(seed(0), xb, SGPR_M, iters=5))
    fit = lambda: gpx.fit_sgpr(kb, xb, yb, 0.1, zb, block_size=SGPR_BLOCK)  # noqa: E731
    fit()
    walls = [synced_wall(fit)[1] for _ in range(2)]
    postb = fit()
    xob = torch.linspace(float(xb.min()), float(xb.max()), 64, device=dev)
    out["bench"] = (xb, yb, xob, zb, postb, gpx.predict_sgpr(postb, xob), min(walls), km_s)
    return out


def check_sgpr_path(check, out, dev) -> dict:
    """The float32 fits against the same fits in float64 with the same z on
    the card, the bound against dense float64 lmls, the config's mean
    against its generating function."""
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.models.sgpr import _default_rank_tol
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print(f"sgpr (float32, N=2^20, m={SGPR_M}) vs float64 on the card:", flush=True)
    cli = out["cli"]
    print(f"  CLI sparse1m_sgpr: fit {cli['fit_wall_s']:.4f} s (best of 2), elbo "
          f"{cli['elbo']:.4f}, trace_gap {cli['trace_gap']:.4f}, peak memory "
          f"{cli.get('peak_memory_gb', math.nan):.2f} GB, RMSE vs sin(50x) "
          f"{cli['pred_rmse_vs_truth']:.4f}",
          flush=True)
    check("sgpr CLI summary fields missing", float(len(
        {"fit_wall_s", "elbo", "trace_gap", "m_inducing", "pred_finite", "peak_memory_gb"}
        - set(cli))), 0.0)
    check("sgpr CLI predictions finite, var > -1e-3 (0 = yes)", 0.0 if cli["pred_finite"] else 1.0,
          0.0)
    check("sgpr CLI elbo finite (0 = yes)", 0.0 if math.isfinite(cli["elbo"]) else 1.0, 0.0)
    check("sgpr CLI RMSE of the mean vs sin(50x)", cli["pred_rmse_vs_truth"], SGPR_RMSE)
    print_profile(f"one fit_sgpr at N=2^20, m={SGPR_M} (wall {out['profile'][0]:.2f} ms; the "
                  f"sweep's GEMMs' bound 2 m^2 n / 67 TFLOP/s = "
                  f"{2 * SGPR_M ** 2 * SGPR_N / F32_PEAK_FLOPS * 1e3:.1f} ms)", out["profile"][1])
    summary = {"cli": cli, "fit_profile": out["profile"]}
    tol32 = _default_rank_tol(torch.float32)
    for name, (x, y, xo, z, post, (mean, var), *walls) in (("config", out["config"]),
                                                          ("bench", out["bench"])):
        k64 = post.kernel.with_params(post.kernel.params.double())
        post64 = gpx.fit_sgpr(k64, x.double(), y.double(), 0.1, z.double(), rank_tol=tol32)
        mean64, var64 = gpx.predict_sgpr(post64, xo.double())
        rel = abs(float(post.log_marginal) - float(post64.log_marginal)) / abs(
            float(post64.log_marginal))
        dmean = float((mean.double() - mean64).abs().max())
        print(f"  {name}: bound {float(post.log_marginal):.4f} (float64 {float(post64.log_marginal):.4f}"
              f", rel {rel:.3e}), trace_gap {float(post.trace_gap):.4f}, mean max-abs vs float64 "
              f"{dmean:.3e}, var min {float(var.min()):.3e} (float64 {float(var64.min()):.3e})"
              + (f", fit {walls[0]:.4f} s best of 2, k-means {walls[1]:.3f} s" if walls else ""),
              flush=True)
        check(f"sgpr {name} float32 bound vs float64 (rel)", rel, SGPR_BOUND_REL)
        check(f"sgpr {name} mean vs float64 (max abs)", dmean, SGPR_MEAN_ABS)
        check(f"sgpr {name} -min variance (float32)", -float(var.min()), -SGPR_VAR_FLOOR)
        check(f"sgpr {name} -min variance (float64)", -float(var64.min()), -SGPR_VAR_FLOOR)
        summary[name] = {"bound": float(post.log_marginal), "bound64": float(post64.log_marginal),
                         "rel": rel, "mean_abs": dmean, "trace_gap": float(post.trace_gap)}
        if walls:
            summary[name].update(fit_wall_s=walls[0], kmeans_s=walls[1])
    # a true lower bound: at 16384 points of the config against a dense lml
    for n, layout, z_is_x in ((SGPR_DENSE_N, "scattered", False), (SGPR_EXACT_N, "grid", True)):
        x, y, _ = sgpr_config_data(dev, n, "float64", layout)
        k64 = gpx.GaussianKernel(1.0, 0.006, dtype=torch.float64, device=dev)
        z = x if z_is_x else gpx.kmeans_inducing(seed(0), x, SGPR_M, iters=5)
        bound_ = float(gpx.fit_sgpr(k64, x, y, 0.1, z).log_marginal)
        K = pw.pairwise_matrix_reference(k64, x, x, noise=0.1)
        L = torch.linalg.cholesky(K)
        del K
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        lml = float(-0.5 * torch.dot(y, alpha) - torch.sum(torch.log(torch.diagonal(L)))
                    - 0.5 * n * LOG_2PI)
        del L
        if z_is_x:
            rel = abs(bound_ - lml) / abs(lml)
            print(f"  z = x on a {n}-point grid: float64 bound {bound_:.10f}, dense lml "
                  f"{lml:.10f}, rel {rel:.3e}", flush=True)
            check(f"sgpr z = x (n={n}) float64 bound vs dense lml (rel)", rel, SGPR_EXACT_REL)
            summary["z_equals_x_rel"] = rel
        else:
            print(f"  N={n}: float64 bound {bound_:.4f} <= dense float64 lml {lml:.4f}", flush=True)
            check(f"sgpr N={n} float64 bound - dense lml", bound_ - lml, 0.0)
            summary["dense_gap"] = lml - bound_
        torch.cuda.empty_cache()
    return summary


def sgpr_grad_problem(dev, dtype, n=SGPR_GRAD_N, m=SGPR_GRAD_M):
    import torch
    import gaussian_processes_tpu_torch as gpx

    x, y, _ = sgpr_config_data(dev, n)
    z = gpx.kmeans_inducing(seed(1), x, m, iters=5)
    return x.to(dtype), y.to(dtype), z.to(dtype)


def elbo_value_and_grads(kernel_template, x, y, z, u0, rank_tol=None):
    """elbo_sgpr and its gradient in u = log(h, w, s) and in z."""
    import torch
    from gaussian_processes_tpu_torch.inference import gp_model
    from gaussian_processes_tpu_torch.models.sgpr import elbo_sgpr

    u = u0.detach().clone().requires_grad_()
    zz = z.detach().clone().requires_grad_()
    kern, noise = gp_model.unpack(kernel_template, u)
    value = elbo_sgpr(kern, x, y, noise, zz, rank_tol=rank_tol)
    gu, gz = torch.autograd.grad(value, [u, zz])
    return value.detach(), gu, gz


def laplace_frame(lp, u0, h=1e-3):
    """(u*, L): u0 as the centre and L L^T = |H|^-1, the Laplace covariance
    (eigenvalues of H taken by magnitude), with H the log density's Hessian
    at u0 by central differences of its gradient, one batched evaluation
    each side.  h = 1e-3: the pinv cutoff makes the bound's gradient rough
    at 1e-4 (a float64 run on the CPU: H's (h, h) entry -27, +28 and +145 at
    h = 1e-3, 1e-4, 1e-5, its noise entry -32738 at each)."""
    import torch

    E = h * torch.eye(u0.shape[0], dtype=u0.dtype, device=u0.device)
    H = (lp.value_and_grad(u0 + E)[1] - lp.value_and_grad(u0 - E)[1]) / (2 * h)
    lam, V = torch.linalg.eigh(0.5 * (H + H.T))
    return u0, V / torch.sqrt(lam.abs())[None, :]


def run_sgpr_grad_path(dev) -> dict:
    """elbo_sgpr's value and gradient through the kernels (B1 forward, B2a
    and the plain element in its backward) in float32 and float64; Adam on
    fit_mle(objective="sgpr"); the chains of make_log_posterior_sgpr; ChEES
    on the SGPR posterior."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.inference import LogDensity, init_positions, sample_chees

    out = {}
    for dtype in (torch.float32, torch.float64):
        x, y, z = sgpr_grad_problem(dev, dtype)
        k = gpx.GaussianKernel(1.0, 0.006, dtype=dtype, device=dev)
        u0 = torch.log(torch.tensor([1.0, 0.006, 0.1], dtype=dtype, device=dev))
        out[dtype], out[f"{dtype}_s"] = synced_wall(lambda: elbo_value_and_grads(k, x, y, z, u0))
        out[f"{dtype}_s"] = synced_wall(lambda: elbo_value_and_grads(k, x, y, z, u0))[1]
    x, y, z = sgpr_grad_problem(dev, torch.float32)
    k = gpx.GaussianKernel(1.0, 0.006, dtype=torch.float32, device=dev)
    u0 = torch.log(torch.tensor([1.0, 0.006, 0.1], device=dev))
    out["profile"] = profile_wall(lambda: elbo_value_and_grads(k, x, y, z, u0))
    k = gpx.GaussianKernel(1.3, 0.01, dtype=torch.float32, device=dev)
    out["mle"], out["mle_s"] = synced_wall(lambda: gpx.fit_mle(
        k, x, y, 0.2, num_steps=SGPR_MLE_STEPS, method="adam", learning_rate=0.05,
        objective="sgpr", inducing=z))
    lp = gpx.make_log_posterior_sgpr(gpx.GaussianKernel(1.0, 0.006, dtype=torch.float32,
                                                        device=dev), x, y, z)
    U = init_positions(gpx.GaussianKernel(1.0, 0.006, dtype=torch.float32, device=dev), 0.1,
                       seed(2), n_chains=SGPR_POST_CHAINS, spread=0.2, dtype=torch.float32)
    out["chains"], out["chains_s"] = synced_wall(lambda: lp.value_and_grad(U))
    out["chains_problem"] = (x, y, z, U)
    c = SGPR_CHEES
    xc, yc, _ = sine_problem(c["n"], dev, "float64")
    kc = gpx.GaussianKernel(1.0, 0.5, dtype=torch.float64, device=dev)
    zc = gpx.kmeans_inducing(seed(3), xc, c["m"], iters=5)
    lpc = gpx.make_log_posterior_sgpr(kc, xc, yc, zc, prior_std=1.0)
    opt = gpx.fit_mle(kc, xc, yc, 0.1, num_steps=30, objective="sgpr", inducing=zc)
    u_star, L = laplace_frame(lpc, opt.u)
    lpz = LogDensity(lambda Z: (lambda v, g: (v, g @ L))(*lpc.value_and_grad(u_star + Z @ L.T)))
    init = c["spread"] * torch.randn((c["chains"], 3), generator=seed(4),
                                     dtype=torch.float64).to(dev)
    out["chain_eval"] = profile_wall(lambda: lpc.value_and_grad(u_star[None]))
    gen = torch.Generator(device=dev).manual_seed(5)
    res, out["chees_s"] = synced_wall(lambda: sample_chees(
        lpz, init, gen, num_warmup=c["warmup"], num_samples=c["samples"],
        max_leapfrog=c["max_leapfrog"]))
    out["chees"] = res._replace(positions=u_star + res.positions @ L.T)
    return out


def check_sgpr_grad_path(check, out, dev) -> dict:
    import numpy as np
    import torch
    from gaussian_processes_tpu_torch.inference.diagnostics import ess, split_rhat
    from gaussian_processes_tpu_torch.models.sgpr import _default_rank_tol

    print_profile(f"one elbo_sgpr value+grad, float32, N={SGPR_GRAD_N}, m={SGPR_GRAD_M} "
                  f"(wall {out['profile'][0]:.2f} ms)", out["profile"][1])
    print_profile(f"one chain's value+grad of make_log_posterior_sgpr, float64, N={SGPR_CHEES['n']}, "
                  f"m={SGPR_CHEES['m']} (wall {out['chain_eval'][0]:.2f} ms)",
                  out["chain_eval"][1])
    print(f"sgpr-grad (N={SGPR_GRAD_N}, m={SGPR_GRAD_M}) vs the plain float64 version's "
          "autograd on the card:", flush=True)
    f64 = torch.float64
    x, y, z = sgpr_grad_problem(dev, f64)
    u0 = torch.log(torch.tensor([1.0, 0.006, 0.1], dtype=f64, device=dev))
    tol32 = _default_rank_tol(torch.float32)
    plain = plain_se(1.0, 0.006, f64, dev)
    summary = {}
    for dtype, name in ((torch.float32, "float32"), (f64, "float64")):
        got = out[dtype]
        # the same function: float64 at the run's own pinv cutoff
        want = elbo_value_and_grads(plain, x, y, z, u0, tol32 if dtype == torch.float32 else None)
        rels = [abs(float(got[0]) - float(want[0])) / abs(float(want[0]))] + [
            float(torch.linalg.norm(g.double() - w) / torch.linalg.norm(w))
            for g, w in zip(got[1:], want[1:])]
        print(f"  {name} through the kernels ({out[f'{dtype}_s']:.3f} s): value {float(got[0]):.6f} "
              f"(plain {float(want[0]):.6f}), rel errors value {rels[0]:.2e}, d/du {rels[1]:.2e}, "
              f"d/dz {rels[2]:.2e}", flush=True)
        for what, r in zip(("value", "gradient in theta and noise", "gradient in z"), rels):
            check(f"sgpr-grad {name} {what} vs plain float64 (rel)", r, GRAD_REL[name])
        summary[name] = {"rel": rels, "wall_s": out[f"{dtype}_s"]}
    losses = out["mle"].losses.double().cpu().numpy()
    print(f"  fit_mle(objective='sgpr') {SGPR_MLE_STEPS} Adam steps ({out['mle_s']:.2f} s): "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    check("sgpr-grad MLE losses finite (0 = yes)", 0.0 if np.isfinite(losses).all() else 1.0, 0.0)
    check("sgpr-grad MLE last loss - first", float(losses[-1] - losses[0]), 0.0)
    xs, ys, zs, U = out["chains_problem"]
    lp64 = __import__("gaussian_processes_tpu_torch").make_log_posterior_sgpr(
        plain, xs.double(), ys.double(), zs.double(), rank_tol=tol32)
    v64, g64 = lp64.value_and_grad(U.double())
    v32, g32 = out["chains"]
    rel_v = float(((v32.double() - v64).abs() / v64.abs()).max())
    rel_g = max(float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
                for a, b in zip(g32, g64))
    print(f"  make_log_posterior_sgpr, {SGPR_POST_CHAINS} chains ({out['chains_s']:.3f} s): "
          f"value rel {rel_v:.2e}, gradient rel {rel_g:.2e} (worst chain)", flush=True)
    check("sgpr-grad chains value vs plain float64 (rel)", rel_v, GRAD_REL["float32"])
    check("sgpr-grad chains gradient vs plain float64 (rel)", rel_g, GRAD_REL["float32"])
    res = out["chees"]
    u = res.positions.double().cpu().numpy()
    rhat = float(split_rhat(u).max())
    acc = float(res.accept_prob.double().mean())
    c = SGPR_CHEES
    print(f"  ChEES on the SGPR posterior (float64), {c['chains']} chains at N={c['n']}, "
          f"m={c['m']}, {c['warmup']} + {c['samples']}: {out['chees_s']:.1f} s, max R-hat "
          f"{rhat:.4f}, min ESS {float(ess(u).min()):.1f}, accept {acc:.3f}, mean leapfrog "
          f"{float(res.num_leapfrog.double().mean()):.2f} (cap {c['max_leapfrog']}), step "
          f"{float(res.step_size):.3e}, T {float(res.traj_length):.3e}, mean theta "
          f"{np.array2string(np.exp(u).reshape(-1, 3).mean(0), precision=5)}", flush=True)
    check("sgpr-grad ChEES max split R-hat", rhat, SGPR_CHEES_RHAT)
    check("sgpr-grad ChEES accept below its low end", CHEES_ACCEPT[0] - acc, 0.0)
    check("sgpr-grad ChEES accept above its high end", acc - CHEES_ACCEPT[1], 0.0)
    summary.update(mle_s=out["mle_s"], chains_s=out["chains_s"], chees_s=out["chees_s"],
                   chees_rhat=rhat, chees_accept=acc,
                   value_and_grad_ms={"n65536_m512": out["profile"][0],
                                      "chain_n16384_m128": out["chain_eval"][0]})
    return summary


def laplace_problem(dev, dtype, kind):
    import numpy as np
    import torch
    import gaussian_processes_tpu_torch as gpx

    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(-np.pi, np.pi, LAPLACE_N))
    if kind == "logistic":
        y = np.sign(np.sin(2 * x))
        y[rng.random(LAPLACE_N) < 0.1] *= -1.0
        lik = gpx.LogisticLikelihood()
    else:
        y = rng.poisson(0.1 * np.exp(1.0 + np.sin(2 * x))).astype(np.float64)
        lik = gpx.PoissonLikelihood(0.1)
    return (torch.as_tensor(x, dtype=dtype, device=dev), torch.as_tensor(y, dtype=dtype, device=dev),
            lik)


def laplace_grad(kernel_template, x, y, lik):
    """log_marginal_laplace and its gradient in u = log theta."""
    import torch
    import gaussian_processes_tpu_torch as gpx

    u = torch.log(kernel_template.params).detach().requires_grad_()
    value = gpx.log_marginal_laplace(kernel_template.with_params(torch.exp(u)), x, y,
                                     likelihood=lik)
    (g,) = torch.autograd.grad(value, u)
    return value.detach(), g


def run_laplace_path(dev) -> dict:
    """fit_laplace (logistic, Poisson) in float32 and float64, the evidence's
    gradient through B1's and the blocked factor's autograd rules, and Adam
    on fit_laplace_mle."""
    import torch
    import gaussian_processes_tpu_torch as gpx

    out = {}
    for kind in ("logistic", "poisson"):
        for dtype in (torch.float32, torch.float64):
            x, y, lik = laplace_problem(dev, dtype, kind)
            k = gpx.GaussianKernel(1.0, 0.5, dtype=dtype, device=dev)
            out[kind, dtype], out[kind, dtype, "s"] = synced_wall(
                lambda: gpx.fit_laplace(k, x, y, likelihood=lik))
            out[kind, dtype, "grad"], out[kind, dtype, "grad_s"] = synced_wall(
                lambda: laplace_grad(k, x, y, lik))
    x, y, lik = laplace_problem(dev, torch.float32, "logistic")
    out["mle"], out["mle_s"] = synced_wall(lambda: gpx.fit_laplace_mle(
        gpx.GaussianKernel(1.3, 0.8, dtype=torch.float32, device=dev), x, y, likelihood=lik,
        num_steps=LAPLACE_MLE_STEPS))
    return out


@contextlib.contextmanager
def _swap(module, name: str, value):
    """Set ``module.name`` to ``value`` inside a with block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def check_laplace_path(check, out, dev) -> dict:
    import torch
    from gaussian_processes_tpu_torch.models import classify

    print(f"laplace (n={LAPLACE_N}) vs float64 and torch.linalg.cholesky's autograd:", flush=True)
    f32, f64 = torch.float32, torch.float64
    summary = {}
    for kind in ("logistic", "poisson"):
        x, y, lik = laplace_problem(dev, f64, kind)
        # the reference: plain K, torch.linalg.cholesky and its autograd, float64
        with _swap(classify, "choose_cholesky", lambda A: torch.linalg.cholesky):
            want = laplace_grad(plain_se(1.0, 0.5, f64, dev), x, y, lik)
        p32, p64 = out[kind, f32], out[kind, f64]
        rel = abs(float(p32.log_marginal) - float(p64.log_marginal)) / abs(float(p64.log_marginal))
        for post, name in ((p32, "float32"), (p64, "float64")):
            d = post.newton_deltas.double()
            check(f"laplace {kind} {name} Newton steps lowering psi", float((d < 0).sum()), 0.0)
        check(f"laplace {kind} float32 lml vs float64 (rel)", rel, LAPLACE_LML_REL)
        line = (f"  {kind}: lml float32 {float(p32.log_marginal):.4f} ({out[kind, f32, 's']:.3f} s),"
                f" float64 {float(p64.log_marginal):.4f} ({out[kind, f64, 's']:.3f} s), rel {rel:.2e};"
                f" last Newton deltas {float(p32.newton_deltas[-1]):.2e} / "
                f"{float(p64.newton_deltas[-1]):.2e}")
        summary[kind] = {"lml_rel": rel, "fit_s": out[kind, f32, "s"]}
        for dtype, name in ((f32, "float32"), (f64, "float64")):
            value, g = out[kind, dtype, "grad"]
            r = float(torch.linalg.norm(g.double() - want[1]) / torch.linalg.norm(want[1]))
            line += f"; gradient {name} rel {r:.2e} ({out[kind, dtype, 'grad_s']:.2f} s)"
            check(f"laplace {kind} {name} evidence gradient vs torch.linalg.cholesky autograd "
                  "(rel)", r, GRAD_REL[name])
            summary[kind][f"grad_rel_{name}"] = r
        print(line, flush=True)
    post, losses = out["mle"]
    losses = losses.double().cpu()
    print(f"  fit_laplace_mle {LAPLACE_MLE_STEPS} Adam steps ({out['mle_s']:.2f} s): loss "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, theta "
          f"{post.kernel.params.tolist()}", flush=True)
    check("laplace MLE losses finite (0 = yes)", 0.0 if bool(torch.isfinite(losses).all()) else 1.0,
          0.0)
    summary["mle_s"] = out["mle_s"]
    return summary


class _Recorder:
    """Wraps a function, keeping each call's arguments and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        result = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, result))
        return result


def pathwise_problem(dev):
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    cfg = CONFIGS["config1_fit_se500"]
    x, y, _ = make_data(dataclasses.replace(cfg.data, n=PATH_N), "float32")
    x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    k = gpx.GaussianKernel(cfg.kernel.h, cfg.kernel.w, dtype=torch.float32, device=dev)
    xo = torch.linspace(-3.0, 3.0, PATH_Q, device=dev)
    return x, y, k, xo, cfg.fit.noise, cfg.fit.jitter


def run_pathwise_path(dev) -> dict:
    """The dense sampler on config #1's posterior at N = 16384; the iterative
    sampler on the matrix-free SE workload (its PCG solves recorded)."""
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import krylov

    x, y, k, xo, noise, jitter = pathwise_problem(dev)
    post = gpx.fit(k, x, y, noise, jitter)
    out = {}
    out["dense"], out["dense_s"] = synced_wall(lambda: gpx.sample_posterior_pathwise(
        post, xo, seed(30), PATH_S, PATH_F))
    xi, yi, ki = sine_problem(ITER_N, dev)
    posti = gpx.fit_iterative(ki, xi, yi, ITER_NOISE, seed(10), **ITER_OPTS)
    rec = _Recorder(krylov.pcg)
    opts = {key: ITER_OPTS[key] for key in ("num_iters", "jitter", "block_size", "precond_rank")}
    with _swap(krylov, "pcg", rec):
        out["iter"], out["iter_s"] = synced_wall(lambda: gpx.sample_posterior_pathwise_iterative(
            posti, xo, seed(31), PATH_ITER_S, PATH_F, tol=1e-7, **opts))
    out["iter_solve"] = rec.calls[-1]
    out["iter_problem"] = (xi, yi, ki)
    return out


def check_pathwise_path(check, out, dev) -> dict:
    import torch
    from gaussian_processes_tpu_torch.models.pathwise import prior_features
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    print(f"pathwise (N={PATH_N}, {PATH_Q} query points, {PATH_S} draws, F={PATH_F}) vs float64 "
          "on the card:", flush=True)
    f64 = torch.float64
    x, y, k, xo, noise, jitter = pathwise_problem(dev)
    x64, y64, xo64 = x.double(), y.double(), xo.double()
    k64 = k.with_params(k.params.double())
    A = pw.pairwise_matrix_reference(k64, x64, x64, noise=noise, jitter=jitter)
    L = torch.linalg.cholesky(A)
    del A
    Kxo = pw.pairwise_matrix_reference(k64, x64, xo64)  # (n, q)
    V = torch.cholesky_solve(Kxo, L)  # A^-1 K(x, xo)
    mean = V.T @ y64
    var = k64.kdiag(xo64) - torch.sum(Kxo * V, dim=0)
    # the exact variance under this run's features (the sampler's first draws)
    feats = prior_features(k64, seed(30), PATH_F)
    R = feats(xo64) - V.T @ feats(x64)
    var_feat = torch.sum(R * R, dim=1) + noise ** 2 * torch.sum(V * V, dim=0)
    del L, V, Kxo
    draws = out["dense"].double()
    d_mean, d_var = draws.mean(0), draws.var(0)
    se_mean = torch.sqrt(var_feat / PATH_S)
    se_var = var_feat * math.sqrt(2.0 / (PATH_S - 1))
    z_mean = float(((d_mean - mean).abs() / se_mean).max())
    feat_err = (var_feat - var).abs()
    z_var = float(((d_var - var).abs() / (PATH_SE * se_var + feat_err)).max()) * PATH_SE
    z_var_feat = float(((d_var - var_feat).abs() / se_var).max())
    print(f"  dense sampler ({out['dense_s']:.3f} s): max |mean - predict| {float((d_mean - mean).abs().max()):.3e}"
          f" = {z_mean:.2f} MC SE; variance vs predict_diag {z_var:.2f} (MC SE, beyond the "
          f"feature error, max {float(feat_err.max()):.3e} of var max {float(var.max()):.3e}); vs "
          f"the features' exact variance {z_var_feat:.2f} MC SE", flush=True)
    check("pathwise dense draws' mean vs predict (MC SE)", z_mean, PATH_SE)
    check("pathwise dense draws' variance vs predict_diag (MC SE + feature error)", z_var, PATH_SE)
    summary = {"dense_s": out["dense_s"], "z_mean": z_mean, "z_var": z_var,
               "z_var_features": z_var_feat, "feature_err_max": float(feat_err.max())}
    (matvec, pre, rhs), kwargs, (v, resid_rec) = out["iter_solve"]
    xi, yi, ki = out["iter_problem"]
    k64 = ki.with_params(ki.params.double())
    r = pw.kernel_matvec_fused_reference(k64, xi.double(), v.double(), ITER_NOISE,
                                         ITER_JITTER) - rhs.double()
    res = torch.linalg.norm(r, dim=0) / torch.linalg.norm(rhs.double(), dim=0)
    print(f"  iterative sampler ({PATH_ITER_S} draws at N={ITER_N}, {out['iter_s']:.3f} s): Matheron "
          f"solves' true residual (float64) max {float(res.max()):.3e}, median "
          f"{float(res.median()):.3e}; recurrence max {float(resid_rec.max()):.3e}; draws finite "
          f"{bool(torch.isfinite(out['iter']).all())}", flush=True)
    check("pathwise iterative worst Matheron solve's true residual (float64)", float(res.max()),
          ITER_RESIDUAL)
    check("pathwise iterative draws finite (0 = yes)",
          0.0 if bool(torch.isfinite(out["iter"]).all()) else 1.0, 0.0)
    summary.update(iter_s=out["iter_s"], iter_residual_max=float(res.max()))
    return summary


def run_rff_path(dev) -> dict:
    """bench.py's RFF workload in float32 (the main path) and float64, the
    same features (drawn in float64 and cast)."""
    import torch
    import gaussian_processes_tpu_torch as gpx

    out = {}
    for dtype_name in ("float32", "float64"):
        x, y, k = sine_problem(RFF_N, dev, dtype_name, seed_=5)
        xo = torch.linspace(-3.0, 3.0, 1024, dtype=x.dtype, device=dev)
        fit = lambda: gpx.fit_rff(k, x, y, 0.1, Float64Draws(0), num_features=RFF_F,  # noqa: E731
                                  block_size=RFF_BLOCK, jitter=1e-6)
        post, wall = synced_wall(fit)
        out[dtype_name] = (post, gpx.predict_rff(post, xo), wall)
    return out


def check_rff_path(check, out) -> dict:
    print(f"rff (N=2^20, F={RFF_F}) float32 vs float64 with the same features:", flush=True)
    (p32, (m32, v32), w32), (p64, (m64, v64), w64) = out["float32"], out["float64"]
    rel = abs(float(p32.log_marginal) - float(p64.log_marginal)) / abs(float(p64.log_marginal))
    dmean = float((m32.double() - m64).abs().max())
    print(f"  lml float32 {float(p32.log_marginal):.4f} ({w32:.3f} s, first call), float64 "
          f"{float(p64.log_marginal):.4f} ({w64:.3f} s), rel {rel:.2e}; mean max-abs {dmean:.3e}",
          flush=True)
    check("rff lml finite (0 = yes)", 0.0 if math.isfinite(float(p32.log_marginal)) else 1.0, 0.0)
    check("rff float32 lml vs float64 (rel)", rel, RFF_LML_REL)
    check("rff float32 mean vs float64 (max abs)", dmean, RFF_MEAN_ABS)
    return {"lml_rel": rel, "mean_abs": dmean, "fit_s": [w32, w64]}


def slice4_paths(dev):
    """Slice 4's paths as (name, run) pairs, in the order main drives them."""
    return (("sgpr", lambda: run_sgpr_path(dev)),
            ("sgpr-grad", lambda: run_sgpr_grad_path(dev)),
            ("laplace", lambda: run_laplace_path(dev)),
            ("pathwise", lambda: run_pathwise_path(dev)),
            ("rff", lambda: run_rff_path(dev)))


def check_slice4_paths(check, runs, dev) -> dict:
    """Checks of slice 4's paths; each run is dropped once checked."""
    return {"sgpr": check_sgpr_path(check, runs.pop("sgpr"), dev),
            "sgpr_grad": check_sgpr_grad_path(check, runs.pop("sgpr-grad"), dev),
            "laplace": check_laplace_path(check, runs.pop("laplace"), dev),
            "pathwise": check_pathwise_path(check, runs.pop("pathwise"), dev),
            "rff": check_rff_path(check, runs.pop("rff"))}


# ---------------------------------------------------------------------------
# slice 5: the multi-device layer over torch.distributed, run over an NCCL
# process group of one rank (every collective runs; the machine has one card)

# config #5 (BASELINE.json:11; utils/config.py: 1024 chains, N = 500, config
# #3's data and prior) through the CLI's nuts_multihost task, cut in depth
# only from 500 + 1000 to C5_WARMUP + C5_SAMPLES (150: the shortest warmup
# whose schedule has a mass-matrix window; 100 + 100, step size alone, took
# 279 s and left split R-hat at 1.072, PERF.md), host chunks of C5_CHUNK
# with every rank's state written to its checkpoint file and read back
# between them; the posterior means within C5_SE Monte-Carlo standard errors
# of the float64 quadrature of config #3's posterior, split R-hat below
# C5_RHAT (the cut run's limit, as NUTS_RHAT), divergences below
# NUTS_DIVERGENT.  The cut holds R-hat: split R-hat runs near
# 1 + (tau - 1) / (2 n) for n draws a half-chain, and tau ~ 5.2 (ESS 19526
# of 102400 draws) gives 1.042 at 100 samples (read: 1.040) and ~1.08 at
# 50.  Resume: C5_RESUME's chains and steps, chunked through the
# checkpoints against one unchunked run, bit for bit
CONFIG5_CHAINS = 1024
C5_WARMUP, C5_SAMPLES, C5_CHUNK, C5_SE, C5_RHAT = 150, 100, 50, 4.0, 1.05
C5_RESUME = dict(n_chains=128, num_warmup=10, num_samples=10, chunk_size=5)
# the row-sharded paths at W = 1: fit_iterative_sharded on the matrix-free
# SE workload (ITER_OPTS with B1's strips at the JAX package's block 1024)
# against fit_iterative on the same product (impl="strip") and draws, with
# fit_iterative on B4 timed beside it (B4's round-off moves alpha by ~2e-4
# relative at this residual, PERF.md); fit_sgpr_sharded on config
# sparse1m_sgpr's data against fit_sgpr (the same sweep: equal at W = 1 up
# to the sum's order); the data-sharded log posterior's value and gradient
# at ROW_BAYES_N against make_log_posterior_iterative (B4, B5) on the same
# frozen probes, float32 (the two differ by the products' round-off).  The
# twins run first, as a path of their own, so that the row-sharded path's
# launch counts are the sharded calls' alone.  The data-sharded limits sit
# a few times over the card's readings (value 1.422e-6 and gradient
# 1.149e-4 relative, the same in three runs on an H100, PERF.md) and below
# what a planted fault gives: the same log posterior with the last column
# strip of its sharded matvec, or of its Jacobian, dropped
ROW_BLOCK, ROW_ALPHA_REL, ROW_SGPR_REL = 1024, 1e-4, 1e-6
ROW_BAYES_N, ROW_BAYES_OPTS = 16384, dict(num_probes=8, num_iters=100, tol=1e-6,
                                          jitter=ITER_JITTER, precond_rank=512)
ROW_BAYES_VALUE_REL, ROW_BAYES_GRAD_REL = 5e-6, 5e-4


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_slice5_kernels(check, dev, rows):
    """The shapes slice 5 brings: B1 and B2a over config #5's (1024, 3) SE
    chain table at N = 500, B3 on (1024, 128, 128) stacks with inverses, and
    B1 on one rank's (n / W, block) row strip at W = 1, N = 65536, block
    1024; float32 and float64 against the plain versions, float32 timed."""
    import torch
    from gaussian_processes_tpu_torch.ops import blocked_cholesky as bc
    from gaussian_processes_tpu_torch.ops import pairwise as pw

    C, n = CONFIG5_CHAINS, CHAIN_N
    n2 = n * n
    print(f"slice 5's kernel shapes: {C} chains at N={n}, a {ITER_N} x {ROW_BLOCK} row strip:",
          flush=True)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        timed = dtype == torch.float32
        x, template, theta = chain_problem(dev, dtype, "se", chains=C)
        P = template.n_params
        params, diag = theta[:, :P], theta[:, P] ** 2 + 1e-6
        for key, kern, plain, work in (
                ("pairwise_k_chains_1024",
                 lambda: pw.pairwise_matrix_chains(template, x, params, diag),
                 lambda: pw.pairwise_matrix_chains_folded(template, x, params, diag),
                 (C * (SE_K_OPS * n2 + n), 4 * (n + C * (P + 1) + C * n2))),
                ("pairwise_jac_chains_1024",
                 lambda: pw.pairwise_jacobian_chains(template, x, params),
                 lambda: pw.pairwise_jacobian_chains_reference(template, x, params),
                 (C * SE_JAC_OPS * n2, 4 * (n + C * P + C * P * n2)))):
            err, v = plane_violation(kern(), plain(), dname)
            check(f"{key} {dname} vs plain", v, 1.0)
            if timed:
                rows[key] = {"max_abs_err": err, "ms": time_ms(kern, 10),
                             "plain_ms": time_ms(plain, 5), "library_ms": None, **bound(*work)}
        K = pw.pairwise_matrix_chains(template, x, params, diag)
        alpha, inv_K = contract_operands(K, x)
        check_contract(check, rows, "pairwise_jac_contract_chains_1024", f"{C}-chain table {dname}",
                       template, x, params, alpha, inv_K, SE_JAC_OPS, timed)
        del alpha, inv_K
        tiles = K[:, :128, :128].contiguous()
        del K
        (got, got_inv), (want, want_inv) = bc.chol_tile_inv(tiles), bc.chol_tile_inv_reference(tiles)
        check(f"B3 {C}-chain stack {dname}: backward", backward(got, tiles), CHOL_BACKWARD_TOL[dname])
        eyes = torch.eye(128, dtype=torch.float64, device=dev).expand(C, 128, 128)
        ratio = (rel_fro(got_inv.double() @ got.double(), eyes)
                 / rel_fro(want_inv.double() @ want.double(), eyes))
        check(f"B3 {C}-chain stack {dname}: ||L^-1 L - I|| / the plain inverse's", ratio,
              BLOCKED_BACKWARD_RATIO)
        if timed:
            eye = torch.eye(128, dtype=dtype, device=dev)
            rows["chol_tile_inv_chains_1024"] = {
                "max_abs_err": float(torch.stack((got - want, got_inv - want_inv)).abs().max()),
                "ms": time_ms(lambda: bc.chol_tile_inv(tiles), 20),
                "plain_ms": time_ms(lambda: bc.chol_tile_inv_reference(tiles), 20),
                "library_ms": time_ms(lambda: torch.linalg.solve_triangular(
                    torch.linalg.cholesky_ex(tiles)[0], eye, upper=False), 20),
                **bound(C * 2 * 128 ** 3 / 3, 4 * 3 * C * 128 * 128)}
        del tiles, got, got_inv, want, want_inv
        xs, _, k = sine_problem(ITER_N, dev, dname)
        cols = xs[:ROW_BLOCK].contiguous()
        kern = lambda: pw.pairwise_matrix(k, xs, cols)  # noqa: E731
        plain = lambda: pw.pairwise_matrix_folded(k, xs, cols)  # noqa: E731
        err, v = plane_violation(kern(), plain(), dname)
        check(f"B1 row strip {ITER_N}x{ROW_BLOCK} {dname} vs plain", v, 1.0)
        if timed:
            nb = ITER_N * ROW_BLOCK
            rows["pairwise_k_row_strip"] = {
                "max_abs_err": err, "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 20),
                "library_ms": None, **bound(SE_K_OPS * nb, 4 * (ITER_N + ROW_BLOCK + nb))}
        torch.cuda.empty_cache()
    for key in ("pairwise_k_chains_1024", "pairwise_jac_chains_1024", "chol_tile_inv_chains_1024",
                "pairwise_k_row_strip", "pairwise_jac_contract_chains_1024"):
        r = rows[key]
        print(f"  {key}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})" + (f", library {r['library_ms']:.4f}" if r["library_ms"]
                                      else "") + (f", replaced {r['replaced_ms']:.4f}"
                                                  if "replaced_ms" in r else "")
              + f", max_abs_err {r['max_abs_err']:.3e}", flush=True)


def check_blockcyclic_kernel(check, dev, rows):
    """B1 on ``fit_blockcyclic``'s strip of config #4 (no diagonal): float32
    at the shape that the fit-large path builds over the group of one rank,
    (N, N), against ``pairwise_matrix_reference`` and B1's folded arithmetic
    in BC_CHUNK-row chunks, timed against the reference over the same
    chunks; float64 on rank 0's strip over BC_STRIP_RANKS ranks."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.ops import pairwise as pw
    from gaussian_processes_tpu_torch.utils import CONFIGS, make_data

    data = CONFIGS["config4_large_n"].data
    n = data.n
    for dtype, world in ((torch.float32, 1), (torch.float64, BC_STRIP_RANKS)):
        dname = str(dtype).split(".")[-1]
        x = torch.as_tensor(make_data(data, dname)[0], device=dev)
        x_own = x.view(n // BC_BLOCK // world, world, BC_BLOCK)[:, 0].reshape(-1)  # rank 0's
        k = gpx.GaussianKernel(1.0, 1.0, dtype=dtype, device=dev)
        chunks = torch.split(x_own, BC_CHUNK)
        kern = lambda: pw.pairwise_matrix(k, x_own, x)  # noqa: E731

        def plain():
            for xc in chunks:
                pw.pairwise_matrix_reference(k, xc, x)

        got = kern()
        shape = tuple(got.shape)
        viol, fold_viol, err = 0.0, 0.0, 0.0
        for i, xc in enumerate(chunks):
            part = got[i * BC_CHUNK:i * BC_CHUNK + xc.numel()]
            e, v = plane_violation(part, pw.pairwise_matrix_reference(k, xc, x), dname)
            err, viol = max(err, e), max(viol, v)
            if dtype == torch.float32:
                fold_viol = max(fold_viol, plane_violation(
                    part, pw.pairwise_matrix_folded(k, xc, x), dname)[1])
        del got, part
        torch.cuda.empty_cache()
        check(f"B1 block-cyclic strip {shape} {dname} vs pairwise_matrix_reference", viol, 1.0)
        if dtype == torch.float32:
            check(f"B1 block-cyclic strip {shape} float32 vs its folded arithmetic",
                  fold_viol, 1.0)
            nb = x_own.numel() * n
            rows["pairwise_k_blockcyclic_strip"] = {
                "shape": shape, "max_abs_err": err, "ms": time_ms(kern, 20),
                "plain_ms": time_ms(plain, 5), "library_ms": None,
                **bound(SE_K_OPS * nb, 4 * (x_own.numel() + n + nb))}
            torch.cuda.empty_cache()
    r = rows["pairwise_k_blockcyclic_strip"]
    print(f"  pairwise_k_blockcyclic_strip {r['shape']}: {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} (in {BC_CHUNK}-row chunks), bound {r['bound_ms']:.4f} "
          f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e}", flush=True)


def run_multihost_path(dev) -> dict:
    """Config #5 through the CLI's nuts_multihost task (depth cut, chains
    and N in full, checkpoints between the chunks), then the resume check:
    C5_RESUME's run chunked through the checkpoints against one pass."""
    import tempfile

    import torch
    from gaussian_processes_tpu_torch import cli, parallel
    from gaussian_processes_tpu_torch.utils import CONFIGS

    cfg = CONFIGS["config5_nuts_sharded"]
    cfg = dataclasses.replace(cfg, nuts=dataclasses.replace(
        cfg.nuts, num_warmup=C5_WARMUP, num_samples=C5_SAMPLES, chunk_size=C5_CHUNK))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = cli.run_config(cfg, device=dev, checkpoint=f"{tmp}/config5.npz")
        small = dataclasses.replace(cfg, nuts=dataclasses.replace(cfg.nuts, **C5_RESUME))
        x, y, _, kernel, dtype = cli.load_problem(small, dev)
        ncfg = small.nuts
        mesh = parallel.make_chain_mesh(device=dev)
        runs = []
        for chunk, ckpt in ((None, None), (ncfg.chunk_size, f"{tmp}/resume.npz")):
            log_post, init, gen = cli.sampler_setup(small, kernel, x, y, dev, dtype)
            runs.append(parallel.sample_nuts_sharded(
                log_post, init, gen, mesh=mesh, num_warmup=ncfg.num_warmup,
                num_samples=ncfg.num_samples, chunk_size=chunk, checkpoint=ckpt,
                max_depth=ncfg.max_depth, target_accept=ncfg.target_accept,
                init_step_size=ncfg.init_step_size))
    out["resume_equal"] = all(torch.equal(a, b) for a, b in zip(runs[0][:7], runs[1][:7]))
    out["resume_shape"] = tuple(runs[0].positions.shape)
    return out


def check_multihost_path(check, out, exact) -> dict:
    """Config #5's draws against the float64 quadrature of config #3's
    posterior (``posterior_means_f64``), R-hat and divergences; the resume
    bit for bit."""
    s = out["cli"]
    d = s["diagnostics"]
    print(f"config #5 (nuts_multihost, {s['n_chains']} chains, {C5_WARMUP} + {C5_SAMPLES} of "
          f"500 + 1000, chunks of {C5_CHUNK} through the checkpoints): {s['wall_s']:.2f} s, "
          f"{s['samples_per_s']:.1f} samples/s with warmup, {d['ess_per_s']:.1f} ESS/s (min ESS "
          f"{d['min_ess']:.0f}), mean leapfrog {s['mean_leapfrog']:.2f}, step "
          f"{s['step_size']:.4f}, accept {s['accept_rate']:.3f}, divergent "
          f"{s['divergence_frac']:.4f}, max R-hat {d['max_rhat']:.4f}, peak memory "
          f"{s['peak_memory_gb']:.2f} GB, mean {[round(m, 4) for m in s['posterior_mean']]} +- "
          f"{[round(e, 4) for e in s['posterior_mean_se']]} (quadrature "
          f"{[round(m, 4) for m in exact]})", flush=True)
    check("config #5 draws finite (0 = yes)", 0.0 if s["draws_finite"] else 1.0, 0.0)
    check("config #5 max split R-hat", d["max_rhat"], C5_RHAT)
    check("config #5 divergent fraction", s["divergence_frac"], NUTS_DIVERGENT)
    for i, name in enumerate(("h", "w", "s")):
        check(f"config #5 mean {name}: |mean - quadrature| / MC standard error",
              abs(s["posterior_mean"][i] - exact[i]) / s["posterior_mean_se"][i], C5_SE)
    check(f"config #5 resume at {out['resume_shape']}: chunked through checkpoints equals one "
          "pass bit for bit (0 = yes)", 0.0 if out["resume_equal"] else 1.0, 0.0)
    summary = {key: s[key] for key in (
        "wall_s", "samples_per_s", "accept_rate", "divergence_frac", "mean_leapfrog",
        "step_size", "posterior_mean", "posterior_mean_se", "n_samples", "n_chains",
        "peak_memory_gb")}
    summary.update(max_rhat=d["max_rhat"], min_ess=d["min_ess"], ess_per_s=d["ess_per_s"],
                   warmup=C5_WARMUP, resume_equal=out["resume_equal"])
    return summary


def run_row_twins_path(dev) -> dict:
    """The unsharded twins of the row-sharded calls, each timed on the host
    clock, synchronized; their inputs are kept for the row-sharded path."""
    import torch
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch.inference import make_log_posterior_iterative, pack
    from gaussian_processes_tpu_torch.utils import CONFIGS

    out = {}
    x, y, k = sine_problem(ITER_N, dev)
    opts = dict(ITER_OPTS, block_size=ROW_BLOCK)
    for key, fn in (("fit_b4", lambda: gpx.fit_iterative(k, x, y, ITER_NOISE, seed(20), **opts)),
                    ("fit", lambda: gpx.fit_iterative(k, x, y, ITER_NOISE, seed(20),
                                                      impl="strip", **opts))):
        out[key], out[f"{key}_wall_s"] = synced_wall(fn)
    out["se"] = (x, y, k)

    xs, ys, _ = sgpr_config_data(dev)
    z = gpx.kmeans_inducing(seed(CONFIGS["sparse1m_sgpr"].data.seed), xs, SGPR_M, iters=5)
    ks = gpx.GaussianKernel(1.0, 0.006, dtype=torch.float32, device=dev)
    gpx.fit_sgpr(ks, xs, ys, 0.1, z)
    out["sgpr"], out["sgpr_wall_s"] = synced_wall(lambda: gpx.fit_sgpr(ks, xs, ys, 0.1, z))
    out["sgpr_data"] = (xs, ys, z, ks)

    xb, yb, kb = sine_problem(ROW_BAYES_N, dev)
    u = pack(kb, ITER_NOISE).expand(2, 3) + torch.tensor(
        [[0.0, 0.0, 0.0], [0.1, -0.1, 0.05]], device=dev)
    lp = make_log_posterior_iterative(kb, xb, yb, probe_generator=seed(21), **ROW_BAYES_OPTS)
    lp.value_and_grad(u)  # the first call draws the probes and builds
    out["bayes"], out["bayes_wall_s"] = synced_wall(lambda: lp.value_and_grad(u))
    out["bayes_data"] = (xb, yb, kb, u)
    return out


def datasharded_log_posterior(twins, mesh):
    from gaussian_processes_tpu_torch import parallel

    xb, yb, kb, _ = twins["bayes_data"]
    return parallel.make_log_posterior_iterative_datasharded(
        kb, xb, yb, mesh, probe_generator=seed(21), block_size=ROW_BLOCK, **ROW_BAYES_OPTS)


def run_row_sharded_path(dev, twins) -> dict:
    """The row-sharded calls at W = 1 on their twins' data and draws, each
    timed on the host clock, synchronized."""
    from gaussian_processes_tpu_torch import parallel

    mesh = parallel.make_row_mesh(device=dev)
    out = {"mesh": mesh}
    x, y, k = twins["se"]
    out["fit_sharded"], out["fit_sharded_wall_s"] = synced_wall(
        lambda: parallel.fit_iterative_sharded(k, x, y, ITER_NOISE, seed(20), mesh=mesh,
                                               **dict(ITER_OPTS, block_size=ROW_BLOCK)))
    xs, ys, z, ks = twins["sgpr_data"]
    fn = lambda: parallel.fit_sgpr_sharded(ks, xs, ys, 0.1, z, mesh=mesh)  # noqa: E731
    fn()
    out["sgpr_sharded"], out["sgpr_sharded_wall_s"] = synced_wall(fn)
    u = twins["bayes_data"][3]
    lp = datasharded_log_posterior(twins, mesh)
    lp.value_and_grad(u)  # the first call draws the probes and builds
    out["bayes_sharded"], out["bayes_sharded_wall_s"] = synced_wall(lambda: lp.value_and_grad(u))
    return out


def planted_faults(twins, mesh) -> dict:
    """The data-sharded log posterior's value and gradient at the first
    position with one strip dropped: the last column block of the sharded
    matvec's strip product, or of the Jacobian strips (B2a) that its
    gradient sums.  Run after the paths' counted windows."""
    import torch
    from gaussian_processes_tpu_torch.ops import krylov

    xb, _, kb, u = twins["bayes_data"]
    u = u[:1]
    matvec, jacobian = krylov.kernel_matvec, type(kb).jacobian
    last = xb[-ROW_BLOCK:].data_ptr()

    def matvec_without_last_strip(kernel, x, v, *args, **kwargs):
        v = v.clone()
        v[-ROW_BLOCK:] = 0
        return matvec(kernel, x, v, *args, **kwargs)

    def jacobian_without_last_strip(self, x1, x2):
        J = jacobian(self, x1, x2)
        return torch.zeros_like(J) if x2.data_ptr() == last else J

    out = {}
    for key, module, name, fault in (
            ("matvec", krylov, "kernel_matvec", matvec_without_last_strip),
            ("jacobian", type(kb), "jacobian", jacobian_without_last_strip)):
        with _swap(module, name, fault):
            out[key] = datasharded_log_posterior(twins, mesh).value_and_grad(u)
    return out


def run_dryrun_path(dev) -> dict:
    """``dryrun.dryrun_multichip(1)`` on the card over the process group of
    one rank; it raises if a step fails."""
    from gaussian_processes_tpu_torch import dryrun

    return {"wall_s": synced_wall(lambda: dryrun.dryrun_multichip(1, device=dev))[1]}


def check_row_sharded_path(check, twins, out) -> dict:
    import torch

    x, y, k = twins["se"]
    a, b = twins["fit"].alpha, out["fit_sharded"].alpha
    alpha_rel = float(torch.linalg.norm(b - a) / torch.linalg.norm(a))
    res = true_residual(k, x, y, b)
    b4_rel = float(torch.linalg.norm(b - twins["fit_b4"].alpha) / torch.linalg.norm(a))
    print(f"row-sharded at W=1: fit_iterative_sharded {out['fit_sharded_wall_s']:.3f} s (strips "
          f"of {ROW_BLOCK}) vs fit_iterative {twins['fit_wall_s']:.3f} s on the same strips and "
          f"{twins['fit_b4_wall_s']:.3f} s on B4; alpha rel {alpha_rel:.3e} ({b4_rel:.3e} from "
          f"B4's), true residual {res:.3e}, lml {float(out['fit_sharded'].log_marginal):.3f} vs "
          f"{float(twins['fit'].log_marginal):.3f}", flush=True)
    check("row-sharded fit: ||alpha - fit_iterative's|| / ||alpha||", alpha_rel, ROW_ALPHA_REL)
    check("row-sharded fit: true residual (float64 matvec)", res, ITER_RESIDUAL)
    e, es = float(twins["sgpr"].log_marginal), float(out["sgpr_sharded"].log_marginal)
    sgpr_rel = abs(es - e) / abs(e)
    print(f"  fit_sgpr_sharded {out['sgpr_sharded_wall_s']:.4f} s vs fit_sgpr "
          f"{twins['sgpr_wall_s']:.4f} s at N={SGPR_N}, m={SGPR_M}: bound {es:.6f} vs {e:.6f} "
          f"(rel {sgpr_rel:.3e})", flush=True)
    check("row-sharded SGPR bound vs fit_sgpr (relative)", sgpr_rel, ROW_SGPR_REL)
    (v, g), (vs, gs) = twins["bayes"], out["bayes_sharded"]

    def rels(value, grad):
        r = (float((value - v[:len(value)]).abs().max() / v.abs().max()),
             float((grad - g[:len(grad)]).abs().max() / g.abs().max()))
        return tuple(e if math.isfinite(e) else math.inf for e in r)

    value_rel, grad_rel = rels(vs, gs)
    print(f"  data-sharded log posterior at N={ROW_BAYES_N}, 2 chains: "
          f"{out['bayes_sharded_wall_s']:.3f} s vs make_log_posterior_iterative "
          f"{twins['bayes_wall_s']:.3f} s; value rel {value_rel:.3e}, gradient rel {grad_rel:.3e}",
          flush=True)
    check("data-sharded log posterior value vs unsharded (relative)", value_rel,
          ROW_BAYES_VALUE_REL)
    check("data-sharded log posterior gradient vs unsharded (relative to its max)", grad_rel,
          ROW_BAYES_GRAD_REL)
    faults = {key: rels(*vg) for key, vg in planted_faults(twins, out["mesh"]).items()}
    print(f"  planted faults (value rel, gradient rel): matvec's last strip dropped "
          f"{faults['matvec'][0]:.3e}, {faults['matvec'][1]:.3e}; Jacobian's last strip dropped "
          f"{faults['jacobian'][0]:.3e}, {faults['jacobian'][1]:.3e}", flush=True)
    check("planted fault, matvec strip dropped: value limit / its value rel (< 1: caught)",
          ROW_BAYES_VALUE_REL / faults["matvec"][0], 1.0)
    check("planted fault, Jacobian strip dropped: gradient limit / its gradient rel (< 1: caught)",
          ROW_BAYES_GRAD_REL / faults["jacobian"][1], 1.0)
    return {"fit_wall_s": twins["fit_wall_s"], "fit_sharded_wall_s": out["fit_sharded_wall_s"],
            "fit_b4_wall_s": twins["fit_b4_wall_s"], "alpha_rel": alpha_rel,
            "alpha_rel_b4": b4_rel, "true_residual": res,
            "sgpr_wall_s": twins["sgpr_wall_s"],
            "sgpr_sharded_wall_s": out["sgpr_sharded_wall_s"], "sgpr_rel": sgpr_rel,
            "bayes_wall_s": twins["bayes_wall_s"],
            "bayes_sharded_wall_s": out["bayes_sharded_wall_s"], "bayes_value_rel": value_rel,
            "bayes_grad_rel": grad_rel, "fault_matvec_rel": faults["matvec"],
            "fault_jacobian_rel": faults["jacobian"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    import gaussian_processes_tpu_torch  # noqa: F401  (applies the precision policy)
    from gaussian_processes_tpu_torch.ops import _build
    from gaussian_processes_tpu_torch.utils import CONFIGS

    dev = torch.device("cuda", 0)
    t0 = t_start = time.perf_counter()
    lib = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"built {lib.name} in {build_s:.1f} s", flush=True)

    check = Checks()
    check_kernels_small(check, dev)
    check_products_small(check, dev)
    check_ard_products_small(check, dev)
    check_jac_products_small(check, dev)
    check_new_products_small(check, dev)
    check_rq_log(check, dev)
    check_ard_pairwise_small(check, dev)
    slice_rows = check_kernels_at_slice(check, dev)
    check_products_at_slice(check, dev, slice_rows)
    check_new_kernels_at_slice(check, dev, slice_rows)
    check_chain_kernels(check, dev, slice_rows)
    check_slice4_kernels(check, dev, slice_rows)
    check_slice5_kernels(check, dev, slice_rows)
    check_blockcyclic_kernel(check, dev, slice_rows)
    print(f"kernel checks and timings done ({time.perf_counter() - t_start:.1f} s from the "
          "start)", flush=True)

    # slice 5's paths run over an NCCL process group of one rank
    from gaussian_processes_tpu_torch import parallel

    cluster = parallel.initialize_cluster(f"127.0.0.1:{free_port()}", 1, 0)
    print(f"process group: {cluster}", flush=True)
    check("an NCCL process group of one rank (0 = yes)",
          0.0 if (cluster["backend"], cluster["process_count"]) == ("nccl", 1) else 1.0, 0.0)

    fit_cfg = CONFIGS["config1_fit_se500"].fit
    # each path runs with the counters at 0 and is read just after
    launches_by_path = {}
    runs = {}
    path_wall_s = {}
    for path, run in (("exact", lambda: run_main_path(dev)),
                      ("matrix-free", lambda: run_iterative_path(dev)),
                      *((p, lambda p=p: run_sampler_path(dev, p)) for p in ("mle", "chees", "nuts")),
                      ("exact-new", lambda: run_new_exact_path(dev)),
                      ("matrix-free-new", lambda: run_new_iterative_path(dev)),
                      ("matrix-free-tree", lambda: run_tree_iterative_path(dev)),
                      *((p, lambda p=p: run_new_sampler_path(dev, p))
                        for p in ("mle-rq", "chees-matern52")),
                      ("chains-tree", lambda: run_chains_tree_path(dev)),
                      ("fit-large-twin", lambda: run_fit_large_twin_path(dev)),
                      ("fit-large", lambda: run_fit_large_path(dev)),
                      ("toeplitz", lambda: run_toeplitz_path(dev)),
                      ("whittle", lambda: run_whittle_path(dev)),
                      ("bayes-grid", lambda: run_bayes_grid_path(dev)),
                      ("ski", lambda: run_ski_path(dev)),
                      ("ski-refine", lambda: run_ski_refine_path(dev)),
                      *slice4_paths(dev),
                      ("multihost-chains", lambda: run_multihost_path(dev)),
                      ("row-twins", lambda: run_row_twins_path(dev)),
                      ("row-sharded", lambda: run_row_sharded_path(dev, runs["row-twins"])),
                      ("dryrun", lambda: run_dryrun_path(dev))):
        t0 = time.perf_counter()
        _build.launch_counts.clear()
        runs[path] = run()
        counts = dict(_build.launch_counts)
        path_wall_s[path] = time.perf_counter() - t0
        launches_by_path[path] = counts
        print(f"launches on the {path} path ({path_wall_s[path]:.1f} s): {counts}", flush=True)
        for key in PATH_KERNELS[path]:
            check(f"{key} launched on the {path} path (0 = yes)",
                  0.0 if counts.get(key, 0) > 0 else 1.0, 0.0)
    t_checks = time.perf_counter()
    out, iter_out = runs["exact"], runs["matrix-free"]
    check_main_path(check, out, fit_cfg.noise, fit_cfg.jitter)
    iter_summary = check_iterative_path(check, iter_out, dev)
    sampler_summary = check_sampler_paths(check, runs, dev)
    check_new_exact_path(check, runs["exact-new"], dev)
    iter_summary.update(check_new_iterative_path(check, runs["matrix-free-new"]))
    iter_summary.update(check_tree_iterative_path(check, runs["matrix-free-tree"]))
    sampler_summary.update(check_new_sampler_paths(check, runs, dev))
    check_chains_tree_path(check, runs["chains-tree"])
    slice3 = {"fit_large": check_fit_large_path(check, runs.pop("fit-large-twin"),
                                                runs.pop("fit-large"),
                                                launches_by_path["fit-large"], dev),
              "toeplitz": check_toeplitz_path(check, runs.pop("toeplitz"), dev, slice_rows),
              "whittle": check_whittle_path(check, runs.pop("whittle"), dev),
              "bayes_grid": check_bayes_grid_path(check, runs.pop("bayes-grid")),
              "ski": check_ski_path(check, runs.pop("ski")),
              "ski_refine": check_ski_refine_path(check, runs.pop("ski-refine"))}
    slice5 = {"config5": check_multihost_path(check, runs.pop("multihost-chains"),
                                              sampler_summary["posterior_mean_quadrature"]),
              "row_sharded": check_row_sharded_path(check, runs.pop("row-twins"),
                                                    runs.pop("row-sharded")),
              "dryrun": runs.pop("dryrun")}
    parallel.shutdown_cluster()
    slice4 = check_slice4_paths(check, runs, dev)

    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(launches_by_path[p].get(key, 0)
                         for p in (paths[0] if paths else launches_by_path)),
         **{field: slice_rows[row][field] for field in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, key, row, source, replaces, *paths in KERNEL_ROWS
    ]
    print(f"checks after the paths: {time.perf_counter() - t_checks:.1f} s; "
          f"{time.perf_counter() - t_start:.1f} s from the start", flush=True)
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed: {check.failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "build_s": build_s,
        "fit_wall_s": {n: out[f"cli_{n}"]["fit_wall_s"] for n in FIT_NS},
        "grad_hess_wall_s": {d: out[f"grad_hess_{d}"][4] for d in ("float32", "float64")},
        "cholesky_blocked": slice_rows["cholesky_blocked"],
        "pairwise_hess_all_planes": slice_rows["pairwise_hess_all_planes"],
        **{key: slice_rows[key] for key in (
            "chol_tile", "chol_tile_batch64", "kernel_matvec_r8", "kernel_matvec_r9",
            "kernel_matvec_r64",
            "kernel_matvec_periodic", "kernel_matvec_periodic_r8", "kernel_jacvec_periodic",
            "kernel_matvec_ard_r1", "kernel_matvec_ard_r64", "pairwise_ard_pivot_column",
            "pairwise_ard_pivot_row", "pairwise_k_pivot_column", "pairwise_k_pivot_row",
            "pairwise_hess_00", "pairwise_hess_11")},
        "sfu_floor_ms": {row: slice_rows[row]["sfu_floor_ms"] for _, _, row, *_ in KERNEL_ROWS
                         if "sfu_floor_ms" in slice_rows[row]},
        **{key: slice_rows[key] for key in (
            "pairwise_k_chains_periodic", "pairwise_jac_chains_periodic",
            "pairwise_jac_contract_chains_periodic", "cholesky_blocked_chains", "value_and_grad_chains", "tree_jacobian_chains",
            "pairwise_k_tree_16384", "kernel_matvec_matern52_r8", "kernel_matvec_matern52_r9",
            "kernel_matvec_tree_r8", *(f"pairwise_k_{fam}_pivot_row" for fam in NEW_FAMILY_OPS))},
        "launches_by_path": launches_by_path,
        "path_wall_s": path_wall_s,
        "samplers": sampler_summary,
        "strip_matvec_ms": {r: slice_rows[f"strip_matvec_r{r}"]["ms"] for r in (1, 8)},
        "iterative": iter_summary,
        "slice3": slice3,
        "slice4": slice4,
        "slice5": slice5,
        **{key: slice_rows[key] for key in ("pairwise_k_chains_1024", "pairwise_jac_chains_1024",
                                            "chol_tile_inv_chains_1024", "pairwise_k_row_strip",
                                            "pairwise_k_blockcyclic_strip",
                                            "pairwise_jac_contract_chains_1024")},
    }))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
