"""Prediction requests against one block-cyclic fit.

Set-up fits one data set through ``parallel.fit_blockcyclic`` and warms the
prediction path; every call of the window is one request: ``n_test`` test
points drawn uniformly from (seed, request index), their predictive mean and
variance from ``parallel.predict_diag_blockcyclic`` (B1's cross-covariance
and the blocked forward substitution).  The check factors the same data in
float64 itself and holds a sample of the window's requests to it.
"""

from __future__ import annotations

import torch

from perfbench import data, program
from perfbench.reference import arith as ar
from perfbench.reference import dense


def _reference_predictor(cfg, x, y, arith, block, out_dtype=None):
    alpha, _, L = dense.fit(x, y, cfg["h"], cfg["w"], cfg["noise"], cfg["jitter"], arith, block,
                            keep_factor=True)

    def predict(xo):
        mean, var = dense.predict(L, x, alpha, xo, cfg["h"], cfg["w"], arith, block)
        return (mean, var) if out_dtype is None else (mean.to(out_dtype), var.to(out_dtype))

    return predict


def setup(ctx):
    cfg = ctx.config
    dtype = getattr(torch, cfg["dtype"])
    x, y = data.draw_fit_data(ctx.seed, "data", 0, cfg, dtype, ctx.device)
    st = {"dtype": dtype}
    if ctx.control:
        st["predict"] = _reference_predictor(cfg, x, y, ar.arith(ctx.control),
                                             ctx.traffic["reference_block"], dtype)
    else:
        from gaussian_processes_tpu_torch.parallel import block_cholesky as bc

        mesh = program.block_mesh(ctx.device)
        kernel = program.se_kernel(cfg, dtype, ctx.device)
        post = bc.fit_blockcyclic(kernel, x, y, cfg["noise"], mesh,
                                  block_size=cfg["block_size"], jitter=cfg["jitter"])
        st["predict"] = lambda xo: bc.predict_diag_blockcyclic(post, xo, mesh)
    for j in range(ctx.traffic["warm_requests"]):
        st["predict"](data.draw_test_points(ctx.seed, "warm", j, ctx.traffic["n_test"], cfg,
                                            dtype, ctx.device))
    return st


def call(ctx, st, i):
    xo = data.draw_test_points(ctx.seed, "request", i, ctx.traffic["n_test"], ctx.config,
                               st["dtype"], ctx.device)
    mean, var = st["predict"](xo)
    ctx.synchronize()
    return {"mean": mean, "var": var, "finite": torch.isfinite(mean).all() & torch.isfinite(var).all()}


def end_to_end(ctx, st, records, window_s):
    return {"predict_p95_ms": 1e3 * data.percentile([r["latency_s"] for r in records], 95)}


def counters(ctx, st, records):
    return {"requests": len(records), "n": ctx.config["n"], "n_test": ctx.traffic["n_test"]}


def release(ctx, st):
    st.clear()


def check(ctx, records, kept):
    cfg, lim = ctx.config, ctx.traffic["limits"]
    dtype = getattr(torch, cfg["dtype"])
    x, y = data.draw_fit_data(ctx.seed, "data", 0, cfg, dtype, ctx.device)
    predict = _reference_predictor(cfg, x, y, ar.FLOAT64, ctx.traffic["reference_block"])
    mean_gap = var_gap = 0.0
    for i in data.sample_indices(ctx.seed, len(records), ctx.traffic["check_calls"]):
        xo = data.draw_test_points(ctx.seed, "request", i, ctx.traffic["n_test"], cfg, dtype,
                                   ctx.device)
        m_ref, v_ref = predict(xo)
        rec = records[i]
        mean_gap = data.worse(mean_gap, float(torch.max(torch.abs(rec["mean"].double() - m_ref))))
        var_gap = data.worse(var_gap, float(torch.max(torch.abs(rec["var"].double() - v_ref))))
    return [("mean_gap", mean_gap, lim["mean_gap"]), ("var_gap", var_gap, lim["var_gap"])]
