"""Fresh exact fits through ``parallel.fit_blockcyclic``.

Every call draws a new data set of the configuration's size and law from
(seed, call index) on the card and fits it: no call can reuse an earlier
factor.  Set-up warms the path with one fit of its own data set.  The check
draws a sample of the window's calls from the seed, draws their data again,
and holds the program's alpha and log marginal likelihood to the float64
reference fit of the same arrays, with the true residual of the program's
alpha beside them.
"""

from __future__ import annotations

import torch

from perfbench import data, program
from perfbench.reference import arith as ar
from perfbench.reference import dense


def _reference_fit(cfg, x, y, arith, block):
    alpha, lml, _ = dense.fit(x, y, cfg["h"], cfg["w"], cfg["noise"], cfg["jitter"], arith, block)
    return alpha.to(x.dtype), lml.to(x.dtype)


def setup(ctx):
    cfg = ctx.config
    dtype = getattr(torch, cfg["dtype"])
    st = {"dtype": dtype}
    if ctx.control:
        arith = ar.arith(ctx.control)
        st["fit"] = lambda x, y: _reference_fit(cfg, x, y, arith, ctx.traffic["reference_block"])
    else:
        from gaussian_processes_tpu_torch.parallel import block_cholesky as bc

        mesh = program.block_mesh(ctx.device)
        kernel = program.se_kernel(cfg, dtype, ctx.device)

        def fit(x, y):
            post = bc.fit_blockcyclic(kernel, x, y, cfg["noise"], mesh,
                                      block_size=cfg["block_size"], jitter=cfg["jitter"])
            return post.alpha, post.log_marginal

        st["fit"] = fit
    st["fit"](*data.draw_fit_data(ctx.seed, "warm", 0, cfg, dtype, ctx.device))
    return st


def call(ctx, st, i):
    x, y = data.draw_fit_data(ctx.seed, "call", i, ctx.config, st["dtype"], ctx.device)
    alpha, lml = st["fit"](x, y)
    ctx.synchronize()
    return {"alpha": alpha, "lml": lml, "finite": torch.isfinite(alpha).all() & torch.isfinite(lml)}


def end_to_end(ctx, st, records, window_s):
    return {"fit_s": window_s / len(records)}


def counters(ctx, st, records):
    return {"fits": len(records), "n": ctx.config["n"]}


def release(ctx, st):
    st.clear()


def check(ctx, records, kept):
    cfg, lim = ctx.config, ctx.traffic["limits"]
    diag = cfg["noise"] ** 2 + cfg["jitter"]
    worst = {"lml_rel": 0.0, "alpha_rel": 0.0, "residual": 0.0}
    for i in data.sample_indices(ctx.seed, len(records), ctx.traffic["check_calls"]):
        x, y = data.draw_fit_data(ctx.seed, "call", i, cfg, getattr(torch, cfg["dtype"]),
                                  ctx.device)
        rec = records[i]
        alpha = rec["alpha"].double()
        res = dense.residual(x, y, alpha, cfg["h"], cfg["w"], diag)
        a_ref, l_ref, _ = dense.fit(x, y, cfg["h"], cfg["w"], cfg["noise"], cfg["jitter"],
                                    ar.FLOAT64, ctx.traffic["reference_block"])
        got = {"lml_rel": float(abs(rec["lml"].double() - l_ref) / abs(l_ref)),
               "alpha_rel": float(torch.linalg.vector_norm(alpha - a_ref)
                                  / torch.linalg.vector_norm(a_ref)),
               "residual": res}
        for k, v in got.items():
            worst[k] = data.worse(worst[k], v)
    return [(k, v, lim[k]) for k, v in worst.items()]
