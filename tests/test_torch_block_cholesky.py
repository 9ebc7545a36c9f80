"""Port dense factor across ranks (parallel/block_cholesky.py, distributed_gp.py).

Eight gloo ranks, brought up once for the file by a module fixture, run this
file's ``__main__`` code; the JAX package computes the references on its
8-device virtual CPU mesh meanwhile.  Float64.  Case for case the JAX
package's ``tests/test_block_cholesky.py`` and
``tests/test_parallel.py::test_sharded_fit_matches_single_device``:

* ``fit_blockcyclic`` at (n, b) = (128, 8), (200, 8), (256, 16), SE: lml
  within 1e-10 and alpha within 1e-7 (atol 1e-9) of the JAX package's
  ``fit_blockcyclic`` and ``fit``; periodic at n = 150 (padding) 1e-10;
  predictions at n = 192, mean 1e-8 and variance 1e-6 (atol 1e-10); the
  ranks' factored strips equal the JAX ``L_blocks`` on every block j <= g to
  1e-10; the JAX posterior cut into the ranks' strips by ``convert``
  predicts as the JAX package does, to 1e-10;
* ``fit_sharded`` on the 2 x 4 grid at n = 64: lml 1e-10, alpha 1e-8,
  predictions 1e-8 and 1e-6;
* the CLI's ``fit_large`` at n = 512 over the eight ranks against the JAX
  package's ``fit``, 1e-8;
* ``_forward_solve`` and ``_backward_solve`` at n = 305 (padded), b in
  {8, 12, 64} (12: the diagonal inverses' odd base) and r in {1, 5, 200}
  against float64 ``solve_triangular`` on the lower factor assembled from
  the ranks' strips, and the ``solve.diag_inverses`` counter (m_loc a
  solve).

In the test process, with no process group: one rank against the JAX
package (SE and Matérn 5/2), the solves' cases above at W = 1, config #4's
law at n = 4096 in float32 against float64 (the benchmark's ``mean_gap`` and
``var_gap`` limits), the grid's shape for 1..8 devices, the inputs both
packages refuse with ``ValueError``, and ``parallel.__all__``.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, launch_ranks, make_xy, wait_ranks
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

WORLD = 8
SE_PARAMS, NOISE = (1.2, 0.7), 0.2
BC_CASES = [(128, 8), (200, 8), (256, 16)]
STRIP_CASE = (200, 8)  # whose factored strips are compared block by block
PERIODIC = ((1.0, 1.0, 0.5), 150, 8, 0.15)  # params, n, b, noise
PRED = ((1.0, 0.6), 192, 8, 40)  # params, n, b, prediction points
GRID_N, GRID_XO = 64, 32
CLI_N = 512
SOLVE_N, SOLVE_BS, SOLVE_RS = 305, (8, 12, 64), (1, 5, 200)  # n is no multiple of b W


def _data(n, seed=0):
    """``tests/test_block_cholesky.py::_data``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    return x, np.sin(2 * x) + 0.1 * rng.standard_normal(n)


def _xo(m):
    """``gaussian_processes_tpu.utils.testing.make_xo``."""
    return np.linspace(-np.pi, np.pi, m)


def _cli_config():
    from gaussian_processes_tpu_torch.utils import CONFIGS

    cfg = CONFIGS["config4_large_n"]
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n=CLI_N),
                               fit=dataclasses.replace(cfg.fit, dtype="float64"))


def _jax_kernel(family, params):
    import jax.numpy as jnp

    import gaussian_processes_tpu as gpt

    cls = {"se": gpt.GaussianKernel, "periodic": gpt.PeriodicKernel,
           "matern52": gpt.Matern52Kernel}[family]
    return cls(*(jnp.float64(p) for p in params))


def _port_kernel(family, params):
    from gaussian_processes_tpu_torch.convert import kernel_from_numpy

    return kernel_from_numpy(family, params)


def _np(tree):
    return tuple(np.asarray(t) for t in tree)


def _solve_rhs(n_pad, r):
    """The right-hand side every rank (and the test) draws for width r."""
    return torch.randn(n_pad, r, generator=torch.Generator().manual_seed(n_pad + r),
                       dtype=torch.float64)


def _solve_case(mesh, b):
    """A factored strip of n = SOLVE_N, its forward and backward solves of
    each width, and the counter's rise over one solve of each kind."""
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.parallel import block_cholesky as bc
    from gaussian_processes_tpu_torch.utils.profiling import counts

    x, y = _data(SOLVE_N, seed=4)
    post = par.fit_blockcyclic(_port_kernel("se", SE_PARAMS), torch.as_tensor(x),
                               torch.as_tensor(y), NOISE, mesh, block_size=b, jitter=1e-6)
    S, m = post.L_blocks, post.n_blocks
    out = {"strip": S, "m": m, "Y": {}, "Z": {}}
    for r in SOLVE_RS:
        rhs = _solve_rhs(m * b, r)
        before = counts["solve.diag_inverses"]
        out["Y"][r] = bc._forward_solve(S, rhs, mesh, m, b)
        middle = counts["solve.diag_inverses"]
        out["Z"][r] = bc._backward_solve(S, rhs, mesh, m, b)
        out["inverses"] = (middle - before, counts["solve.diag_inverses"] - middle)
    return out


def _assembled_factor(strips, m, b):
    """The global lower factor from the ranks' strips (row block l of rank
    w is global block w + l W)."""
    world = len(strips)
    L = torch.zeros(m * b, m * b, dtype=strips[0].dtype)
    for w, strip in enumerate(strips):
        for l in range(m // world):
            g = w + l * world
            L[g * b:(g + 1) * b] = strip[l * b:(l + 1) * b]
    return torch.tril(L)


def _jax_prediction_case():
    """The JAX posterior the ranks convert, with its predictions."""
    from gaussian_processes_tpu.parallel import (
        fit_blockcyclic,
        make_chain_mesh,
        predict_diag_blockcyclic,
    )

    params, n, b, m = PRED
    x, y = _data(n, seed=1)
    mesh = make_chain_mesh(WORLD, axis="shard")
    post = fit_blockcyclic(_jax_kernel("se", params), x, y, NOISE, mesh, block_size=b,
                           jitter=0.0)
    mean, var = predict_diag_blockcyclic(post, _xo(m), mesh)
    return {"L_blocks": np.asarray(post.L_blocks), "alpha": np.asarray(post.alpha),
            "lml": np.asarray(post.log_marginal), "mean": np.asarray(mean),
            "var": np.asarray(var)}


def _jax_results():
    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.parallel import (
        fit_blockcyclic,
        fit_sharded,
        make_chain_mesh,
        make_grid_mesh,
        predict_diag_sharded,
    )
    from gaussian_processes_tpu.utils import config as jconfig

    mesh = make_chain_mesh(WORLD, axis="shard")
    k = _jax_kernel("se", SE_PARAMS)
    out = {}
    for n, b in BC_CASES:
        x, y = _data(n)
        bc = fit_blockcyclic(k, x, y, NOISE, mesh, block_size=b, jitter=0.0)
        dense = gpt.fit(k, x, y, NOISE)
        out[n, b] = {"bc": _np((bc.alpha, bc.log_marginal)),
                     "dense": _np((dense.alpha, dense.log_marginal))}
        if (n, b) == STRIP_CASE:
            out["L_blocks"] = np.asarray(bc.L_blocks)
    params, n, b, noise = PERIODIC
    x, y = _data(n, seed=3)
    kp = _jax_kernel("periodic", params)
    out["periodic"] = (float(fit_blockcyclic(kp, x, y, noise, mesh, block_size=b,
                                             jitter=0.0).log_marginal),
                       float(gpt.fit(kp, x, y, noise).log_marginal))
    params, n, b, m = PRED
    x, y = _data(n, seed=1)
    out["pred_dense"] = _np(gpt.predict_diag(gpt.fit(_jax_kernel("se", params), x, y, NOISE),
                                             _xo(m)))
    x, y = make_xy(np.random.default_rng(0), GRID_N)
    k0 = _jax_kernel("se", (1.0, 1.0))
    grid = make_grid_mesh(WORLD)
    post = fit_sharded(k0, x, y, NOISE, grid, jitter=0.0)
    dense = gpt.fit(k0, x, y, NOISE)
    out["grid"] = {"shape": grid.devices.shape, "lml": float(post.log_marginal),
                   "alpha": np.asarray(post.alpha), "dense_lml": float(dense.log_marginal),
                   "dense_alpha": np.asarray(dense.alpha),
                   "pred": _np(predict_diag_sharded(post, _xo(GRID_XO), grid)),
                   "pred_dense": _np(gpt.predict_diag(dense, _xo(GRID_XO)))}
    cfg = _cli_config()
    x, y, _ = jconfig.make_data(cfg.data, dtype="float64")
    out["cli"] = float(gpt.fit(_jax_kernel("se", (1.0, 1.0)), x, y, cfg.fit.noise,
                               cfg.fit.jitter).log_marginal)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("block_cholesky")
    pred = _jax_prediction_case()
    torch.save(pred, out / "jax_pred.pt")
    procs = launch_ranks(__file__, WORLD, out)
    want = _jax_results()
    want["pred"] = pred
    return wait_ranks(procs, out), want


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,b", BC_CASES)
def test_blockcyclic_matches_jax(runs, n, b):
    ranks, want = runs
    for r in ranks:
        alpha, lml = r[n, b]
        for ref in ("bc", "dense"):
            _close(lml, want[n, b][ref][1], 1e-10)
            _close(alpha, want[n, b][ref][0], 1e-7, 1e-9)


def test_blockcyclic_periodic_and_padding(runs):
    ranks, want = runs
    for r in ranks:
        for ref in want["periodic"]:
            _close(r["periodic"], ref, 1e-10)


def test_blockcyclic_predict_matches_jax(runs):
    ranks, want = runs
    for r in ranks:
        mean, var = r["pred"]
        for ref_mean, ref_var in ((want["pred"]["mean"], want["pred"]["var"]),
                                  want["pred_dense"]):
            _close(mean, ref_mean, 1e-8, 1e-10)
            _close(var, ref_var, 1e-6, 1e-10)


def test_factored_strips_equal_jax_L_blocks(runs):
    ranks, want = runs
    jax_blocks = want["L_blocks"]
    m, b = jax_blocks.shape[0], jax_blocks.shape[2]
    m_loc = m // WORLD
    for rank, r in enumerate(ranks):
        strip = r["strip"].numpy()
        assert strip.shape == (m_loc * b, m * b)
        mine = strip.reshape(m_loc, b, m, b).transpose(0, 2, 1, 3)
        for l in range(m_loc):
            g = rank + l * WORLD
            _close(mine[l, :g + 1], jax_blocks[rank * m_loc + l, :g + 1], 1e-10, 1e-10)


def test_converted_jax_posterior_predicts_as_jax(runs):
    ranks, want = runs
    for r in ranks:
        mean, var = r["converted"]
        _close(mean, want["pred"]["mean"], 1e-10, 1e-12)
        _close(var, want["pred"]["var"], 1e-10, 1e-12)


def test_fit_sharded_on_the_grid_matches_jax(runs):
    ranks, want = runs
    g = want["grid"]
    for r in ranks:
        alpha, lml, (mean, var), shape = r["grid"]
        assert shape == tuple(g["shape"]) == (2, 4)
        for ref_lml, ref_alpha in ((g["lml"], g["alpha"]), (g["dense_lml"], g["dense_alpha"])):
            _close(lml, ref_lml, 1e-10)
            _close(alpha, ref_alpha, 1e-8)
        for ref_mean, ref_var in (g["pred"], g["pred_dense"]):
            _close(mean, ref_mean, 1e-8)
            _close(var, ref_var, 1e-6, 1e-10)


def test_cli_fit_large_over_eight_ranks_matches_jax_fit(runs):
    ranks, want = runs
    for r in ranks:
        s = r["cli"]
        assert s["block_size"] == 64 and s["mesh"] == "{'shard': 8}"
        assert s["pred_rmse_vs_truth"] < 0.05
        _close(s["log_marginal"], want["cli"], 1e-8)


@functools.lru_cache(maxsize=None)
def _one_rank_solve_case(b):
    from gaussian_processes_tpu_torch import parallel as par

    mesh = par.make_chain_mesh(axis="shard", device="cpu")
    assert mesh.world_size == 1 and mesh.group is None
    return [_solve_case(mesh, b)]


def _solve_cases(request, world, b):
    if world == 1:
        return _one_rank_solve_case(b)
    return [r["solves"][b] for r in request.getfixturevalue("runs")[0]]


@pytest.mark.parametrize("r", SOLVE_RS)
@pytest.mark.parametrize("b", SOLVE_BS)
@pytest.mark.parametrize("world", [1, WORLD])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_solves_match_float64_triangular_solves(request, direction, world, b, r):
    cases = _solve_cases(request, world, b)
    m = cases[0]["m"]
    assert m * b > SOLVE_N  # padded
    L = _assembled_factor([c["strip"] for c in cases], m, b)
    rhs = _solve_rhs(m * b, r)
    if direction == "forward":
        want, key = torch.linalg.solve_triangular(L, rhs, upper=False), "Y"
    else:
        want, key = torch.linalg.solve_triangular(L.T, rhs, upper=True), "Z"
    for c in cases:
        got = c[key][r]
        assert got.shape == (m * b, r) and got.dtype == torch.float64
        _close(got, want, 1e-10, 1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("world", [1, WORLD])
def test_each_solve_counts_its_diagonal_inverses(request, world):
    for b in SOLVE_BS:
        cases = _solve_cases(request, world, b)
        m_loc = cases[0]["m"] // world
        for c in cases:
            assert c["inverses"] == (m_loc, m_loc)


# ---------------------------------------------------------------------------
# in the test process: one rank, no process group


@pytest.mark.parametrize("family,params", [("se", SE_PARAMS), ("matern52", (1.1, 0.9))])
def test_one_rank_without_a_group_matches_jax(family, params):
    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.parallel import fit_blockcyclic as jfit
    from gaussian_processes_tpu.parallel import make_chain_mesh as jmesh
    from gaussian_processes_tpu.parallel import predict_diag_blockcyclic as jpredict
    from gaussian_processes_tpu_torch import parallel as par

    x, y = _data(100, seed=2)
    mesh = par.make_chain_mesh(axis="shard", device="cpu")
    assert mesh.world_size == 1 and mesh.group is None
    post = par.fit_blockcyclic(_port_kernel(family, params), torch.as_tensor(x),
                               torch.as_tensor(y), NOISE, mesh, block_size=16, jitter=1e-6)
    k, jm = _jax_kernel(family, params), jmesh(1, axis="shard")
    want = jfit(k, x, y, NOISE, jm, block_size=16, jitter=1e-6)
    dense = gpt.fit(k, x, y, NOISE, 1e-6)
    for ref in (want, dense):
        _close(post.log_marginal, ref.log_marginal, 1e-10)
        _close(post.alpha, ref.alpha, 1e-7, 1e-9)
    mean, var = par.predict_diag_blockcyclic(post, torch.as_tensor(_xo(25)), mesh)
    ref_mean, ref_var = jpredict(want, _xo(25), jm)
    _close(mean, ref_mean, 1e-8, 1e-10)
    _close(var, ref_var, 1e-6, 1e-10)


def test_float32_predictions_of_config4_law_hold_the_benchmark_limits():
    """Config #4's law at n = 4096, b = 256, float32 at one rank: the
    predictive variance within 1e-5 and the mean within 1e-2 of float64
    (``var_gap`` and ``mean_gap`` of the benchmark's predict cell)."""
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch import parallel as par

    rng = np.random.default_rng(16)
    n, noise, jitter = 4096, 0.1, 1e-4
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(np.float32)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    xo = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    mesh = par.make_chain_mesh(axis="shard", device="cpu")
    k32 = gpx.GaussianKernel(1.0, 1.0, dtype=torch.float32)
    post = par.fit_blockcyclic(k32, torch.as_tensor(x), torch.as_tensor(y), noise, mesh,
                               block_size=256, jitter=jitter)
    mean, var = par.predict_diag_blockcyclic(post, torch.as_tensor(xo), mesh)
    assert mean.dtype == var.dtype == torch.float32

    x64, y64, xo64 = (torch.as_tensor(a, dtype=torch.float64) for a in (x, y, xo))

    def se(a, c):  # h = w = 1
        return torch.exp(-0.5 * (a[:, None] - c[None, :]) ** 2)

    L = torch.linalg.cholesky(se(x64, x64) + (noise ** 2 + jitter) * torch.eye(n))
    Kxo = se(xo64, x64)
    want_mean = Kxo @ torch.cholesky_solve(y64[:, None], L)[:, 0]
    v = torch.linalg.solve_triangular(L, Kxo.T, upper=False)
    want_var = 1.0 - torch.sum(v * v, dim=0)
    assert float(torch.max(torch.abs(mean.double() - want_mean))) < 1e-2
    assert float(torch.max(torch.abs(var.double() - want_var))) < 1e-5


@pytest.mark.parametrize("n_devices", range(1, WORLD + 1))
def test_grid_shape_matches_jax(n_devices):
    from gaussian_processes_tpu.parallel import make_grid_mesh as jgrid
    from gaussian_processes_tpu_torch.parallel.distributed_gp import grid_shape

    assert grid_shape(n_devices) == jgrid(n_devices).devices.shape


def test_grid_mesh_of_one_rank_fits_as_fit():
    import gaussian_processes_tpu_torch as gpx
    from gaussian_processes_tpu_torch import parallel as par

    grid = par.make_grid_mesh(device="cpu")
    assert grid.shape == (1, 1) and grid.i.group is None and grid.j.group is None
    x, y = (torch.as_tensor(a) for a in make_xy(np.random.default_rng(0), 40))
    k = _port_kernel("se", (1.0, 1.0))
    noise = torch.linspace(0.1, 0.3, 40, dtype=torch.float64)  # per point, as build_kxx
    post, want = par.fit_sharded(k, x, y, noise, grid), gpx.fit(k, x, y, noise, 1e-6)
    _close(post.log_marginal, want.log_marginal, 1e-12)
    mean, var = par.predict_diag_sharded(post, torch.as_tensor(_xo(9)), grid)
    _close(mean, gpx.predict_diag(want, torch.as_tensor(_xo(9)))[0], 1e-12)


def _refusals():
    """(JAX call, port call) pairs that both packages refuse with ValueError."""
    import gaussian_processes_tpu as gpt  # noqa: F401  (x64 and the kernels)
    from gaussian_processes_tpu import parallel as jpar
    from gaussian_processes_tpu_torch import parallel as tpar

    x, y = _data(64)
    k, kt = _jax_kernel("se", (1.0, 1.0)), _port_kernel("se", (1.0, 1.0))
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)

    def bc(pkg, kern, xx, yy, noise):
        mesh = (jpar.make_chain_mesh(WORLD, axis="shard") if pkg is jpar
                else tpar.make_chain_mesh(axis="shard", device="cpu"))
        return lambda: pkg.fit_blockcyclic(kern, xx, yy, noise, mesh, block_size=4)

    def grid(pkg, kern, xx, yy, axes=("i", "j")):
        mesh = jpar.make_grid_mesh(WORLD) if pkg is jpar else tpar.make_grid_mesh(device="cpu")
        return lambda: pkg.fit_sharded(kern, xx, yy, NOISE, mesh, axes=axes)

    return {
        "blockcyclic 2-D x": (bc(jpar, k, x[:, None], y, NOISE),
                              bc(tpar, kt, tx[:, None], ty, NOISE)),
        "blockcyclic per-point noise": (bc(jpar, k, x, y, np.full(64, NOISE)),
                                        bc(tpar, kt, tx, ty, torch.full((64,), NOISE))),
        "blockcyclic y of another length": (bc(jpar, k, x, y[:60], NOISE),
                                            bc(tpar, kt, tx, ty[:60], NOISE)),
        "fit_sharded unknown axes": (grid(jpar, k, x, y, ("a", "b")),
                                     grid(tpar, kt, tx, ty, ("a", "b"))),
        "fit_sharded y of another length": (grid(jpar, k, x, y[:60]), grid(tpar, kt, tx, ty[:60])),
    }


@pytest.mark.parametrize("case", ["blockcyclic 2-D x", "blockcyclic per-point noise",
                                  "blockcyclic y of another length", "fit_sharded unknown axes",
                                  "fit_sharded y of another length"])
def test_both_packages_refuse(case):
    jax_call, port_call = _refusals()[case]
    with pytest.raises(ValueError):
        jax_call()
    with pytest.raises(ValueError):
        port_call()


def test_parallel_exports_every_jax_name():
    from gaussian_processes_tpu import parallel as jpar
    from gaussian_processes_tpu_torch import parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    assert set(tpar.__all__) - set(jpar.__all__) == {
        "RankMesh", "make_mesh", "shutdown_cluster", "BayesMesh", "GridMesh",
        "checkpoint_nuts_sharded"}


# ---------------------------------------------------------------------------
# rank side: ``python tests/test_torch_block_cholesky.py OUT_DIR`` under a launcher


def _rank_main(out_dir):
    torch.set_num_threads(1)
    from gaussian_processes_tpu_torch import cli
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.convert import blockcyclic_posterior_from_numpy

    par.initialize_cluster(backend="gloo")
    mesh = par.make_chain_mesh(axis="shard", device="cpu")
    t = torch.as_tensor
    out = {}
    k = _port_kernel("se", SE_PARAMS)
    for n, b in BC_CASES:
        x, y = _data(n)
        post = par.fit_blockcyclic(k, t(x), t(y), NOISE, mesh, block_size=b, jitter=0.0)
        out[n, b] = (post.alpha, post.log_marginal)
        if (n, b) == STRIP_CASE:
            out["strip"] = post.L_blocks
    params, n, b, noise = PERIODIC
    x, y = _data(n, seed=3)
    out["periodic"] = par.fit_blockcyclic(_port_kernel("periodic", params), t(x), t(y), noise,
                                          mesh, block_size=b, jitter=0.0).log_marginal
    params, n, b, m = PRED
    x, y = _data(n, seed=1)
    post = par.fit_blockcyclic(_port_kernel("se", params), t(x), t(y), NOISE, mesh,
                               block_size=b, jitter=0.0)
    out["pred"] = par.predict_diag_blockcyclic(post, t(_xo(m)), mesh)
    jp = torch.load(Path(out_dir) / "jax_pred.pt", weights_only=False)
    converted = blockcyclic_posterior_from_numpy(
        "se", params, x, y, NOISE, jp["L_blocks"], jp["alpha"], jp["lml"], block_size=b,
        rank=mesh.rank, world_size=WORLD)
    out["converted"] = par.predict_diag_blockcyclic(converted, t(_xo(m)), mesh)

    grid = par.make_grid_mesh(WORLD, device="cpu")
    x, y = make_xy(np.random.default_rng(0), GRID_N)
    post = par.fit_sharded(_port_kernel("se", (1.0, 1.0)), t(x), t(y), NOISE, grid, jitter=0.0)
    out["grid"] = (post.alpha, post.log_marginal,
                   par.predict_diag_sharded(post, t(_xo(GRID_XO)), grid), grid.shape)
    out["cli"] = cli.run_config(_cli_config(), device="cpu")
    out["solves"] = {b: _solve_case(mesh, b) for b in SOLVE_BS}
    torch.save(out, Path(out_dir) / f"rank{mesh.rank}.pt")
    par.shutdown_cluster()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
