"""Port row-sharded matrix-free GP (parallel/iterative_sharded.py) at two ranks.

Against the JAX package's ``parallel.iterative_sharded`` on a 2-device mesh
(the suite's virtual CPU devices), float64, with the JAX package's draws
replayed into the port (``Replay``): the fit's alpha and lml without and
with the preconditioner, the row-sharded pivoted Cholesky, the predictive
mean, the value and gradient plain and preconditioned, and three MLE steps,
all to 1e-10; and the sharded matvec against the global one.  The two ranks
run this file's ``__main__`` code once (a module fixture) on draws the test
process recorded first, and the JAX package computes while they run.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, launch_ranks, wait_ranks
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-10
N, NOISE = 64, 0.3
PLAIN = dict(num_probes=4, num_iters=80, tol=1e-12, block_size=16)
PRECOND = dict(num_probes=4, num_iters=60, tol=1e-12, block_size=16, precond_rank=20)
MLE = dict(num_steps=3, num_probes=3, num_iters=70, tol=1e-12, block_size=16)


def _problem():
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(-3, 3, N))
    return x, np.sin(2 * x) + 0.1 * rng.standard_normal(N)


def _port_kernel(theta=(1.2, 0.6)):
    from gaussian_processes_tpu_torch import GaussianKernel

    return GaussianKernel(*theta, dtype=torch.float64)


def _jax_draws():
    """The JAX package's draws for each call below, in the port's order."""
    import jax

    from test_torch_iterative import _precond_normals, _rademacher

    keys = [jax.random.key(i) for i in range(5)]
    draws = {"plain": [_rademacher(keys[0], N, 4)],
             "precond": list(_precond_normals(keys[1], 20, N, 4)),
             "vg_plain": [_rademacher(keys[2], N, 4)],
             "vg_precond": [_rademacher(keys[3], N, 4), *_precond_normals(keys[3], 20, N, 4)]}
    key, mle = keys[4], []
    for _ in range(MLE["num_steps"]):
        key, sub = jax.random.split(key)
        mle.append(_rademacher(sub, N, 3))
    draws["mle"] = mle
    return keys, draws


def _jax_results(keys):
    import jax.numpy as jnp

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.ops import krylov as jkrylov
    from gaussian_processes_tpu.parallel import iterative_sharded as js

    x, y = _problem()
    k = gpt.GaussianKernel(h=jnp.float64(1.2), w=jnp.float64(0.6))
    mesh = js.make_row_mesh(2)
    out = {}
    p = js.fit_iterative_sharded(k, x, y, NOISE, keys[0], mesh=mesh, **PLAIN)
    out["plain"] = (p.alpha, p.log_marginal)
    out["predict"] = js.predict_mean_iterative_sharded(p, np.linspace(-3.3, 3.3, 9), mesh=mesh,
                                                       block_size=8)
    p = js.fit_iterative_sharded(k, x, y, NOISE, keys[1], mesh=mesh, **PRECOND)
    out["precond"] = (p.alpha, p.log_marginal)
    out["pivchol"] = jkrylov.pivoted_cholesky(k, jnp.asarray(x), 20)
    out["vg_plain"] = js.log_marginal_value_and_grad_iterative_sharded(
        k, x, y, NOISE, keys[2], mesh=mesh, **PLAIN)
    out["vg_precond"] = js.log_marginal_value_and_grad_iterative_sharded(
        k, x, y, NOISE, keys[3], mesh=mesh, **PRECOND)
    k0 = k.with_params(jnp.asarray([0.7, 1.1]))
    kf, nf, _, trace = js.fit_mle_iterative_sharded(k0, x, y, 0.4, keys[4], mesh=mesh, **MLE)
    out["mle"] = (kf.params, nf, np.asarray(trace))
    return {name: tuple(np.asarray(v) for v in val) if isinstance(val, tuple) else np.asarray(val)
            for name, val in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("iterative_sharded")
    keys, draws = _jax_draws()
    torch.save(draws, out / "draws.pt")
    procs = launch_ranks(__file__, 2, out)
    want = _jax_results(keys)
    return wait_ranks(procs, out), want


def _close(got, want, rtol=RTOL):
    """Elementwise within ``rtol`` of the largest entry (entries near zero
    carry the round-off of the whole vector)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["plain", "precond"])
def test_fit_matches_jax(runs, case):
    ranks, want = runs
    for r in ranks:
        alpha, lml, residual = r[case]
        _close(alpha, want[case][0])
        _close(lml, want[case][1])
        assert float(residual) < 1e-10


def test_pivoted_cholesky_matches_jax_and_the_unsharded_port(runs):
    from gaussian_processes_tpu_torch.ops import krylov

    ranks, want = runs
    x, _ = _problem()
    port = krylov.pivoted_cholesky(_port_kernel(), torch.as_tensor(x), 20)
    for r in ranks:
        _close(r["pivchol"], want["pivchol"])
        _close(r["pivchol"], port)


def test_predict_mean_matches_jax(runs):
    ranks, want = runs
    for r in ranks:
        assert r["predict"].shape == (9,)
        _close(r["predict"], want["predict"])


@pytest.mark.parametrize("case", ["vg_plain", "vg_precond"])
def test_value_and_grad_match_jax(runs, case):
    ranks, want = runs
    for r in ranks:
        _close(r[case][0], want[case][0])
        _close(r[case][1], want[case][1])


def test_three_mle_steps_match_jax(runs):
    ranks, want = runs
    for r in ranks:
        params, noise, trace = r["mle"]
        _close(trace, want["mle"][2])
        _close(params, want["mle"][0])
        _close(noise, want["mle"][1])


def test_sharded_matvec_equals_the_global_matvec(runs):
    from gaussian_processes_tpu_torch.ops import krylov

    ranks, _ = runs
    x, _ = _problem()
    v = torch.as_tensor(np.random.default_rng(3).normal(size=(N, 3)))
    want = krylov.kernel_matvec(_port_kernel(), torch.as_tensor(x), v, NOISE, 1e-4)
    for r in ranks:
        np.testing.assert_allclose(r["matvec"].numpy(), want.numpy(), rtol=1e-12, atol=1e-13)


def test_an_uneven_split_raises(runs):
    ranks, _ = runs
    assert [r["uneven"] for r in ranks] == ["ValueError", "ValueError"]


# ---------------------------------------------------------------------------
# rank side: ``python tests/test_torch_iterative_sharded.py OUT_DIR`` under a launcher


def _rank_main(out_dir):
    torch.set_num_threads(1)
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.parallel import iterative_sharded as ts

    from test_torch_iterative import Replay

    par.initialize_cluster(backend="gloo")
    mesh = ts.make_row_mesh(device="cpu")
    draws = torch.load(Path(out_dir) / "draws.pt", weights_only=False)
    x, y = (torch.as_tensor(a) for a in _problem())
    k = _port_kernel()
    out = {}
    for case, opts in (("plain", PLAIN), ("precond", PRECOND)):
        p = ts.fit_iterative_sharded(k, x, y, NOISE, Replay(*draws[case]), mesh=mesh,
                                     replace_every=0, **opts)  # as the JAX package's
        out[case] = (p.alpha, p.log_marginal, p.solve_residual)
        if case == "plain":
            out["predict"] = ts.predict_mean_iterative_sharded(
                p, torch.linspace(-3.3, 3.3, 9, dtype=torch.float64), mesh=mesh, block_size=8)
    out["pivchol"] = mesh.all_gather(ts._pivoted_cholesky_sharded(k, x[mesh.block(N)], 20, mesh))
    for case, opts in (("vg_plain", PLAIN), ("vg_precond", PRECOND)):
        out[case] = ts.log_marginal_value_and_grad_iterative_sharded(
            k, x, y, NOISE, Replay(*draws[case]), mesh=mesh, **opts)
    kf, nf, _, trace = ts.fit_mle_iterative_sharded(_port_kernel((0.7, 1.1)), x, y, 0.4,
                                                    Replay(*draws["mle"]), mesh=mesh, **MLE)
    out["mle"] = (kf.params, nf, torch.tensor(trace, dtype=torch.float64))
    v = torch.as_tensor(np.random.default_rng(3).normal(size=(N, 3)))
    rows = mesh.block(N)
    mv = ts._sharded_matvec(k, x, x[rows], torch.tensor(NOISE, dtype=torch.float64), 1e-4, 16,
                            mesh)
    out["matvec"] = mesh.all_gather(mv(v[rows]))
    try:
        ts.fit_iterative_sharded(k, x[:63], y[:63], NOISE, mesh=mesh, **PLAIN)
        out["uneven"] = "no error"
    except ValueError:
        out["uneven"] = "ValueError"
    torch.save(out, Path(out_dir) / f"rank{mesh.rank}.pt")
    par.shutdown_cluster()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
