"""Port data-sharded SGPR (parallel/sgpr_sharded.py) at two ranks.

Float64, Kuu well conditioned (8 inducing points 0.86 apart at lengthscale
0.7; a near-singular Kuu amplifies either package's eigh round-off).  The
two ranks run this file's ``__main__`` code once (a module fixture); the
test process computes the references meanwhile.  Against the unsharded
port (``fit_sgpr``, ``elbo_sgpr`` and its autograd gradient in theta, noise
and z, ``fit_sgpr_mle``) and the JAX package's ``elbo_sgpr_sharded`` on a
2-device mesh with its ``jax.grad``, to 1e-10: the gradient is the whole
bound's on each rank, not W times the sweep's part.  An uneven split
raises.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, launch_ranks, wait_ranks
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

RTOL = 1e-10
N, M, NOISE, THETA = 64, 8, 0.2, (1.0, 0.7)
OPTS = dict(block_size=12)  # 32 rows a rank: two full blocks and a short one


def _problem():
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(-3, 3, N))
    return x, np.sin(2 * x) + 0.1 * rng.standard_normal(N), np.linspace(-3, 3, M)


def _value_and_grads(bound, x, y, z, **kw):
    """The bound and its autograd gradient in (theta, noise, z)."""
    from gaussian_processes_tpu_torch import GaussianKernel

    theta = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    noise = torch.tensor(NOISE, dtype=torch.float64, requires_grad=True)
    zz = torch.as_tensor(z).clone().requires_grad_()
    value = bound(GaussianKernel.from_params(theta), torch.as_tensor(x), torch.as_tensor(y),
                  noise, zz, **OPTS, **kw)
    return (value.detach(), *torch.autograd.grad(value, (theta, noise, zz)))


def _references():
    import jax
    import jax.numpy as jnp

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.parallel import make_row_mesh
    from gaussian_processes_tpu.parallel import sgpr_sharded as jss
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.models import sgpr

    x, y, z = _problem()
    k = GaussianKernel(*THETA, dtype=torch.float64)
    t = (torch.as_tensor(x), torch.as_tensor(y))
    post = sgpr.fit_sgpr(k, *t, NOISE, torch.as_tensor(z), **OPTS)
    _, losses = sgpr.fit_sgpr_mle(GaussianKernel(0.8, 1.0, dtype=torch.float64), *t, 0.3,
                                  torch.as_tensor(z), num_steps=3, learn_inducing=True, **OPTS)
    mesh = make_row_mesh(2)

    def jbound(th, s, zz):
        return jss.elbo_sgpr_sharded(gpt.GaussianKernel(h=th[0], w=th[1]), x, y, s, zz,
                                     mesh=mesh, **OPTS)

    jvalue, jgrads = jax.value_and_grad(jbound, argnums=(0, 1, 2))(
        jnp.asarray(THETA), jnp.float64(NOISE), jnp.asarray(z))
    return {"fit": (post.log_marginal, post.c, post.lam_B, post.trace_gap),
            "elbo": _value_and_grads(sgpr.elbo_sgpr, x, y, z),
            "jax": (np.asarray(jvalue), *(np.asarray(g) for g in jgrads)),
            "mle": torch.as_tensor(losses)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sgpr_sharded")
    procs = launch_ranks(__file__, 2, out)
    want = _references()
    return wait_ranks(procs, out), want


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_fit_matches_the_unsharded_port(runs):
    ranks, want = runs
    for r in ranks:
        for got, ref in zip(r["fit"], want["fit"]):
            _close(got, ref)


@pytest.mark.parametrize("ref", ["elbo", "jax"])
def test_bound_and_gradient_match(runs, ref):
    ranks, want = runs
    for r in ranks:
        for got, value in zip(r["elbo"], want[ref]):  # value, d/dtheta, d/dnoise, d/dz
            _close(got, value)


def test_mle_steps_match_the_unsharded_port(runs):
    ranks, want = runs
    for r in ranks:
        _close(r["mle"], want["mle"])


def test_an_uneven_shard_raises(runs):
    ranks, _ = runs
    assert [r["uneven"] for r in ranks] == ["ValueError", "ValueError"]


# ---------------------------------------------------------------------------
# rank side: ``python tests/test_torch_sgpr_sharded.py OUT_DIR`` under a launcher


def _rank_main(out_dir):
    torch.set_num_threads(1)
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch import parallel as par

    par.initialize_cluster(backend="gloo")
    mesh = par.make_row_mesh(device="cpu")
    x, y, z = _problem()
    k = GaussianKernel(*THETA, dtype=torch.float64)
    post = par.fit_sgpr_sharded(k, x, y, NOISE, z, mesh=mesh, **OPTS)
    _, losses = par.fit_sgpr_mle_sharded(GaussianKernel(0.8, 1.0, dtype=torch.float64), x, y,
                                         0.3, z, mesh=mesh, num_steps=3, learn_inducing=True,
                                         **OPTS)
    out = {"fit": (post.log_marginal, post.c, post.lam_B, post.trace_gap),
           "elbo": _value_and_grads(par.elbo_sgpr_sharded, x, y, z, mesh=mesh),
           "mle": torch.as_tensor(losses)}
    try:
        par.fit_sgpr_sharded(k, x[:63], y[:63], NOISE, z, mesh=mesh, **OPTS)
        out["uneven"] = "no error"
    except ValueError:
        out["uneven"] = "ValueError"
    torch.save(out, Path(out_dir) / f"rank{mesh.rank}.pt")
    par.shutdown_cluster()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
