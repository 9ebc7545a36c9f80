"""Port data-sharded Bayesian sampling (parallel/bayes_sharded.py) at four ranks.

One gloo group of four processes (2 chain ranks x 2 data ranks), brought up
once for the file by a module fixture; the ranks run this file's
``__main__`` code while the test process computes the references.  Float64.

* Pointwise: the data-sharded log posterior (2 data ranks) has the value and
  gradient of the unsharded ``make_log_posterior_iterative`` on the same
  frozen probes (the JAX package's, replayed) and of the JAX package's
  data-sharded surrogate on a 2-device mesh, to 1e-10, plain and
  preconditioned; its autograd rule returns that gradient.
* Trajectories stay short (chaotic dynamics amplify reduction-order
  round-off, as ``tests/test_bayes_sharded.py`` measured): with chains
  replicated over the data ranks, a 2 + 1 ChEES run matches ``sample_chees``
  on the unsharded surrogate; a run stopped and resumed through a
  checkpoint in its warmup and its collection equals one pass bit for bit; on the 2 x 2 layout a 2 + 1 run matches ``sample_chees_sharded`` over
  the chain ranks on the unsharded surrogate, as
  ``tests/test_bayes_sharded.py:184`` gates the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, launch_ranks, make_xy, wait_ranks
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

N, RANK = 64, 12
SOLVER = dict(num_probes=4, num_iters=40, tol=1e-14, prior_std=1.5)
RUN = dict(num_warmup=2, num_samples=1, init_step_size=0.05, init_traj_length=0.3,
           max_leapfrog=64)
LONG_RUN = dict(RUN, num_warmup=3, num_samples=3)


def _data():
    return make_xy(np.random.default_rng(0), N)


def _kernel():
    from gaussian_processes_tpu_torch import GaussianKernel

    return GaussianKernel(1.2, 0.6, dtype=torch.float64)


def _positions():
    return torch.stack([torch.as_tensor(np.random.default_rng(s).normal(0, 0.3, 3))
                        + torch.tensor([0.1, -0.5, -1.5], dtype=torch.float64)
                        for s in range(2)])


def _init():
    from gaussian_processes_tpu_torch.inference import init_positions

    return init_positions(_kernel(), 0.3, torch.Generator().manual_seed(1), n_chains=4,
                          spread=0.2)


def _probe_arrays(precond_rank):
    """The JAX package's frozen probes, in the port's draw order."""
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu.parallel.iterative_sharded import _draw_vg_probes

    probes, xi1, xi2 = _draw_vg_probes(jax.random.key(42), N, SOLVER["num_probes"],
                                       precond_rank, jnp.float64)
    arrays = [np.asarray(probes)]
    return arrays + ([np.asarray(xi1), np.asarray(xi2)] if precond_rank else [])


def _unsharded(probes, **kw):
    from gaussian_processes_tpu_torch.inference import make_log_posterior_iterative

    from test_torch_iterative import Replay

    x, y = (torch.as_tensor(a) for a in _data())
    return make_log_posterior_iterative(_kernel(), x, y, probe_generator=Replay(*probes),
                                        early_exit=False, **SOLVER, **kw)


def _jax_value_and_grad(precond_rank, u):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.parallel import make_row_mesh
    from gaussian_processes_tpu.parallel.bayes_sharded import (
        make_log_posterior_iterative_datasharded,
    )

    x, y = _data()
    kernel = gpt.GaussianKernel(h=jnp.float64(1.2), w=jnp.float64(0.6))
    sur = make_log_posterior_iterative_datasharded(
        kernel, N, jnp.float64, "i", probe_key=jax.random.key(42), precond_rank=precond_rank,
        **SOLVER)

    def local(u, x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc):
        lp = sur.make_local(x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc)
        return jax.vmap(jax.value_and_grad(lp))(u)

    fn = jax.jit(jax.shard_map(
        local, mesh=make_row_mesh(2),
        in_specs=(P(), P(), P("i"), P("i"), P("i"), P(), P("i")), out_specs=(P(), P()),
        check_vma=False))
    v, g = fn(jnp.asarray(u.numpy()), x, x, y, sur.probes, sur.xi1, sur.xi2)
    return np.asarray(v), np.asarray(g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from gaussian_processes_tpu_torch.inference import sample_chees

    out = tmp_path_factory.mktemp("bayes_sharded")
    probes = {r: _probe_arrays(r) for r in (0, RANK)}
    torch.save(probes, out / "probes.pt")
    procs = launch_ranks(__file__, 4, out)
    u = _positions()
    want = {}
    for r in (0, RANK):
        want[f"port{r}"] = _unsharded(probes[r], precond_rank=r).value_and_grad(u)
        want[f"jax{r}"] = _jax_value_and_grad(r, u)
    want["chees"] = sample_chees(_unsharded(probes[0]), _init(),
                                 torch.Generator().manual_seed(2), **RUN)
    return wait_ranks(procs, out, timeout=400.0), want


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("precond_rank", [0, RANK])
def test_datasharded_log_posterior_matches_pointwise(runs, ref, precond_rank):
    ranks, want = runs
    value, grad = want[f"{ref}{precond_rank}"]
    for r in ranks:
        got_value, got_grad, autograd = r[f"vg{precond_rank}"]
        _close(got_value, value)
        _close(got_grad, grad)
        assert torch.equal(autograd, got_grad)


def test_replicated_chains_match_sample_chees(runs):
    ranks, want = runs
    ref = want["chees"]
    for r in ranks:
        got = r["replicated"]
        np.testing.assert_allclose(got["positions"].numpy(), ref.positions.numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(got["step_size"]), float(ref.step_size), rtol=1e-6)
        np.testing.assert_allclose(got["inv_mass"].numpy(), ref.inv_mass.numpy(), rtol=1e-6)


def test_chunked_run_is_bit_identical(runs):
    """The run in stages, through a checkpoint, equals one pass."""
    ranks, _ = runs
    for r in ranks:
        a, b = r["unchunked"], r["chunked"]
        assert a.shape == (LONG_RUN["num_samples"], 4, 3)
        assert torch.equal(a, b)


def test_chain_by_data_layout_matches_the_chain_sharded_sampler(runs):
    ranks, _ = runs
    for r in ranks:
        got, ref = r["grid"], r["chain_sharded"]
        assert got["positions"].shape == (RUN["num_samples"], 4, 3)
        np.testing.assert_allclose(got["positions"].numpy(), ref["positions"].numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(got["step_size"]), float(ref["step_size"]), rtol=1e-6)
    # every rank holds the same global draws
    for r in ranks[1:]:
        assert torch.equal(r["grid"]["positions"], ranks[0]["grid"]["positions"])


# ---------------------------------------------------------------------------
# rank side: ``python tests/test_torch_bayes_sharded.py OUT_DIR`` under a launcher


def _record(res):
    return {k: getattr(res, k) for k in ("positions", "step_size", "inv_mass")}


def _resumed_run(par, x, y, data_mesh, path):
    """``LONG_RUN`` on the data-sharded surrogate in stages, its state
    written to ``path`` (this rank's own file) and read back inside the
    warmup and between two collections: the positions."""
    from gaussian_processes_tpu_torch.inference import chees
    from gaussian_processes_tpu_torch.utils import load_pytree, save_pytree

    def reload(state):
        save_pytree(path, state)
        return load_pytree(path, like=state)

    lp = par.make_log_posterior_iterative_datasharded(_kernel(), x, y, data_mesh, **SOLVER)
    nw, ns, cap = LONG_RUN["num_warmup"], LONG_RUN["num_samples"], LONG_RUN["max_leapfrog"]
    s = chees.init_chees_state(lp, _init(), torch.Generator().manual_seed(3),
                               init_step_size=LONG_RUN["init_step_size"],
                               init_traj_length=LONG_RUN["init_traj_length"])
    s = chees.chees_warmup(lp, s, nw, stop=2, max_leapfrog=cap)
    s = chees.chees_warmup(lp, reload(s), nw, start=2, max_leapfrog=cap)
    a = chees.chees_collect(lp, s, 1, max_leapfrog=cap)
    b = chees.chees_collect(lp, reload(a.final), ns - 1, max_leapfrog=cap)
    return torch.cat([a.positions, b.positions])


def _rank_main(out_dir):
    torch.set_num_threads(1)
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.parallel.mesh import RankMesh

    from test_torch_iterative import Replay

    par.initialize_cluster(backend="gloo")
    grid = par.make_bayes_mesh(2, 2, device="cpu")
    data_only = par.BayesMesh(chain=RankMesh(None, 0, 1, grid.data.device, "chain"),
                              data=grid.data)
    probes = torch.load(Path(out_dir) / "probes.pt", weights_only=False)
    x, y = _data()
    out = {}
    u = _positions()
    for r in (0, RANK):
        lp = par.make_log_posterior_iterative_datasharded(
            _kernel(), x, y, grid.data, probe_generator=Replay(*probes[r]), precond_rank=r,
            **SOLVER)
        value, grad = lp.value_and_grad(u)
        uu = u.clone().requires_grad_()
        (autograd,) = torch.autograd.grad(lp(uu).sum(), uu)
        out[f"vg{r}"] = (value, grad, autograd)

    opts = dict(probe_generator=None, **SOLVER)
    out["replicated"] = _record(par.sample_chees_iterative_sharded(
        _kernel(), x, y, _init(), torch.Generator().manual_seed(2), mesh=data_only,
        **dict(opts, probe_generator=Replay(*probes[0])), **RUN))
    out["unchunked"] = par.sample_chees_iterative_sharded(
        _kernel(), x, y, _init(), torch.Generator().manual_seed(3), mesh=data_only,
        **opts, **LONG_RUN).positions
    out["chunked"] = _resumed_run(par, x, y, data_only.data,
                                  par.host_checkpoint_path(str(Path(out_dir) / "chees.npz")))

    out["grid"] = _record(par.sample_chees_iterative_sharded(
        _kernel(), x, y, _init(), torch.Generator().manual_seed(4), mesh=grid, **opts, **RUN))
    from gaussian_processes_tpu_torch.inference import make_log_posterior_iterative

    log_post = make_log_posterior_iterative(_kernel(), torch.as_tensor(x), torch.as_tensor(y),
                                            early_exit=False, **SOLVER)
    out["chain_sharded"] = _record(par.sample_chees_sharded(
        log_post, _init(), torch.Generator().manual_seed(4), mesh=grid.chain, **RUN))
    torch.save(out, Path(out_dir) / f"rank{torch.distributed.get_rank()}.pt")
    par.shutdown_cluster()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
