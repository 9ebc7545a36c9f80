"""Port chain-sharded samplers (parallel/sharded.py) over a gloo process group.

The counterpart of ``tests/test_parallel.py`` for chains across ranks.  The
two-rank group is brought up once for the file: a module fixture launches
this file as two processes (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` set, a free port found at run time) whose code, under the
``__main__`` guard at the bottom, computes everything the tests assert on
and saves it; the tests read it back.  Float64 on the CPU.

* The pooled reducers over a (16, 3) chain block split 8 + 8 equal the
  Welford moments and means over all 16 chains, from the port's and the JAX
  package's ``welford_update_batch``, to 1e-12; each rank counts each of
  their collectives in ``parallel.collectives``.
* Sharded NUTS at one rank equals ``sample_nuts`` fed rank 0's derived
  generator bit for bit; at two ranks, runs stopped and resumed from
  per-rank checkpoints equal runs in one pass bit for bit (NUTS and ChEES).
* The draws of a correlated 2-D Gaussian and of the GP posterior of
  ``tests/test_parallel.py::_problem`` agree with the target and with the
  unsharded port within 4 Monte-Carlo standard errors; step size and inverse
  mass are identical on both ranks; a chain count the ranks do not divide
  raises.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
MEAN = np.array([1.0, -2.0])
COV = np.array([[1.0, 0.8], [0.8, 2.0]])
GAUSS = dict(num_warmup=150, num_samples=250)
GP = dict(num_warmup=100, num_samples=120, max_depth=8)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(script, world: int, out_dir, *args):
    """Start ``script`` as ``world`` ranks of one gloo group; returns the
    processes (``wait_ranks`` collects them)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        env.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(out_dir), *map(str, args)], env=env,
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def wait_ranks(procs, out_dir, timeout: float = 300.0):
    """Wait for every rank (failing, not hanging, past ``timeout``) and
    return each rank's saved results."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks did not finish within {timeout} s")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\nstdout={out[-2000:]}\nstderr={err[-4000:]}"
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def make_xy(rng, n):
    """``gaussian_processes_tpu.utils.testing.make_xy``'s recipe."""
    x = np.sort(rng.uniform(-np.pi, np.pi, size=n))
    return x, np.sin(x) + 0.1 * rng.standard_normal(n)


def gauss_logp(z):
    d = z - torch.as_tensor(MEAN, dtype=z.dtype)
    return -0.5 * torch.einsum("ci,ij,cj->c", d, torch.as_tensor(np.linalg.inv(COV)), d)


def gauss_init(C=16):
    return torch.as_tensor(np.random.default_rng(5).normal(0, 1, (C, 2)))


def gp_problem():
    """``tests/test_parallel.py::_problem`` (n=24) as the port's posterior
    and 16 initial positions."""
    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch.inference import init_positions, make_log_posterior

    x, y = make_xy(np.random.default_rng(0), 24)
    k0 = GaussianKernel(1.0, 1.0, dtype=torch.float64)
    log_post = make_log_posterior(k0, torch.as_tensor(x), torch.as_tensor(y), prior_std=1.5)
    init = init_positions(k0, 0.2, torch.Generator().manual_seed(1), n_chains=16, spread=0.3)
    return log_post, init


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    procs = launch_ranks(__file__, 2, out)
    # the unsharded references run here while the ranks work
    from gaussian_processes_tpu_torch.inference import nuts as tnuts

    log_post, init = gp_problem()
    ref = tnuts.sample_nuts(log_post, init, torch.Generator().manual_seed(2), **GP)
    return wait_ranks(procs, out), ref


def test_pooled_reducers_equal_the_whole_population(ranks):
    import jax.numpy as jnp

    from gaussian_processes_tpu.inference import adaptation as jadapt
    from gaussian_processes_tpu_torch.inference import adaptation as tadapt

    (r0, r1), _ = ranks
    x = np.random.default_rng(0).normal(size=(16, 3))
    whole = tadapt.welford_update_batch(tadapt.welford_init(3, torch.float64),
                                        torch.as_tensor(x))
    jwhole = jadapt.welford_update_batch(jadapt.welford_init(3, jnp.float64), jnp.asarray(x))
    for r in (r0, r1):
        mean, m2, count = r["welford"]
        for got, want in ((mean, whole.mean), (m2, whole.m2), (count, whole.count)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
        for got, want in ((mean, jwhole.mean), (m2, jwhole.m2), (count, jwhole.count)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        np.testing.assert_allclose(float(r["mean"]), x[:, 0].mean(), rtol=1e-12)
        np.testing.assert_allclose(r["vec_mean"].numpy(), x.mean(0), rtol=1e-12)


def test_each_collective_is_counted_on_every_rank(ranks):
    (r0, r1), _ = ranks
    # the Welford merge's pmean of the means, psum of M2 and psum of the
    # counts, then the two pooled means
    assert r0["collectives"] == r1["collectives"] == 5


def test_one_rank_equals_sample_nuts_on_rank_zeros_generator():
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.inference import nuts as tnuts
    from gaussian_processes_tpu_torch.parallel.sharded import rank_generator

    mesh = par.make_chain_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    opts = dict(num_warmup=120, num_samples=40, max_depth=6)
    res = par.sample_nuts_sharded(gauss_logp, gauss_init(8), torch.Generator().manual_seed(4),
                                  mesh=mesh, **opts)
    gen = rank_generator(torch.Generator().manual_seed(4), 0, "cpu")
    ref = tnuts.sample_nuts(gauss_logp, gauss_init(8), gen, **opts)
    for a, b in zip(res[:7], ref[:7]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_chunked_and_resumed_runs_are_bit_identical(ranks, sampler):
    """The resumed runs stop and go on through a per-rank checkpoint,
    written and read back inside the warmup and inside the collection."""
    (r0, r1), _ = ranks
    for r in (r0, r1):
        full = r[f"{sampler}_full"]
        assert full["positions"].shape == (GAUSS["num_samples"], 16, 2)
        for key, value in full.items():
            assert torch.equal(r[f"{sampler}_resumed"][key], value), (sampler, key)
    # every rank returns the same global view
    for key, value in r0[f"{sampler}_full"].items():
        assert torch.equal(r1[f"{sampler}_full"][key], value)


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_sharded_draws_reproduce_a_correlated_gaussian(ranks, sampler):
    from test_torch_samplers import _moments_within_mc_error

    (r0, _), _ = ranks
    full = r0[f"{sampler}_full"]
    assert not bool(full["diverging"].any())
    _moments_within_mc_error(full["positions"])


def test_adaptation_is_identical_on_both_ranks(ranks):
    (r0, r1), _ = ranks
    for key in ("step_size", "inv_mass", "gp_step_size", "gp_inv_mass", "traj_length"):
        assert torch.equal(r0[key], r1[key]), key
    assert float(r0["gp_step_size"]) > 0 and bool((r0["gp_inv_mass"] > 0).all())


def test_sharded_gp_posterior_agrees_with_the_unsharded_port(ranks):
    from gaussian_processes_tpu_torch.inference import diagnostics as td

    (r0, _), ref = ranks
    draws = r0["gp_positions"].numpy()
    base = ref.positions.numpy()
    assert draws.shape == base.shape == (GP["num_samples"], 16, 3)
    assert np.all(np.isfinite(draws))
    assert float(r0["gp_diverging"].float().mean()) < 0.05
    se = np.sqrt(draws.reshape(-1, 3).var(0) / td.ess(draws)
                 + base.reshape(-1, 3).var(0) / td.ess(base))
    gap = np.abs(draws.reshape(-1, 3).mean(0) - base.reshape(-1, 3).mean(0))
    assert np.all(gap < 4 * se), (gap, se)


def test_a_chain_count_the_ranks_do_not_divide_raises(ranks):
    (r0, r1), _ = ranks
    assert r0["uneven"] == r1["uneven"] == "ValueError"


def test_nuts_multihost_cli_runs_on_one_cpu_rank():
    from gaussian_processes_tpu_torch.cli import NOT_PORTED, run_config
    from gaussian_processes_tpu_torch.utils import CONFIGS
    import dataclasses

    assert NOT_PORTED == {}
    cfg = CONFIGS["config5_nuts_sharded"]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, n=64),
        nuts=dataclasses.replace(cfg.nuts, n_chains=8, num_warmup=20, num_samples=20))
    out = run_config(cfg, device="cpu")
    assert out["n_chains"] == 8 and out["n_samples"] == 20
    assert out["draws_finite"] and np.all(np.isfinite(out["posterior_mean"]))
    assert out["samples_per_s"] > 0 and "mean_leapfrog" in out


# ---------------------------------------------------------------------------
# rank side: ``python tests/test_torch_parallel.py OUT_DIR`` under a launcher


def _nuts_record(res):
    return {k: getattr(res, k) for k in ("positions", "log_probs", "accept_prob",
                                          "num_leapfrog", "diverging", "step_size",
                                          "inv_mass")}


def _chees_record(res):
    return {k: getattr(res, k) for k in ("positions", "log_probs", "accept_prob",
                                          "num_leapfrog", "diverging", "step_size",
                                          "traj_length", "inv_mass")}


def _reload(path, state, put):
    from gaussian_processes_tpu_torch.utils import load_pytree, save_pytree

    save_pytree(path, state)
    return put(load_pytree(path, like=state))


def _rank_main(out_dir):
    torch.set_num_threads(1)
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.inference import adaptation as tadapt
    from gaussian_processes_tpu_torch.utils.profiling import counts

    par.initialize_cluster(backend="gloo")
    mesh = par.make_chain_mesh(device="cpu")
    out = {}

    # pooled reducers on a (16, 3) block split over the ranks
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 3)))[mesh.block(16)]
    reduce_mean, reduce_welford, reduce_vec_mean = par.sharded._pooled_reducers(mesh)
    before = counts["parallel.collectives"]
    w = reduce_welford(tadapt.welford_update_batch(tadapt.welford_init(3, torch.float64), x))
    out.update(welford=(w.mean, w.m2, w.count), mean=reduce_mean(x[:, 0]),
               vec_mean=reduce_vec_mean(x))
    out["collectives"] = counts["parallel.collectives"] - before

    ckpt = par.host_checkpoint_path(str(Path(out_dir) / "ckpt.npz"))

    def put_nuts(s):
        return par.shard_put_nuts(s, mesh)

    def put_chees(s):
        return par.shard_put_chees(s, mesh)

    # NUTS: in one pass, and stopped and resumed from per-rank checkpoints
    nw, ns = GAUSS["num_warmup"], GAUSS["num_samples"]
    opts = dict(mesh=mesh, max_depth=6)
    full = par.sample_nuts_sharded(gauss_logp, gauss_init(), torch.Generator().manual_seed(7),
                                   num_warmup=nw, num_samples=ns, **opts)
    out["nuts_full"] = _nuts_record(full)
    s = par.init_nuts_sharded(gauss_logp, gauss_init(), torch.Generator().manual_seed(7),
                              mesh=mesh)
    s = par.warmup_nuts_sharded(gauss_logp, s, nw, stop=90, **opts)
    s = par.warmup_nuts_sharded(gauss_logp, _reload(ckpt, s, put_nuts), nw, start=90, **opts)
    a = par.collect_nuts_sharded(gauss_logp, s, 120, **opts)
    b = par.collect_nuts_sharded(gauss_logp, _reload(ckpt, a.final, put_nuts), ns - 120,
                                 **opts)
    out["nuts_resumed"] = {k: (torch.cat([v, getattr(b, k)]) if v.ndim >= 2 else getattr(b, k))
                           for k, v in _nuts_record(a).items()}
    out.update(step_size=full.step_size, inv_mass=full.inv_mass)

    # ChEES the same way
    copts = dict(mesh=mesh)
    cfull = par.sample_chees_sharded(gauss_logp, gauss_init(), torch.Generator().manual_seed(8),
                                     num_warmup=nw, num_samples=ns, **copts)
    out["chees_full"] = _chees_record(cfull)
    s = par.init_chees_sharded(gauss_logp, gauss_init(), torch.Generator().manual_seed(8),
                               mesh=mesh)
    s = par.warmup_chees_sharded(gauss_logp, s, nw, stop=110, **copts)
    s = par.warmup_chees_sharded(gauss_logp, _reload(ckpt, s, put_chees), nw, start=110,
                                 **copts)
    a = par.collect_chees_sharded(gauss_logp, s, 100, **copts)
    b = par.collect_chees_sharded(gauss_logp, _reload(ckpt, a.final, put_chees), ns - 100,
                                  **copts)
    out["chees_resumed"] = {k: (torch.cat([v, getattr(b, k)])
                                if k in ("positions", "log_probs", "accept_prob",
                                         "num_leapfrog", "diverging") else getattr(b, k))
                            for k, v in _chees_record(a).items()}
    out["traj_length"] = cfull.traj_length

    # the GP posterior of tests/test_parallel.py::_problem
    log_post, init = gp_problem()
    gp = par.sample_nuts_sharded(log_post, init, torch.Generator().manual_seed(2), mesh=mesh,
                                 **GP)
    out.update(gp_positions=gp.positions, gp_diverging=gp.diverging,
               gp_step_size=gp.step_size, gp_inv_mass=gp.inv_mass)

    try:
        par.init_nuts_sharded(gauss_logp, gauss_init(7), mesh=mesh)
        out["uneven"] = "no error"
    except ValueError:
        out["uneven"] = "ValueError"

    torch.save(out, Path(out_dir) / f"rank{mesh.rank}.pt")
    par.shutdown_cluster()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
