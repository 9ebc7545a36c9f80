"""Port multi-process bring-up (parallel/multihost.py) over gloo.

The counterpart of ``tests/test_multihost.py``: ``initialize_cluster`` is a
no-op in one process and returns the JAX package's summary dict; more than
one process without a rank raises; and two processes brought up from the
launcher's environment (the JAX package's variable names, resolved by the
port) run a mini chain-sharded NUTS over the group, each writing and reading
back its own checkpoint (``host_checkpoint_path``), and a run chunked through
those files equals the run without them bit for bit.  The ranks run this
file's ``__main__`` code, launched once by a module fixture.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, free_port, launch_ranks, make_xy, wait_ranks
from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

SUMMARY_KEYS = {"process_index", "process_count", "local_devices", "global_devices",
                "initialized"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    return wait_ranks(launch_ranks(__file__, 2, out), out), out


def test_single_process_is_a_noop(monkeypatch):
    from gaussian_processes_tpu_torch.parallel import (
        host_checkpoint_path,
        initialize_cluster,
        is_primary,
    )

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    info = initialize_cluster()
    assert SUMMARY_KEYS <= set(info)
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["initialized"] is False and not torch.distributed.is_initialized()
    assert is_primary()
    assert host_checkpoint_path("/x/run.npz") == "/x/run.host0.npz"
    assert host_checkpoint_path("/x/run") == "/x/run.host0.npz"


@pytest.mark.parametrize("names", [("MASTER_ADDR", "WORLD_SIZE"),
                                   ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES")])
def test_a_missing_rank_raises(monkeypatch, names):
    from gaussian_processes_tpu_torch.parallel import initialize_cluster

    for name in ("RANK", "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                 "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    addr, count = names
    if addr == "MASTER_ADDR":
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(free_port()))
    else:
        monkeypatch.setenv(addr, f"127.0.0.1:{free_port()}")
    monkeypatch.setenv(count, "2")
    with pytest.raises(ValueError, match="rank"):
        initialize_cluster()
    assert not torch.distributed.is_initialized()


def test_the_default_device_is_a_card_unless_the_group_is_gloo(monkeypatch):
    """Without an explicit device the parallel entry points take this
    rank's card, and raise where there is none: the CPU only under gloo or
    when the caller names it."""
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.parallel.multihost import local_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for make in (local_device, par.make_chain_mesh, par.make_row_mesh, par.make_bayes_mesh,
                 lambda: par.make_row_mesh(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert local_device("gloo") == torch.device("cpu")
    assert par.make_chain_mesh(device="cpu").device == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert local_device("nccl") == torch.device("cuda", 3)


def test_two_processes_bring_up_from_the_environment(ranks):
    (r0, r1), _ = ranks
    for rank, r in enumerate((r0, r1)):
        info = r["info"]
        assert SUMMARY_KEYS <= set(info)
        assert info["initialized"] and info["process_index"] == rank
        assert info["process_count"] == 2 == info["global_devices"]
        assert info["backend"] == "gloo"
        assert r["primary"] == (rank == 0)


def test_two_process_sharded_nuts_and_per_rank_checkpoints(ranks):
    (r0, r1), out = ranks
    for rank, r in enumerate((r0, r1)):
        assert r["positions"].shape == (10, 8, 3)  # the global view on every rank
        assert bool(torch.isfinite(r["positions"]).all())
        assert r["local_chains"] == 4
        assert Path(r["ckpt"]) == out / f"mh_ckpt.host{rank}.npz" and Path(r["ckpt"]).exists()
        assert r["resumed_equal"] and r["checkpointed_equal"]
        assert (out / f"run.host{rank}.npz").exists()
    assert torch.equal(r0["positions"], r1["positions"])
    assert torch.equal(r0["step_size"], r1["step_size"])
    assert torch.equal(r0["inv_mass"], r1["inv_mass"])
    # the two ranks' chains and checkpoints are their own
    assert not torch.equal(r0["final_z"], r1["final_z"])


# ---------------------------------------------------------------------------
# rank side: ``python tests/test_torch_multihost.py OUT_DIR`` under a launcher


def _rank_main(out_dir):
    import os

    torch.set_num_threads(1)
    # the JAX package's names for the same rendezvous
    os.environ["JAX_COORDINATOR_ADDRESS"] = (f"{os.environ.pop('MASTER_ADDR')}:"
                                             f"{os.environ.pop('MASTER_PORT')}")
    os.environ["JAX_NUM_PROCESSES"] = os.environ.pop("WORLD_SIZE")
    os.environ["JAX_PROCESS_ID"] = os.environ.pop("RANK")

    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.inference import init_positions, make_log_posterior
    from gaussian_processes_tpu_torch.utils import load_pytree, save_pytree

    info = par.initialize_cluster(backend="gloo")
    assert par.initialize_cluster(backend="gloo")["initialized"]  # idempotent
    mesh = par.make_chain_mesh(device="cpu")

    x, y = make_xy(np.random.default_rng(0), 24)
    k0 = GaussianKernel(1.0, 1.0, dtype=torch.float64)
    log_post = make_log_posterior(k0, torch.as_tensor(x), torch.as_tensor(y), prior_std=1.5)
    init = init_positions(k0, 0.2, torch.Generator().manual_seed(0), n_chains=8, spread=0.3)
    opts = dict(mesh=mesh, max_depth=5)
    res = par.sample_nuts_sharded(log_post, init, torch.Generator().manual_seed(1),
                                  num_warmup=20, num_samples=10, **opts)

    # the same run through the per-rank checkpoint files between chunks
    via_disk = par.sample_nuts_sharded(log_post, init, torch.Generator().manual_seed(1),
                                       num_warmup=20, num_samples=10, chunk_size=7,
                                       checkpoint=str(Path(out_dir) / "run.npz"), **opts)

    ckpt = par.host_checkpoint_path(str(Path(out_dir) / "mh_ckpt.npz"))
    save_pytree(ckpt, res.final)
    restored = par.shard_put_nuts(load_pytree(ckpt, like=res.final), mesh)
    more = par.collect_nuts_sharded(log_post, restored, 3, **opts)
    again = par.collect_nuts_sharded(log_post, res.final, 3, **opts)

    torch.save({"info": info, "primary": par.is_primary(), "positions": res.positions,
                "local_chains": res.final.chains.z.shape[0], "ckpt": ckpt,
                "resumed_equal": bool(torch.equal(more.positions, again.positions)),
                "checkpointed_equal": all(torch.equal(a, b) for a, b in zip(via_disk[:7], res[:7])),
                "step_size": res.step_size, "inv_mass": res.inv_mass,
                "final_z": res.final.chains.z}, Path(out_dir) / f"rank{mesh.rank}.pt")
    par.shutdown_cluster()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
