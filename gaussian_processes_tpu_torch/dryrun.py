"""Entry points that drive the port's flagship step and its multi-device paths.

Counterpart of the JAX package's ``__graft_entry__.py``:

``entry(device)`` -- the flagship step (exact GP fit + predictive mean and
                     variance, BASELINE.json config #1's model at n = 256,
                     m = 128) and its example arguments.
``dryrun_multichip(n)`` -- every multi-device path once on tiny shapes, in
                     every rank of a process group of n ranks: chain-sharded
                     NUTS (with per-rank checkpoints and a resume) and
                     ChEES, the 2-D grid fit, the block-cyclic factor, the
                     row-sharded matrix-free fit, MLE and Bayes (1-D and,
                     for even n, chain x data), and data-sharded SGPR.

    python -m gaussian_processes_tpu_torch.dryrun                # entry() on cuda
    python -m gaussian_processes_tpu_torch.dryrun --device cpu
    torchrun --nproc-per-node 8 -m gaussian_processes_tpu_torch.dryrun --multichip
    (on the CPU: ... --multichip --device cpu, a gloo group)

Everything runs on this rank's card unless a device is given; a failed step
raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch


def _require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


def _flagship_step():
    from gaussian_processes_tpu_torch import GaussianKernel, fit, predict_diag

    def step(theta, x, y, xo):
        """theta = (h, w, noise) in natural space."""
        kernel = GaussianKernel(theta[0], theta[1])
        post = fit(kernel, x, y, theta[2], jitter=1e-6)
        mean, var = predict_diag(post, xo)
        return post.log_marginal, mean, var

    return step


def entry(device=None):
    """(step, example_args) of the flagship step, float32 on ``device``
    (default: this process's card)."""
    from gaussian_processes_tpu_torch.parallel.multihost import local_device
    from gaussian_processes_tpu_torch.utils.device import resolve_device

    device = resolve_device(device) if device is not None else local_device()
    rng = np.random.default_rng(0)
    n, m = 256, 128
    x = torch.as_tensor(np.sort(rng.uniform(-np.pi, np.pi, n)), dtype=torch.float32)
    y = torch.sin(2 * x) + 0.1 * torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    xo = torch.linspace(-np.pi, np.pi, m, dtype=torch.float32)
    theta = torch.tensor([1.0, 1.0, 0.1])
    return _flagship_step(), tuple(t.to(device) for t in (theta, x, y, xo))


def dryrun_multichip(n_devices: int, *, device=None) -> None:
    """Run every multi-device path once on tiny shapes.  Called by every
    rank of the default process group (none: one rank), which must have
    ``n_devices`` ranks; float32 on ``device`` (default: this rank's card)."""
    import torch.distributed as dist

    from gaussian_processes_tpu_torch import GaussianKernel
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.inference import init_positions, make_log_posterior
    from gaussian_processes_tpu_torch.models.sgpr import inducing_grid
    from gaussian_processes_tpu_torch.parallel.multihost import local_device
    from gaussian_processes_tpu_torch.utils.checkpoint import load_pytree, save_pytree
    from gaussian_processes_tpu_torch.utils.device import resolve_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a process group of "
                         f"{n_devices} ranks; it has {world}")
    device = resolve_device(device) if device is not None else local_device()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def finite(t):
        return bool(torch.isfinite(torch.as_tensor(t)).all())

    rng = np.random.default_rng(0)
    x_np = np.sort(rng.uniform(-np.pi, np.pi, 32))
    x = torch.as_tensor(x_np, dtype=torch.float32, device=device)
    y = torch.as_tensor(np.sin(x_np) + 0.1 * rng.standard_normal(32), dtype=torch.float32,
                        device=device)
    k0 = GaussianKernel(1.0, 1.0, dtype=torch.float32, device=device)

    # --- chain axis: sharded NUTS with pooled adaptation, each rank's state
    # written to its checkpoint every 2 steps and read back ---
    mesh_dp = par.make_chain_mesh(device=device)
    log_post = make_log_posterior(k0, x, y, prior_std=1.5, jitter=1e-6)
    init = init_positions(k0, 0.2, gen(1), n_chains=2 * n_devices, spread=0.2)
    with tempfile.TemporaryDirectory() as td:
        res = par.sample_nuts_sharded(log_post, init, gen(2), mesh=mesh_dp, num_warmup=3,
                                      num_samples=2, max_depth=3, chunk_size=2,
                                      checkpoint=os.path.join(td, "nuts.npz"))
        _require(tuple(res.positions.shape) == (2, 2 * n_devices, 3) and finite(res.positions),
                 f"sharded NUTS draws {tuple(res.positions.shape)}")
        # resume: save this rank's final state, place it back, collect on
        ck = par.host_checkpoint_path(os.path.join(td, "dryrun_state.npz"))
        save_pytree(ck, res.final)
        state2 = par.shard_put_nuts(load_pytree(ck, like=res.final), mesh_dp)
        res2 = par.collect_nuts_sharded(log_post, state2, 2, mesh=mesh_dp, max_depth=3)
        _require(tuple(res2.positions.shape) == (2, 2 * n_devices, 3) and finite(res2.positions),
                 "resumed NUTS draws")

    # the bring-up wrapper: a no-op with a group up or no cluster configured
    info = par.initialize_cluster()
    _require(info["process_count"] >= 1, f"initialize_cluster: {info}")

    # ChEES: shared trajectory jitter, per-rank momenta
    res_c = par.sample_chees_sharded(log_post, init, gen(2), mesh=mesh_dp, num_warmup=3,
                                     num_samples=2, max_leapfrog=8)
    _require(tuple(res_c.positions.shape) == (2, 2 * n_devices, 3) and finite(res_c.positions),
             "sharded ChEES draws")

    # --- 2-D grid: K built in blocks, gathered and factored ---
    mesh_tp = par.make_grid_mesh(n_devices, device=device)
    a, c = mesh_tp.shape
    post = par.fit_sharded(k0, x, y, 0.2, mesh_tp, jitter=1e-6)
    _require(finite(post.log_marginal), "fit_sharded lml")
    mean, var = par.predict_diag_sharded(post, torch.linspace(-3, 3, 16, device=device), mesh_tp)
    _require(finite(mean) and bool((var > 0).all()), "predict_diag_sharded")

    # --- large-N path: block-cyclic factor, no rank holds K ---
    mesh_1d = par.make_chain_mesh(axis="shard", device=device)
    post_bc = par.fit_blockcyclic(k0, x, y, 0.2, mesh_1d, block_size=4, jitter=1e-6)
    lml_bc, lml = float(post_bc.log_marginal), float(post.log_marginal)
    _require(abs(lml_bc - lml) <= 1e-4 * abs(lml),
             f"block-cyclic lml {lml_bc} vs fit_sharded's {lml}")

    # --- row-sharded matrix-free path: PCG with the pivoted-Cholesky
    # preconditioner and preconditioned SLQ ---
    mesh_it = par.make_row_mesh(device=device)
    post_it = par.fit_iterative_sharded(k0, x, y, 0.2, gen(3), mesh=mesh_it, num_probes=4,
                                        num_iters=32, jitter=1e-6, block_size=8,
                                        precond_rank=8)
    _require(finite(post_it.log_marginal), "fit_iterative_sharded lml")
    mean_it = par.predict_mean_iterative_sharded(
        post_it, torch.linspace(-3, 3, 10, device=device), mesh=mesh_it, block_size=8)
    _require(finite(mean_it), "predict_mean_iterative_sharded")
    k_mle, _, lml_mle, _ = par.fit_mle_iterative_sharded(
        k0, x, y, 0.2, gen(4), mesh=mesh_it, num_steps=2, num_probes=2, num_iters=16,
        block_size=8)
    _require(np.isfinite(lml_mle) and bool((k_mle.params > 0).all()), "fit_mle_iterative_sharded")

    # --- fully Bayesian at matrix-free scale: the data rows sharded under
    # the sampler, then the (chain x data) layout ---
    init_b = init_positions(k0, 0.2, gen(1), n_chains=2, spread=0.2)
    bayes = dict(num_probes=2, num_iters=16, block_size=8, num_warmup=2, num_samples=2,
                 max_leapfrog=4)
    layouts = [par.make_bayes_mesh(1, n_devices, device=device)]
    if n_devices % 2 == 0:
        layouts.append(par.make_bayes_mesh(2, n_devices // 2, device=device))
    for mesh_b in layouts:
        res_b = par.sample_chees_iterative_sharded(k0, x, y, init_b, gen(2), mesh=mesh_b,
                                                   **bayes)
        _require(tuple(res_b.positions.shape) == (2, 2, 3) and finite(res_b.positions),
                 f"data-sharded ChEES on {mesh_b.chain.world_size} x {mesh_b.data.world_size}")

    # --- data-sharded SGPR: one sum of the (m, m) moments ---
    z = inducing_grid(x, 8)
    post_sg = par.fit_sgpr_sharded(k0, x, y, 0.2, z, mesh=mesh_it, block_size=4)
    _require(finite(post_sg.log_marginal), "fit_sgpr_sharded bound")
    post_sgm, _ = par.fit_sgpr_mle_sharded(k0, x, y, 0.2, z, mesh=mesh_it, num_steps=2,
                                           block_size=4)
    _require(bool((post_sgm.kernel.params > 0).all()), "fit_sgpr_mle_sharded")

    if par.is_primary():
        print(f"dryrun_multichip({n_devices}): OK "
              f"(dp chains={2 * n_devices}, tp grid={a}x{c}, "
              f"block-cyclic chol lml match, row-sharded matrix-free "
              f"fit/MLE/Bayes, data-sharded SGPR)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gaussian_processes_tpu_torch.dryrun")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--multichip", action="store_true",
                    help="run dryrun_multichip over the launcher's process group")
    args = ap.parse_args(argv)
    from gaussian_processes_tpu_torch import parallel as par
    from gaussian_processes_tpu_torch.parallel.multihost import local_device

    device = torch.device(args.device)
    if args.multichip:
        info = par.initialize_cluster(backend="gloo" if device.type == "cpu" else None)
        if device.type == "cuda" and device.index is None:
            device = local_device()  # this rank's card
        dryrun_multichip(info["process_count"], device=device)
        par.shutdown_cluster()
        return 0
    fn, fn_args = entry(device)
    out = fn(*fn_args)
    print("entry OK:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    sys.exit(main())
