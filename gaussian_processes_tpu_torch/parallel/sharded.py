"""Chain-parallel NUTS / ChEES-HMC over a process group.

Counterpart of ``gaussian_processes_tpu/parallel/sharded.py``: the chains
are split over the ranks of a ``RankMesh`` (rank r owns chains
[r C / W, (r + 1) C / W)), each rank steps its own block with the
single-process samplers of ``inference/``, and the warmup adaptation pools
over the whole population through collectives: ``all_reduce`` of the local
acceptance means divided by W, and an exact Welford merge that adds the
between-rank mean-shift term to M2 (Chan et al.), so W ranks adapt exactly
as one population up to reduction order.  A NUTS transition itself needs no
communication: each rank's lockstep tree loop ends on its own chains.

The samplers run as init / warmup / collect stages over a state that holds
the rank's chain block, the replicated adaptation state and the rank's
generators; a state saved between stages (``utils.save_pytree`` to
``multihost.host_checkpoint_path``, one file per rank) resumes bit for bit,
and ``sample_nuts_sharded(checkpoint=...)`` writes one every ``chunk_size``
steps through ``checkpoint_nuts_sharded``.  Results come back in the JAX
package's global view: positions (S, C, D), gathered over the ranks.  The
NUTS stages and the checkpoint round trip each open a span
(``gp.parallel.<stage>``), and each round trip counts one
``parallel.checkpoints`` in ``utils.profiling.counts``.

Random streams: the generators are derived once at init from the caller's
generator (one draw, the same on every rank) and the rank, and ride in the
state.  NUTS gets one generator per rank.  ChEES keeps its trajectory
jitter replicated, since every rank must integrate the same number of
leapfrogs, and draws momenta and acceptances from a per-rank generator
(the JAX package folds the device index into the momentum key only).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gaussian_processes_tpu_torch.inference import adaptation as adapt
from gaussian_processes_tpu_torch.inference import chees as chees_mod
from gaussian_processes_tpu_torch.inference import nuts as nuts_mod
from gaussian_processes_tpu_torch.parallel.mesh import RankMesh, make_mesh
from gaussian_processes_tpu_torch.utils.profiling import counts, span

_MASK64 = (1 << 64) - 1


def make_chain_mesh(n_devices: int | None = None, axis: str = "chain", *,
                    device=None) -> RankMesh:
    """The chain axis over the default process group (one device per
    rank); ``device`` defaults to ``multihost.local_device()``."""
    return make_mesh(n_devices, axis, device=device)


def rank_generator(generator, rank: int, device) -> torch.Generator:
    """A generator on ``device`` for ``rank``, seeded from one draw of
    ``generator`` (None: seed 0) mixed with the rank."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    base = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
    gen = torch.Generator(device=device)
    gen.manual_seed((base + (rank + 1) * 0x9E3779B97F4A7C15) & _MASK64)
    return gen


def _pooled_reducers(mesh: RankMesh):
    """Cross-rank pooling hooks for warmup adaptation (``sharded.py:56-74``
    of the JAX package): with equal chain counts per rank the mean of the
    local means is the global mean, and the Welford merge is exact."""

    def reduce_mean(x):
        return mesh.pmean(torch.mean(x))

    def reduce_welford(w):
        mean_g = mesh.pmean(w.mean)
        m2_g = mesh.psum(w.m2 + w.count * torch.square(w.mean - mean_g))
        return adapt.WelfordState(mean=mean_g, m2=m2_g, count=mesh.psum(w.count))

    def reduce_vec_mean(x):
        return mesh.pmean(torch.mean(x, dim=0))

    return reduce_mean, reduce_welford, reduce_vec_mean


def _local_block(init_position, mesh: RankMesh):
    init_position = torch.as_tensor(init_position)
    rows = mesh.block(init_position.shape[0], "chains")
    return init_position[rows].to(mesh.device)


def _mesh(mesh, axis):
    return mesh if mesh is not None else make_chain_mesh(axis=axis)


# ---------------------------------------------------------------------------
# NUTS
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedNUTSState(nuts_mod.SamplerState):
    """One rank's part of a chain-sharded NUTS run: ``chains`` is its (C/W,
    ...) block, the adaptation state (``da``, ``welford``, ``inv_mass``,
    ``step_size``) is the same on every rank, and ``generator`` is the
    rank's own.  ``utils.save_pytree`` checkpoints it and
    ``shard_put_nuts`` moves a loaded copy onto the rank's device."""


class ShardedNUTSResult(NamedTuple):
    positions: torch.Tensor  # (S, C, D), C the global chain count
    log_probs: torch.Tensor  # (S, C)
    accept_prob: torch.Tensor  # (S, C)
    num_leapfrog: torch.Tensor  # (S, C)
    diverging: torch.Tensor  # (S, C)
    step_size: torch.Tensor  # the same on every rank
    inv_mass: torch.Tensor  # (D,), the same on every rank
    final: ShardedNUTSState  # this rank's state: the resume point


def _as_sharded(s: nuts_mod.SamplerState) -> ShardedNUTSState:
    return ShardedNUTSState(**{f.name: getattr(s, f.name) for f in dataclasses.fields(s)})


def _tensors_to(tree, device):
    """Every tensor of a state moved to ``device`` (generators stay)."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tensors_to(t, device) for t in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tensors_to(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    return tree


def shard_put_nuts(state: ShardedNUTSState, mesh: RankMesh | None = None,
                   axis: str = "chain") -> ShardedNUTSState:
    """Place a (host-loaded) rank state onto the rank's device: the
    resume-from-checkpoint companion of ``save_pytree`` / ``load_pytree``."""
    return _tensors_to(state, _mesh(mesh, axis).device)


def init_nuts_sharded(log_density, init_position, generator=None, *,
                      mesh: RankMesh | None = None, axis: str = "chain",
                      init_step_size: float = 0.1) -> ShardedNUTSState:
    """This rank's sampler state from the global (C, D) positions; W must
    divide C."""
    mesh = _mesh(mesh, axis)
    pos = _local_block(init_position, mesh)
    gen = rank_generator(generator, mesh.rank, mesh.device)
    return _as_sharded(nuts_mod.init_sampler_state(log_density, pos, gen, init_step_size))


def warmup_nuts_sharded(log_density, state: ShardedNUTSState, num_warmup: int, *,
                        mesh: RankMesh | None = None, axis: str = "chain",
                        max_depth: int = 10, target_accept: float = 0.8,
                        max_delta_energy: float = 1000.0, start: int = 0,
                        stop: int | None = None, init_buffer: int = 75,
                        first_window: int = 25, term_buffer: int = 50) -> ShardedNUTSState:
    """Pooled-adaptation warmup, steps [start, stop) of the schedule of
    ``num_warmup`` steps with the given buffers (``nuts.continue_warmup``);
    a warmup checkpointed after ``start`` steps resumes here with the same
    buffers."""
    with span("gp.parallel.warmup_nuts_sharded"):
        reduce_mean, reduce_welford, _ = _pooled_reducers(_mesh(mesh, axis))
        s = nuts_mod.continue_warmup(
            log_density, state, num_warmup, start=start, stop=stop, max_depth=max_depth,
            target_accept=target_accept, max_delta_energy=max_delta_energy,
            reduce_mean=reduce_mean, reduce_welford=reduce_welford, init_buffer=init_buffer,
            first_window=first_window, term_buffer=term_buffer)
        return _as_sharded(s)


def collect_nuts_sharded(log_density, state: ShardedNUTSState, num_samples: int, *,
                         mesh: RankMesh | None = None, axis: str = "chain",
                         max_depth: int = 10,
                         max_delta_energy: float = 1000.0) -> ShardedNUTSResult:
    """Non-adaptive collection from a rank state, resumable: collect(2k)
    equals collect(k) then collect(k) from its ``final``.  The draws of all
    ranks are gathered into the global (S, C, ...) view."""
    with span("gp.parallel.collect_nuts_sharded"):
        mesh = _mesh(mesh, axis)
        res = nuts_mod.collect(log_density, state, num_samples, max_depth=max_depth,
                               max_delta_energy=max_delta_energy)
        return ShardedNUTSResult(
            positions=mesh.all_gather(res.positions, dim=1),
            log_probs=mesh.all_gather(res.log_probs, dim=1),
            accept_prob=mesh.all_gather(res.accept_prob, dim=1),
            num_leapfrog=mesh.all_gather(res.num_leapfrog, dim=1),
            diverging=mesh.all_gather(res.diverging, dim=1),
            step_size=res.step_size,
            inv_mass=res.inv_mass,
            final=_as_sharded(res.final),
        )


def _chunks(steps: int, chunk_size: int | None):
    """The (begin, end) ranges of ``steps`` steps split every ``chunk_size``
    (one range when None)."""
    size = chunk_size or steps
    return [(b, min(b + size, steps)) for b in range(0, steps, max(size, 1))]


def checkpoint_nuts_sharded(state: ShardedNUTSState, base: str,
                            mesh: RankMesh | None = None) -> ShardedNUTSState:
    """``state`` written to this rank's checkpoint file
    (``host_checkpoint_path(base)``) and read back onto the rank's device:
    the run continues from what a restart would load, bit for bit."""
    from gaussian_processes_tpu_torch.parallel.multihost import host_checkpoint_path
    from gaussian_processes_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    counts["parallel.checkpoints"] += 1
    with span("gp.parallel.checkpoint"):
        path = host_checkpoint_path(base)
        save_pytree(path, state)
        return shard_put_nuts(load_pytree(path, like=state), mesh)


def sample_nuts_sharded(log_density, init_position, generator=None, *,
                        mesh: RankMesh | None = None, axis: str = "chain",
                        num_warmup: int = 500, num_samples: int = 1000,
                        chunk_size: int | None = None, init_step_size: float = 0.1,
                        max_depth: int = 10, target_accept: float = 0.8,
                        max_delta_energy: float = 1000.0,
                        checkpoint: str | None = None) -> ShardedNUTSResult:
    """NUTS with the chains of the global (C, D) ``init_position`` split over
    the mesh's ranks (W must divide C); the same sampler as ``sample_nuts``
    over all C chains with pooled adaptation.  Called by every rank.

    With ``checkpoint`` (a base path) warmup and collection run in chunks
    of ``chunk_size`` steps (one chunk each when None), and after every
    chunk each rank writes its state to ``host_checkpoint_path(checkpoint)``
    and continues from the state it reads back, bit for bit the run
    without it.  Without ``checkpoint`` nothing happens between chunks, and
    ``chunk_size`` changes nothing (the JAX package's scan length has no
    counterpart in a host loop)."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    mesh = _mesh(mesh, axis)
    state = init_nuts_sharded(log_density, init_position, generator, mesh=mesh,
                              init_step_size=init_step_size)
    opts = dict(mesh=mesh, max_depth=max_depth, max_delta_energy=max_delta_energy)
    if checkpoint is None:
        chunk_size = None

    def saved(s):
        return s if checkpoint is None else checkpoint_nuts_sharded(s, checkpoint, mesh)

    for begin, end in _chunks(num_warmup, chunk_size):
        state = saved(warmup_nuts_sharded(log_density, state, num_warmup, start=begin, stop=end,
                                          target_accept=target_accept, **opts))
    parts = []
    for begin, end in _chunks(num_samples, chunk_size):
        parts.append(collect_nuts_sharded(log_density, state, end - begin, **opts))
        state = saved(parts[-1].final)
    return ShardedNUTSResult(
        *(torch.cat([getattr(p, f) for p in parts]) for f in ShardedNUTSResult._fields[:5]),
        step_size=state.step_size, inv_mass=state.inv_mass, final=state)


# ---------------------------------------------------------------------------
# ChEES
# ---------------------------------------------------------------------------


class ShardedCheesResult(NamedTuple):
    positions: torch.Tensor  # (S, C, D)
    log_probs: torch.Tensor
    accept_prob: torch.Tensor
    num_leapfrog: torch.Tensor  # (S,), shared across chains and ranks
    diverging: torch.Tensor
    step_size: torch.Tensor
    traj_length: torch.Tensor
    inv_mass: torch.Tensor
    final: chees_mod.CheesState  # this rank's chains, the rest replicated


def shard_put_chees(state: chees_mod.CheesState, mesh: RankMesh | None = None,
                    axis: str = "chain") -> chees_mod.CheesState:
    """Place a (host-loaded) ChEES rank state onto the rank's device."""
    return _tensors_to(state, _mesh(mesh, axis).device)


def init_chees_sharded(log_density, init_position, generator=None, *,
                       mesh: RankMesh | None = None, axis: str = "chain",
                       init_step_size: float = 0.1,
                       init_traj_length: float = 1.0) -> chees_mod.CheesState:
    """This rank's ChEES state: its chain block, a jitter generator shared
    by every rank and a momentum generator of its own."""
    mesh = _mesh(mesh, axis)
    pos = _local_block(init_position, mesh)
    jitter = rank_generator(generator, -1, mesh.device)
    momentum = rank_generator(generator, mesh.rank, mesh.device)
    return chees_mod.init_chees_state(log_density, pos, jitter, init_step_size=init_step_size,
                                      init_traj_length=init_traj_length,
                                      momentum_generator=momentum)


def warmup_chees_sharded(log_density, state: chees_mod.CheesState, num_warmup: int, *,
                         mesh: RankMesh | None = None, axis: str = "chain",
                         target_accept: float = 0.651, max_leapfrog: int = 1000,
                         start: int = 0, stop: int | None = None) -> chees_mod.CheesState:
    """Pooled ChEES warmup (step size, mass matrix, trajectory length),
    steps [start, stop) of the schedule."""
    reduce_mean, reduce_welford, reduce_vec_mean = _pooled_reducers(_mesh(mesh, axis))
    return chees_mod.chees_warmup(
        log_density, state, num_warmup, start=start, stop=stop, target_accept=target_accept,
        max_leapfrog=max_leapfrog, reduce_mean=reduce_mean, reduce_welford=reduce_welford,
        reduce_vec_mean=reduce_vec_mean)


def collect_chees_sharded(log_density, state: chees_mod.CheesState, num_samples: int, *,
                          mesh: RankMesh | None = None, axis: str = "chain",
                          max_leapfrog: int = 1000) -> ShardedCheesResult:
    """Fixed-settings ChEES collection, resumable like NUTS."""
    mesh = _mesh(mesh, axis)
    res = chees_mod.chees_collect(log_density, state, num_samples, max_leapfrog=max_leapfrog)
    return ShardedCheesResult(
        positions=mesh.all_gather(res.positions, dim=1),
        log_probs=mesh.all_gather(res.log_probs, dim=1),
        accept_prob=mesh.all_gather(res.accept_prob, dim=1),
        num_leapfrog=res.num_leapfrog,
        diverging=mesh.all_gather(res.diverging, dim=1),
        step_size=res.step_size,
        traj_length=res.traj_length,
        inv_mass=res.inv_mass,
        final=res.final,
    )


def sample_chees_sharded(log_density, init_position, generator=None, *,
                         mesh: RankMesh | None = None, axis: str = "chain",
                         num_warmup: int = 500, num_samples: int = 1000,
                         init_step_size: float = 0.1, init_traj_length: float = 1.0, target_accept: float = 0.651,
                         max_leapfrog: int = 1000) -> ShardedCheesResult:
    """ChEES-HMC with the chains split over the mesh's ranks: every rank
    integrates the same jittered trajectory length, and acceptance, the
    ChEES gradient and the Welford moments pool exactly across ranks."""
    mesh = _mesh(mesh, axis)
    state = init_chees_sharded(log_density, init_position, generator, mesh=mesh,
                               init_step_size=init_step_size,
                               init_traj_length=init_traj_length)
    state = warmup_chees_sharded(log_density, state, num_warmup, mesh=mesh,
                                 target_accept=target_accept, max_leapfrog=max_leapfrog)
    return collect_chees_sharded(log_density, state, num_samples, mesh=mesh,
                                 max_leapfrog=max_leapfrog)
