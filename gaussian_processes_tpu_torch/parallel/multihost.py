"""Multi-process bring-up and per-rank checkpoint naming.

Counterpart of ``gaussian_processes_tpu/parallel/multihost.py``: where the
JAX package calls ``jax.distributed.initialize``, the port initialises a
``torch.distributed`` process group (NCCL, one card per process; gloo with
the CPU when the caller asks for it).  The call is idempotent and a no-op
when no cluster is configured, so the same launch script runs as one
process or under a launcher (``torchrun`` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from gaussian_processes_tpu_torch.utils.device import resolve_device

_initialized = False


def _env_int(*names):
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return None


def _env_address():
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def local_device(backend: str | None = None) -> torch.device:
    """The device of this process: the CPU under a gloo group (``backend``,
    else the initialised group's), otherwise ``cuda:LOCAL_RANK`` (or the
    rank modulo the local card count), which raises without a card."""
    backend = backend or (dist.get_backend() if dist.is_initialized() else None)
    if backend == "gloo":
        return torch.device("cpu")
    local = _env_int("LOCAL_RANK")
    if local is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = rank % max(torch.cuda.device_count(), 1)
    return resolve_device(torch.device("cuda", local))


def initialize_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = 600.0,
) -> dict:
    """Bring up the default process group if a cluster is configured.

    Resolution order: explicit arguments, then the launcher variables
    ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, then the JAX
    package's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``.  With an address ("host:port") and a process count
    the group is initialised (a count of 1 gives a group of one rank, which
    still runs every collective); without them the call is a no-op.  More
    than one process without a rank raises ``ValueError``: defaulting every
    process to rank 0 would hang the rendezvous.  ``backend`` defaults to
    NCCL, which needs a card; a CPU group asks for ``backend="gloo"``.

    Returns a summary dict (process_index, process_count, device counts,
    initialized).
    """
    global _initialized
    coordinator_address = coordinator_address or _env_address()
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")

    if not dist.is_initialized() and coordinator_address and num_processes:
        if num_processes > 1 and process_id is None:
            raise ValueError("multi-process bring-up needs an explicit per-process rank "
                             "(process_id, or RANK in the environment)")
        backend = backend or "nccl"
        if backend == "nccl":
            torch.cuda.set_device(local_device(backend))
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id or 0,
            timeout=datetime.timedelta(seconds=timeout_s))
        _initialized = True
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": max(torch.cuda.device_count(), 1),
        "global_devices": count,
        "initialized": dist.is_initialized(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }


def shutdown_cluster() -> None:
    """Destroy the default process group that ``initialize_cluster`` made."""
    global _initialized
    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def host_checkpoint_path(base: str) -> str:
    """Per-rank checkpoint filename (each rank saves its own chain block)."""
    root, ext = os.path.splitext(base)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return f"{root}.host{rank}{ext or '.npz'}"


def is_primary() -> bool:
    """True on the process that should write logs and summaries."""
    return not dist.is_initialized() or dist.get_rank() == 0
