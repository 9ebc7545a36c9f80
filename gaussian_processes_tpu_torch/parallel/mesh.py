"""The port's stand-in for a 1-D ``jax.sharding.Mesh`` axis.

A JAX mesh axis over D devices becomes a ``torch.distributed`` process group
of W ranks, one device per rank.  ``RankMesh`` holds the group, this rank,
the world size and this rank's device, and carries the collectives the JAX
package spells ``psum`` / ``pmean`` / ``all_gather``: each is one
``torch.distributed`` call on the group.  Without a process group (one
process, no cluster configured) the mesh has one rank and every collective
is the identity.  Each collective, the identity too, counts one
``parallel.collectives`` in ``utils.profiling.counts``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gaussian_processes_tpu_torch.parallel.multihost import local_device
from gaussian_processes_tpu_torch.utils.device import resolve_device
from gaussian_processes_tpu_torch.utils.profiling import counts


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One mesh axis: ``group`` (None without a process group), ``rank`` in
    it, ``world_size``, this rank's ``device`` and the axis name."""

    group: object
    rank: int
    world_size: int
    device: torch.device
    axis: str

    def block(self, n: int, what: str = "n") -> slice:
        """This rank's rows [r n / W, (r + 1) n / W); ValueError unless W
        divides n."""
        if n % self.world_size != 0:
            raise ValueError(f"mesh size ({self.world_size}) must evenly divide "
                             f"{what} ({n})")
        b = n // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """A contiguous copy of ``t`` reduced over the ranks (``t`` is left
        as it was)."""
        counts["parallel.collectives"] += 1
        t = torch.clone(t.detach(), memory_format=torch.contiguous_format)
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return self.psum(t) / self.world_size

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim`` in rank order."""
        counts["parallel.collectives"] += 1
        if self.group is None:
            return t
        flag = t.dtype == torch.bool
        src = (t.to(torch.uint8) if flag else t.detach()).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if flag else out


def make_mesh(n_devices: int | None = None, axis: str = "i", *, device=None,
              group=None) -> RankMesh:
    """A ``RankMesh`` over ``group`` (default: the whole default process
    group when one is initialised, else a single rank).  ``n_devices``, when
    given, must equal the group's size (one device per process)."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for {n_devices} devices; the process group has {world} "
                         "ranks of one device each")
    device = resolve_device(device) if device is not None else local_device()
    return RankMesh(group=group, rank=rank, world_size=world, device=device, axis=axis)
