"""The program under test, as the cells call it: ``gaussian_processes_tpu_torch``.

Only the kind modules and this file import the program; ``reference/``
never does.  The block-cyclic cells run on a mesh of one rank without a
process group, as the program's CLI runs config #4's ``fit_large`` in one
process: every collective of the path is then the identity (a contiguous
copy).  An NCCL group of one rank adds NCCL's host threads and a launch a
collective, and made the predictions' latency swing between runs (PERF.md).
"""

from __future__ import annotations

import torch


def block_mesh(device: torch.device):
    """The ``shard`` mesh of ``fit_blockcyclic``: one rank, no group."""
    from gaussian_processes_tpu_torch import parallel

    return parallel.make_chain_mesh(axis="shard", device=device)


def se_kernel(cfg: dict, dtype, device):
    from gaussian_processes_tpu_torch import GaussianKernel

    return GaussianKernel(cfg["h"], cfg["w"], dtype=dtype, device=device)
