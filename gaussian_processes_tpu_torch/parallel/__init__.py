"""Parallel layer: process groups, chain sharding, row sharding.

Counterpart of ``gaussian_processes_tpu/parallel/``: a JAX mesh axis over D
devices becomes a ``torch.distributed`` process group of W ranks, one device
per rank (``RankMesh``; NCCL on CUDA cards, gloo on the CPU).  Callers pass
global inputs; each rank takes its block and results come back in the
global view.

The dense factor across ranks: ``block_cholesky.py`` (block-cyclic rows,
no rank ever holds K) and ``distributed_gp.py`` (K built in blocks over a
2-D grid of ranks, then gathered and factored on each).
"""

from gaussian_processes_tpu_torch.parallel.bayes_sharded import (
    BayesMesh,
    make_bayes_mesh,
    make_log_posterior_iterative_datasharded,
    sample_chees_iterative_sharded,
)
from gaussian_processes_tpu_torch.parallel.block_cholesky import (
    BlockCyclicPosterior,
    fit_blockcyclic,
    predict_diag_blockcyclic,
)
from gaussian_processes_tpu_torch.parallel.distributed_gp import (
    GridMesh,
    fit_sharded,
    make_grid_mesh,
    predict_diag_sharded,
)
from gaussian_processes_tpu_torch.parallel.iterative_sharded import (
    fit_iterative_sharded,
    fit_mle_iterative_sharded,
    log_marginal_value_and_grad_iterative_sharded,
    make_row_mesh,
    predict_mean_iterative_sharded,
)

from gaussian_processes_tpu_torch.parallel.mesh import RankMesh, make_mesh
from gaussian_processes_tpu_torch.parallel.multihost import (
    host_checkpoint_path,
    initialize_cluster,
    is_primary,
    shutdown_cluster,
)
from gaussian_processes_tpu_torch.parallel.sgpr_sharded import (
    elbo_sgpr_sharded,
    fit_sgpr_mle_sharded,
    fit_sgpr_sharded,
)
from gaussian_processes_tpu_torch.parallel.sharded import (
    ShardedCheesResult,
    ShardedNUTSResult,
    ShardedNUTSState,
    checkpoint_nuts_sharded,
    collect_chees_sharded,
    collect_nuts_sharded,
    init_chees_sharded,
    init_nuts_sharded,
    make_chain_mesh,
    sample_chees_sharded,
    sample_nuts_sharded,
    shard_put_chees,
    shard_put_nuts,
    warmup_chees_sharded,
    warmup_nuts_sharded,
)

__all__ = [
    "BlockCyclicPosterior",
    "fit_blockcyclic",
    "predict_diag_blockcyclic",
    "GridMesh",
    "fit_sharded",
    "make_grid_mesh",
    "predict_diag_sharded",
    "BayesMesh",
    "make_bayes_mesh",
    "make_log_posterior_iterative_datasharded",
    "sample_chees_iterative_sharded",
    "fit_iterative_sharded",
    "fit_mle_iterative_sharded",
    "log_marginal_value_and_grad_iterative_sharded",
    "make_row_mesh",
    "predict_mean_iterative_sharded",
    "elbo_sgpr_sharded",
    "fit_sgpr_mle_sharded",
    "fit_sgpr_sharded",
    "RankMesh",
    "make_mesh",
    "host_checkpoint_path",
    "initialize_cluster",
    "is_primary",
    "shutdown_cluster",
    "ShardedCheesResult",
    "ShardedNUTSResult",
    "ShardedNUTSState",
    "checkpoint_nuts_sharded",
    "collect_chees_sharded",
    "collect_nuts_sharded",
    "init_chees_sharded",
    "init_nuts_sharded",
    "sample_chees_sharded",
    "make_chain_mesh",
    "sample_nuts_sharded",
    "shard_put_chees",
    "shard_put_nuts",
    "warmup_chees_sharded",
    "warmup_nuts_sharded",
]
