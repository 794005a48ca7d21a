"""The collective layer of the JAX package's `parallel/`, on
`torch.distributed` with one process per rank (`utils.platform.run_ranks`):
the (data, model) mesh, row-sharded embedding lookups, sharded top-k and
the explicitly sharded BPR-MF engine. The row-window-sharded adjacency
(`sharded_adj`, `sharded_gcn`) is not ported yet (ROADMAP.md, Queue 1)."""

from .embedding import (
    a2a_sharded_lookup,
    sharded_lookup,
    sharded_scatter_add,
    spmd_a2a_lookup,
    spmd_sharded_lookup,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    TABLE_PARAM_NAMES,
    batch_sharded,
    make_mesh,
    mesh_shape,
    param_shardings,
    pick_backend,
    replicated,
    row_block,
    row_sharded,
)
from .sharded_mf import ShardedMF
from .topk import sharded_user_topk

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "TABLE_PARAM_NAMES",
    "batch_sharded",
    "make_mesh",
    "mesh_shape",
    "param_shardings",
    "pick_backend",
    "replicated",
    "row_block",
    "row_sharded",
    "a2a_sharded_lookup",
    "sharded_lookup",
    "spmd_a2a_lookup",
    "spmd_sharded_lookup",
    "sharded_scatter_add",
    "sharded_user_topk",
    "ShardedMF",
]
