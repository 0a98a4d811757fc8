"""The column-sharded solve: the catalog's offering-column axis split over
S shards (parallel.mesh), the port of `karpenter_tpu/parallel`.

On one card the S shards are the S thread blocks of one thread-block
cluster (K7, `solver/ffd.py` `sharded_scan`; its kernel-level entries
are `ffd.sharded_solve_ffd` and `ffd.sharded_delta_ffd`); the per-step
maxima and the explain counts combine across the cluster through
distributed shared memory.
"""

from karpenter_tpu_torch.parallel.mesh import (
    MaskRowRegistry,
    Mesh,
    MeshExecutor,
    make_mesh,
    shard_problem,
)

__all__ = ["MaskRowRegistry", "Mesh", "MeshExecutor", "make_mesh",
           "shard_problem"]
