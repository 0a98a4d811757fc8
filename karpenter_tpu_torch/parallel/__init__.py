"""The column-sharded solve: the catalog's offering-column axis split over
S shards (parallel.mesh), the port of `karpenter_tpu/parallel`.

On one card the S shards are the S thread blocks of one thread-block
cluster (K7, `solver/ffd.py` `sharded_scan`; its kernel-level entries
are `ffd.sharded_solve_ffd` and `ffd.sharded_delta_ffd`); the per-step
maxima and the explain counts combine across the cluster through
distributed shared memory.  On a host of S cards (a mesh of cards,
`card_mesh`) shard r lives on card r and K7x (`ffd.card_scan`) runs one
rank a card, the combinations exchanged between the cards' kernels over
NVLink.  `resolve_mesh` turns a mesh spec into either form.
"""

from karpenter_tpu_torch.parallel.mesh import (
    MaskRowRegistry,
    Mesh,
    MeshExecutor,
    card_mesh,
    make_mesh,
    probe_cards,
    resolve_mesh,
    shard_problem,
)

__all__ = ["MaskRowRegistry", "Mesh", "MeshExecutor", "card_mesh",
           "make_mesh", "probe_cards", "resolve_mesh", "shard_problem"]
