"""Multi-chip parallelism: device meshes, halo exchange, sharded flow.

The reference's entire parallel story is single-process OpenMP threads
(SURVEY.md section 2.3): task teams per matrix op and row-parallel loops.
The multi-device equivalents built here:

- frame parallelism (DP over time): batch of frame pairs sharded over a
  'frames' mesh axis,
- spatial tiling (the analogue of row-parallel loops, but across devices):
  2-D image tiles over ('rows', 'cols') axes with stencil halo exchange via
  `jax.lax.ppermute` — replacing the shared-memory neighbour reads
  OpenMP got for free,
- coarse pyramid levels run replicated (too small to shard profitably);
  fine levels run tiled.
"""

from optical_flow_tpu.parallel.mesh import flow_mesh, mesh_factorization
from optical_flow_tpu.parallel.halo import exchange_halo
from optical_flow_tpu.parallel.sharded_lk import sharded_lucas_kanade
from optical_flow_tpu.parallel.sharded_flow import (
    sharded_coarse_to_fine,
    sharded_coarse_to_fine_pyramids,
    sharded_coarse_to_fine_with_images,
)
from optical_flow_tpu.parallel.sharded_warp import sharded_symmetric_warp

__all__ = [
    "flow_mesh",
    "mesh_factorization",
    "exchange_halo",
    "sharded_lucas_kanade",
    "sharded_coarse_to_fine",
    "sharded_coarse_to_fine_pyramids",
    "sharded_coarse_to_fine_with_images",
    "sharded_symmetric_warp",
]
