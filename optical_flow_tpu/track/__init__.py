"""Sparse feature tracking (reference C16/C17: of.cpp:21-101,
OpticalFlowDemo.cpp:30-276 — OpenCV goodFeaturesToTrack +
calcOpticalFlowPyrLK demos).

Device-side design: everything is static-shape and batched —
- good_features_to_track returns a fixed-K corner array plus a validity
  mask (top_k over the min-eigenvalue map, max-pool non-max suppression
  instead of OpenCV's serial greedy minDistance pass),
- sparse LK iterates a fixed 20 steps with a convergence mask per feature
  (no data-dependent trip counts inside jit), all K features tracked as one
  batched 2x2 solve per iteration.
"""

from optical_flow_tpu.track.features import good_features_to_track, min_eig_map
from optical_flow_tpu.track.sparse_lk import track_features, SparseLKConfig

__all__ = [
    "good_features_to_track",
    "min_eig_map",
    "track_features",
    "SparseLKConfig",
]
