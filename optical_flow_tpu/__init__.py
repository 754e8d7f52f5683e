"""optical_flow_tpu — a dense optical-flow and visual-tracking engine on JAX/XLA.

A from-scratch JAX/XLA framework with the capabilities of the reference
C++/OpenCV/OpenMP project `mileslindheimer/optical-flow` (pyramidal dense
Lucas–Kanade optical flow + video gesture tracking), redesigned for an
accelerator (an NVIDIA GPU):

- pure functional ops with OpenCV-faithful numerics (reference parity to the
  golden flow fields U2Test/V2Test and UPyrTest/VPyrTest),
- one plain-JAX path per stage, fused by XLA (gradients -> products ->
  window sums -> 2x2 Cramer solve), the same on every backend,
- multi-device scaling via `shard_map` over a `jax.sharding.Mesh` with
  `ppermute` halo exchange (rows/cols tiling) instead of OpenMP threads,
- a frame-parallel video pipeline (preprocess -> pyramidal flow -> gesture)
  with native (C++/libav) decode.

Layer map (mirrors SURVEY.md section 1):
  L0  ops/            dense-array backend (jnp/XLA)
  L1  ops/gradients, ops/window   flow kernels (fx/fy/ft, 3x3 window sums)
  L2  flow/lk.py      single-level dense LK solver
  L3  flow/coarse_to_fine.py      pyramid controller
  L4  pipeline/       video/gesture application drivers
  L5  track/          sparse-LK feature tracking (reference of.cpp analogue)
"""

from optical_flow_tpu.config import (
    FlowConfig,
    GestureConfig,
    PreprocessConfig,
    VideoConfig,
)
from optical_flow_tpu.flow.lk import lucas_kanade
from optical_flow_tpu.flow.coarse_to_fine import (
    coarse_to_fine,
    coarse_to_fine_pyramids,
    coarse_to_fine_with_images,
)
from optical_flow_tpu.flow.horn_schunck import HornSchunckConfig, horn_schunck
from optical_flow_tpu.ops.pyramid import (
    gaussian_pyramid,
    max_pyramid_levels,
    pyr_down,
    pyr_up,
)

__version__ = "0.1.0"

__all__ = [
    "FlowConfig",
    "GestureConfig",
    "PreprocessConfig",
    "VideoConfig",
    "lucas_kanade",
    "coarse_to_fine",
    "coarse_to_fine_pyramids",
    "coarse_to_fine_with_images",
    "horn_schunck",
    "HornSchunckConfig",
    "gaussian_pyramid",
    "max_pyramid_levels",
    "pyr_down",
    "pyr_up",
]
