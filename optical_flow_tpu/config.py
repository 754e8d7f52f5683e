"""Configuration dataclasses.

The reference has no config system — operating points are compile-time
``#define``s and hardcoded constants (ParallelVideoPyr.cpp:728-729 DIFF_THRESH
/ LEARNING_RATE, :746-747 resolution, of.cpp:14 MAX_COUNT). Here every knob is
an explicit, hashable dataclass so configs can be passed as static args to
``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Dense pyramidal Lucas–Kanade configuration.

    Defaults reproduce the reference semantics exactly
    (LKof.cpp:152-228, SerialPyr.cpp:157-194).
    """

    # Pyramid levels. None -> max_pyramid_levels(shape) (LKof.cpp:230-249).
    levels: Optional[int] = None
    # Quantize warp-map fractions to 1/32 like OpenCV remap's fixed-point
    # interpolation tables (needed for golden parity; see ops/warp.py).
    quantize_warp: bool = True
    # Clamp per-level flow used for warping (needed to bound halo width when
    # spatially sharded; None = unbounded, faithful to the reference).
    warp_clamp: Optional[float] = None
    # Warp-and-solve passes per pyramid level. 1 = the reference's single
    # pass (golden-parity mode). >1 iteratively re-warps the level by the
    # accumulated flow and solves the residual (cv2-tracker-style),
    # improving accuracy for large motions — REQUIRES mode='corrected'
    # (reference-mode flow is not displacement, so re-warping diverges).
    level_iters: int = 1
    # Warp implementation: 'gather' = exact unbounded remap (four
    # bilinear gathers); 'shift_sep' = separable static-shift form,
    # REQUIRES warp_clamp (O(clamp), flow-space 1/32 px quantization,
    # ops/warp.py); 'auto' = shift_sep when warp_clamp is set, else
    # gather (flow/coarse_to_fine.py resolve_warp_impl).
    warp_impl: str = "auto"
    # 'reference': the reference's exact coarse-to-fine scheme (flow NOT
    #   doubled on pyrUp — its output is the goldens' quirky quantity, not
    #   pixel displacement).
    # 'corrected': standard pyramidal LK — flow doubled when upsampled,
    #   output is true pixel displacement (use with level_iters >= 2 for
    #   accurate flow; this is the mode real applications want).
    mode: str = "reference"


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Video frame preprocessing (ParallelVideoPyr.cpp:780-820).

    frame -> resize (cubic) -> GaussianBlur 9x9 sigma 1.5 -> gray ->
    diff = cur - learning_rate*prev -> threshold -> Sobel x+y ->
    dilate x2 -> erode x2.
    """

    size: Tuple[int, int] = (1080, 1080)  # (height, width)
    blur_ksize: int = 9
    blur_sigma: float = 1.5
    learning_rate: float = 0.3  # LEARNING_RATE, ParallelVideoPyr.cpp:729
    diff_thresh: float = 10.0  # DIFF_THRESH, ParallelVideoPyr.cpp:728
    morph_iterations: int = 2
    # True: reproduce the reference's uint8 saturating arithmetic for the
    # blur/gray/diff/threshold chain; False: do everything in float32 (faster
    # on the device, visually identical).
    faithful_uint8: bool = True


@dataclasses.dataclass(frozen=True)
class GestureConfig:
    """Gesture detection operating point (ParallelVideoPyr.cpp:845-890)."""

    mag_thresh: float = 20.0
    min_votes: int = 500
    circle_radius: int = 35
    norm_alpha: float = 255.0  # cv::normalize(mag, mag, 255), NORM_L2


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    preprocess: PreprocessConfig = PreprocessConfig()
    flow: FlowConfig = FlowConfig()
    gesture: GestureConfig = GestureConfig()

    @classmethod
    def fast(cls, size=(1080, 1080)) -> "VideoConfig":
        """Production-throughput preset: displacement-true pyramid with a
        clamped separable shift warp and batch-friendly state.
        Flow magnitudes are displacement
        (not the reference's inflated quantity); gesture vote counts on the
        demo video are comparable at default thresholds, but deployments
        should calibrate GestureConfig against their own footage."""
        return cls(
            preprocess=PreprocessConfig(size=size, faithful_uint8=False),
            flow=FlowConfig(mode="corrected", warp_clamp=8.0, warp_impl="auto"),
            faithful_prev_diff=False,
        )
    # Reference quirk: coarseToFineEstimation warps its inputs in place
    # (pyramid level 0 aliases them, LKof.cpp:193-226), and the video loop
    # then keeps the *warped* diff as prevDiff (ParallelVideoPyr.cpp:841).
    # True reproduces that, and warp_impl='auto' then resolves to the exact
    # gather (pipeline/video.py); False keeps the unwarped diff.
    faithful_prev_diff: bool = True
    # Frames processed together as a batch (frame-level data parallelism).
    batch: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for spatial tiling + frame parallelism.

    The reference's parallelism is OpenMP threads in one process
    (SURVEY.md section 2.3); the multi-device equivalents are:
      - rows/cols: spatial tiling of the image across devices, halo
        exchange via ppermute between neighbouring tiles (replaces
        shared-memory stencil reads),
      - frames: data parallelism over time (batch of frame pairs).
    """

    rows: int = 1
    cols: int = 1
    frames: int = 1
    axis_rows: str = "rows"
    axis_cols: str = "cols"
    axis_frames: str = "frames"
