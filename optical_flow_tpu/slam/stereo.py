"""Stereo depth for the SLAM frontend: rectified-pair disparity via the
same sparse-LK engine that tracks features over time.

The reference has no stereo (it is a monocular OpenCV LK project,
SURVEY.md §2), but its sparse-LK demo (of.cpp:21-101) is exactly the
machinery a rectified stereo matcher needs: on a rectified rig the
right-image correspondence of a left corner lies on the SAME scanline,
so `track_features(left, right, pts)` with an epipolar gate (|dy| small)
IS the stereo matcher — one jitted batched kernel, no new compute path.

Given the rig baseline, disparity fixes metric depth (Z = f·b/d), which
closes the one structural gap of the monocular pipeline: scale. A stereo
bootstrap makes the map metric from frame 0 (no parallax accumulation,
no |t|=1 gauge), and per-keyframe stereo depth keeps every new landmark
metric, so monocular scale drift never accumulates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


from optical_flow_tpu.track.sparse_lk import SparseLKConfig, track_features


def stereo_match(
    left,
    right,
    pts,
    *,
    max_dy: float = 1.5,
    min_disparity: float = 0.25,
    max_disparity: Optional[float] = None,
    config: Optional[SparseLKConfig] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Match left-image points into a rectified right image.

    pts: (K, 2) float32 (x, y) in the LEFT image.
    Returns (disparity (K,) float32, ok (K,) bool, matched (K, 2) — the
    measured right-image pixels, the BA's right-eye observations).
    disparity = x_l − x_r (positive for a standard rig: the right camera
    sees points shifted left). The epipolar gate rejects matches that
    drift off the scanline (|Δy| > max_dy — on a rectified rig those are
    LK failures, whatever their status flag says), as are non-positive
    or out-of-range disparities.
    """
    pts = np.asarray(pts, np.float32)
    if config is None:
        # disparity is systematically LARGER than temporal flow (a whole
        # baseline of parallax in one hop): one extra pyramid level over
        # the cv2-default 3 raises the capture range past typical rig
        # disparities (measured on the synthetic rig: a uniform 20 px
        # disparity is found by 62/200 corners at max_level=2 but
        # 196/200 at max_level=3, tests/test_stereo_slam.py)
        config = SparseLKConfig(max_level=3)
    matched, status, _ = track_features(left, right, pts, config)
    matched = np.asarray(matched, np.float32)
    disp = pts[:, 0] - matched[:, 0]
    dy = np.abs(pts[:, 1] - matched[:, 1])
    ok = np.asarray(status, bool) & (dy <= max_dy) & (disp >= min_disparity)
    if max_disparity is not None:
        ok &= disp <= max_disparity
    return disp.astype(np.float32), ok, matched


def stereo_backproject(
    pts, disp, focal: float, cx: float, cy: float, baseline: float
) -> np.ndarray:
    """Metric 3-D points in the LEFT camera frame from pixel + disparity.

    Z = focal·baseline / disparity; X, Y from the pinhole model. pts may
    include rows with invalid disparity — guard with the `ok` mask from
    stereo_match before trusting the output.
    """
    pts = np.asarray(pts, np.float32)
    disp = np.maximum(np.asarray(disp, np.float32), 1e-6)
    z = np.float32(focal * baseline) / disp
    x = (pts[:, 0] - np.float32(cx)) * z / np.float32(focal)
    y = (pts[:, 1] - np.float32(cy)) * z / np.float32(focal)
    return np.stack([x, y, z], axis=1)


def dense_disparity(left, right, *, config=None, max_dy: float = 1.0):
    """DENSE sub-pixel disparity from the flagship pyramidal-LK engine.

    On a rectified rig, left→right optical flow IS the disparity field:
    u = −disparity, v ≈ 0. This reuses the whole dense-flow stack —
    clamped warps, streaming pyramids — so dense depth runs at
    dense-flow speed instead of the per-corner sparse path.

    Returns (disparity (H, W) float32, valid (H, W) bool). `valid`
    rejects pixels whose vertical flow exceeds max_dy (off-scanline ⇒
    the match is wrong on a rectified rig) or whose disparity is
    non-positive (behind the rig / textureless solve).
    """
    import jax.numpy as jnp_

    from optical_flow_tpu.config import FlowConfig
    from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine

    if config is None:
        # displacement-true flow (the reference's quirky no-double pyrUp
        # mode would NOT return pixel-true disparities). clamp 24, not
        # the video default 8: rig disparities are systematically larger
        # than frame-to-frame motion, and the per-level warp clamp is
        # the binding limit (measured on the synthetic rig at 12-40 px
        # true disparity: clamp 8 -> 33% valid / 2.0 px median error,
        # clamp 24 -> 92% / 0.97 px; at <= 13 px disparity the engine is
        # at 0.12 px / 100% valid either way).
        config = FlowConfig(mode="corrected", warp_clamp=24.0)
    u, v = coarse_to_fine(
        jnp_.asarray(left, jnp_.float32), jnp_.asarray(right, jnp_.float32),
        config.levels, config=config,
    )
    disp = -u
    valid = (jnp_.abs(v) <= max_dy) & (disp > 0)
    return disp, valid


def dense_depth(disparity, focal: float, baseline: float, valid=None):
    """Metric depth map Z = focal·baseline / disparity; invalid or
    non-positive disparities → 0 (the cv::divide x/0→0 convention the
    rest of the engine uses)."""
    import jax.numpy as jnp_

    d = jnp_.asarray(disparity, jnp_.float32)
    ok = d > 1e-6
    if valid is not None:
        ok = ok & valid
    z = jnp_.where(ok, jnp_.float32(focal * baseline) / jnp_.maximum(d, 1e-6), 0.0)
    return z


def split_sbs(frame) -> Tuple[np.ndarray, np.ndarray]:
    """Split a side-by-side stereo frame (left|right) into the pair.

    The standard packing for stereo video files; `python -m
    optical_flow_tpu slam --stereo-sbs <baseline>` feeds video through
    this. Odd widths drop the centre column (a rectified SBS frame is
    even-width by construction).
    """
    f = np.asarray(frame)
    # the WIDTH axis: -1 for (..., H, W) gray, -2 when a trailing channel
    # axis is present — splitting a color frame's channels into "left"
    # and "right" was shape-valid garbage (round-5 review)
    ax = -2 if (f.ndim >= 3 and f.shape[-1] in (1, 3, 4)) else -1
    W = f.shape[ax]
    w = W // 2
    left = np.take(f, np.arange(w), axis=ax)
    right = np.take(f, np.arange(W - w, W), axis=ax)
    return left, right
