"""Shi-Tomasi corner detection (cv2.goodFeaturesToTrack semantics).

Reference usage: of.cpp:51/:82 — goodFeaturesToTrack(gray, 500, 0.01, 10)
re-seeded when tracks decay; OpticalFlowDemo.cpp:149 the legacy C variant.

Pipeline (blockSize=3, Sobel aperture=3, like OpenCV's defaults):
  Sobel dx/dy -> structure tensor (box 3x3) -> lambda_min map ->
  threshold at quality_level * max(lambda_min) -> 3x3 non-max suppression ->
  minDistance suppression -> top-K by score.

Deviation (documented): OpenCV enforces minDistance with a
serial greedy scan over score-sorted corners; here minDistance is enforced
by a (2r+1) max-pool dominance test — a corner survives iff it is the
maximum within its minDistance neighbourhood. This is parallel, jit-stable,
and agrees with OpenCV except when two near-equal corners sit within
minDistance of each other (OpenCV keeps the earlier-sorted one, we keep the
larger one).

Returns fixed shapes: (max_corners, 2) float32 (x, y) + bool validity mask.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

from optical_flow_tpu.ops.window import _box3_cols, _box3_rows
from optical_flow_tpu.pipeline.preprocess import sobel3


def _box3(x):
    """Full 3x3 box sum (border included — unlike `sum3x3_interior`'s
    zero ring), composed from ops/window's shared separable passes."""
    return _box3_cols(_box3_rows(x))


def min_eig_map(img) -> jnp.ndarray:
    """Per-pixel smaller eigenvalue of the 3x3-summed structure tensor
    (cv2.cornerMinEigenVal up to a constant positive scale)."""
    dx = sobel3(img, 1, 0)
    dy = sobel3(img, 0, 1)
    sxx = _box3(dx * dx)
    syy = _box3(dy * dy)
    sxy = _box3(dx * dy)
    tr = 0.5 * (sxx + syy)
    d = 0.5 * (sxx - syy)
    return tr - jnp.sqrt(d * d + sxy * sxy)


def good_features_to_track(
    img,
    max_corners: int = 500,
    quality_level: float = 0.01,
    min_distance: float = 10.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Corner points as ((max_corners, 2) float32 xy, (max_corners,) bool).

    img: (H, W) grayscale, any float/uint dtype.

    Known deviation from cv2's serial greedy pass: two corners within
    min_distance whose scores tie BIT-EXACTLY both survive the max-pool
    test (cv2 keeps one). Real imagery never produces exact ties; only
    synthetic periodic patterns can.
    """
    H, W = img.shape[-2], img.shape[-1]
    score = min_eig_map(img.astype(jnp.float32))
    # OpenCV zeroes the border ring of the eigen map (cornerMinEigenVal
    # border handling makes edge corners unreliable anyway).
    edge = jnp.zeros_like(score)
    score = edge.at[..., 1:-1, 1:-1].set(score[..., 1:-1, 1:-1])

    # per-IMAGE quality threshold: a global max over leading batch dims
    # would couple images (one bright image's threshold killing another's
    # corners; round-5 review) — every other step here is already
    # per-image
    thresh = quality_level * jnp.max(score, axis=(-2, -1), keepdims=True)
    r = max(int(min_distance), 1)
    nb = score.ndim - 2
    pooled = lax.reduce_window(
        score,
        -jnp.inf,
        lax.max,
        window_dimensions=(1,) * nb + (2 * r + 1, 2 * r + 1),
        window_strides=(1,) * score.ndim,
        padding=[(0, 0)] * nb + [(r, r), (r, r)],
    )
    keep = (score >= thresh) & (score == pooled) & (score > 0)
    masked = jnp.where(keep, score, -jnp.inf)

    flat = masked.reshape(masked.shape[:-2] + (H * W,))
    vals, idx = lax.top_k(flat, max_corners)
    ys = (idx // W).astype(jnp.float32)
    xs = (idx % W).astype(jnp.float32)
    pts = jnp.stack([xs, ys], axis=-1)
    valid = jnp.isfinite(vals) & (vals > 0)
    return pts, valid
