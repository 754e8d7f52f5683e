"""Gesture detection from dense flow (reference C12,
ParallelVideoPyr.cpp:845-890).

Reference per-pixel scan: mag = sqrt(u^2 + v^2); pixels with mag >= 20 vote
(col, row) into a centroid; detection fires when votes > 500; the centroid
is drawn as a radius-35 circle after rescaling to original frame coords.
On the device the scan is two masked reductions, fused by XLA.

Faithfully-preserved quirks:
- `Mat mag = u` is a header alias, so writing the magnitude CLOBBERS u
  (the reference's u is the magnitude map after postprocessing). We return
  the magnitude separately instead of destroying the flow.
- `normalize(mag, mag, 255)` uses the default NORM_L2: mag * 255 / ||mag||_2
  (NOT a min-max rescale).
- `float scale = frame.cols / current_frame.cols` is INTEGER division in
  C++ — 0 whenever the capture is narrower than the resized frame. We keep
  true float rescaling and note the divergence.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from optical_flow_tpu.config import GestureConfig


class GestureResult(NamedTuple):
    detected: jnp.ndarray  # bool[...]: votes > min_votes
    cx: jnp.ndarray  # float[...]: centroid x (col) in flow coords
    cy: jnp.ndarray  # float[...]: centroid y (row)
    votes: jnp.ndarray  # int32[...]: number of voting pixels
    magnitude: jnp.ndarray  # float[..., H, W]: thresholded |flow|, L2-normalized


def flow_magnitude(u, v, mag_thresh: float = 20.0):
    """|flow| with sub-threshold pixels zeroed (ParallelVideoPyr.cpp:856-859).

    The same map `detect_gesture` thresholds internally (one source of
    the C12 boundary semantics: a pixel votes iff its magnitude survives
    here). Phrased on the KEEP side (mag >= thresh) so non-finite
    magnitudes zero out rather than leaking through the complement."""
    mag = jnp.sqrt(u * u + v * v)
    return jnp.where(mag >= mag_thresh, mag, jnp.zeros((), mag.dtype))


def detect_gesture(u, v, config: GestureConfig = GestureConfig()) -> GestureResult:
    """Centroid-of-motion detection over (..., H, W) flow fields.

    Leading axes are batch (frame parallelism); reductions are per-frame.
    """
    H, W = u.shape[-2], u.shape[-1]
    mag = jnp.sqrt(u * u + v * v)
    thresholded = flow_magnitude(u, v, config.mag_thresh)
    votes_mask = mag >= config.mag_thresh
    cols = jnp.arange(W, dtype=u.dtype)[None, :]
    rows = jnp.arange(H, dtype=u.dtype)[:, None]
    votes = jnp.sum(votes_mask, axis=(-2, -1))
    denom = jnp.maximum(votes, 1).astype(u.dtype)
    cx = jnp.sum(jnp.where(votes_mask, cols, 0), axis=(-2, -1)) / denom
    cy = jnp.sum(jnp.where(votes_mask, rows, 0), axis=(-2, -1)) / denom
    # cv::normalize default NORM_L2 to alpha: mag * alpha / ||mag||_2
    l2 = jnp.sqrt(jnp.sum(thresholded * thresholded, axis=(-2, -1), keepdims=True))
    normalized = jnp.where(
        l2 > 0, thresholded * (config.norm_alpha / jnp.maximum(l2, 1e-30)), thresholded
    )
    return GestureResult(
        detected=votes > config.min_votes,
        cx=cx,
        cy=cy,
        votes=votes.astype(jnp.int32),
        magnitude=normalized,
    )
