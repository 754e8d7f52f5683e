"""Pyramidal sparse Lucas-Kanade tracking (cv2.calcOpticalFlowPyrLK
semantics; reference C16, of.cpp:55: 31x31 window, 3 pyramid levels,
20-iteration / 0.03-eps termination).

Structure:
- all K features tracked together: patch sampling is one batched bilinear
  gather (K, w+2, w+2); the iteration is a batched 2x2 solve;
- the Newton iterations run a FIXED 20 steps with a per-feature
  convergence mask (|delta| < eps freezes a feature) — no data-dependent
  trip counts inside jit, matching OpenCV's TermCriteria::COUNT+EPS;
- patch gradients use the Scharr 3x3 kernel scaled by 1/32, OpenCV's
  choice inside calcOpticalFlowPyrLK (video/src/lkpyramid.cpp).

Returns (new_points, status, err) like cv2: status=0 for features whose
tracking window left the image or whose gradient matrix was singular.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from optical_flow_tpu.ops.pyramid import gaussian_pyramid


@dataclasses.dataclass(frozen=True)
class SparseLKConfig:
    win: int = 31  # window side (of.cpp:55 Size(31,31))
    max_level: int = 2  # coarsest pyramid index (cv2 maxLevel; 3 levels total)
    iters: int = 20  # TermCriteria COUNT (of.cpp:44)
    eps: float = 0.03  # TermCriteria EPS
    min_eig_threshold: float = 1e-4  # cv2 minEigThreshold default


def _sample_patches(img, centers, half: int, extra: int = 1):
    """Bilinear patches around centers.

    img: (H, W); centers: (K, 2) float xy. Returns (K, w+2*extra, w+2*extra)
    with w = 2*half+1; out-of-range taps clamp to the border (edge
    replication — OpenCV's buildOpticalFlowPyramid pads with
    BORDER_REFLECT_101 instead, a small accuracy difference confined to
    windows overlapping the border).
    """
    H, W = img.shape
    w = 2 * half + 1 + 2 * extra
    offs = jnp.arange(w, dtype=jnp.float32) - (half + extra)
    cx = centers[:, 0][:, None, None]
    cy = centers[:, 1][:, None, None]
    xs = cx + offs[None, None, :]
    ys = cy + offs[None, :, None]
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx = xs - x0
    fy = ys - y0

    def tap(yi, xi):
        yc = jnp.clip(yi.astype(jnp.int32), 0, H - 1)
        xc = jnp.clip(xi.astype(jnp.int32), 0, W - 1)
        return img[yc, xc]

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def _scharr(patch):
    """Scharr 3x3 / 32 gradients of (K, n, n) -> two (K, n-2, n-2)."""
    s = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    # x-derivative: smooth rows with (3,10,3)/32, diff cols (-1,0,1)
    rs = s[0] * patch[:, :-2, :] + s[1] * patch[:, 1:-1, :] + s[2] * patch[:, 2:, :]
    ix = rs[:, :, 2:] - rs[:, :, :-2]
    cs = s[0] * patch[:, :, :-2] + s[1] * patch[:, :, 1:-1] + s[2] * patch[:, :, 2:]
    iy = cs[:, 2:, :] - cs[:, :-2, :]
    return ix, iy


def _track_level(img1, img2, pts, guess, cfg: SparseLKConfig):
    """One pyramid level of iterative LK for all K features."""
    half = cfg.win // 2
    H, W = img1.shape

    t_patch = _sample_patches(img1, pts, half, extra=1)  # (K, w+2, w+2)
    template = t_patch[:, 1:-1, 1:-1]
    ix, iy = _scharr(t_patch)  # (K, w, w)

    gxx = jnp.sum(ix * ix, axis=(1, 2))
    gxy = jnp.sum(ix * iy, axis=(1, 2))
    gyy = jnp.sum(iy * iy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    win_area = cfg.win * cfg.win
    min_eig = 0.5 * (gxx + gyy - jnp.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
    ok_eig = (min_eig / win_area) >= cfg.min_eig_threshold
    safe_det = jnp.where(det != 0, det, 1.0)

    def sample2(d):
        return _sample_patches(img2, pts + d, half, extra=0)

    def body(_, carry):
        d, live = carry
        j_patch = sample2(d)
        diff = j_patch - template
        bx = jnp.sum(diff * ix, axis=(1, 2))
        by = jnp.sum(diff * iy, axis=(1, 2))
        # G^-1 b (2x2 closed form)
        du = (gyy * bx - gxy * by) / safe_det
        dv = (gxx * by - gxy * bx) / safe_det
        delta = -jnp.stack([du, dv], axis=-1)
        d = jnp.where(live[:, None], d + delta, d)
        live = live & (jnp.sum(delta * delta, axis=-1) > cfg.eps * cfg.eps)
        return d, live

    live0 = ok_eig & (det != 0)
    d, _ = lax.fori_loop(0, cfg.iters, body, (guess, live0))

    # cv2 semantics: border points stay tracked (its pyramid carries a
    # window-sized padding ring); a feature is lost only when its center
    # leaves the image by more than the half-window.
    inb = (
        (pts[:, 0] + d[:, 0] >= -half)
        & (pts[:, 0] + d[:, 0] <= W - 1 + half)
        & (pts[:, 1] + d[:, 1] >= -half)
        & (pts[:, 1] + d[:, 1] <= H - 1 + half)
    )
    return d, live0 & inb


def build_tracking_pyramid(img, config: Optional[SparseLKConfig] = None):
    """Gaussian pyramid in the layout `track_features(..., pyr1/pyr2=)`
    consumes — sequential video tracking should build each frame's
    pyramid ONCE and pass it as img2's pyramid this step and img1's the
    next (the dense path's streaming reuse, pipeline/video.py; without
    it every frame's pyramid is built twice on the SLAM hot loop)."""
    cfg = config or SparseLKConfig()
    return tuple(
        p.astype(jnp.float32)
        for p in gaussian_pyramid(jnp.asarray(img, jnp.float32),
                                  cfg.max_level + 1)
    )


@partial(jax.jit, static_argnames=("cfg",))
def _track(img1, img2, pts, cfg: SparseLKConfig, pyr1=None, pyr2=None):
    levels = cfg.max_level + 1
    if pyr1 is None:
        pyr1 = gaussian_pyramid(img1, levels)
    if pyr2 is None:
        pyr2 = gaussian_pyramid(img2, levels)

    K = pts.shape[0]
    d = jnp.zeros((K, 2), jnp.float32)
    status = jnp.ones((K,), bool)
    for lvl in range(levels - 1, -1, -1):
        scale = jnp.float32(1 << lvl)
        pl_ = pts / scale
        d, ok = _track_level(
            pyr1[lvl].astype(jnp.float32), pyr2[lvl].astype(jnp.float32),
            pl_, d, cfg,
        )
        status = status & ok
        if lvl > 0:
            d = d * 2.0
    new_pts = pts + d

    half = cfg.win // 2
    err_patch1 = _sample_patches(img1.astype(jnp.float32), pts, half, extra=0)
    err_patch2 = _sample_patches(img2.astype(jnp.float32), new_pts, half, extra=0)
    err = jnp.mean(jnp.abs(err_patch2 - err_patch1), axis=(1, 2))
    return new_pts, status, err


def track_features(
    img1,
    img2,
    points,
    config: Optional[SparseLKConfig] = None,
    *,
    pyr1=None,
    pyr2=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """cv2.calcOpticalFlowPyrLK(img1, img2, points) analogue.

    img1/img2: (H, W) grayscale; points: (K, 2) float32 (x, y).
    pyr1/pyr2: optional prebuilt pyramids (`build_tracking_pyramid`) —
    sequential callers reuse each frame's pyramid across its two tracking
    steps instead of rebuilding it.
    Returns (new_points (K,2), status (K,) bool, err (K,) float32).
    """
    cfg = config or SparseLKConfig()
    pts = jnp.asarray(points, jnp.float32)
    return _track(
        jnp.asarray(img1, jnp.float32), jnp.asarray(img2, jnp.float32), pts,
        cfg, pyr1=pyr1, pyr2=pyr2,
    )
