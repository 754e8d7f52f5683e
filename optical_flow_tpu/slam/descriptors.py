"""Appearance descriptors for frontend track verification & re-association.

The reference has no notion of feature identity at all — its sparse demos
re-seed goodFeaturesToTrack per frame and drop every correspondence
(of.cpp:51 re-detects on each 'r' keypress; OpticalFlowDemo.cpp:149
re-detects per pair). The LK frontend here (slam/incremental.py) chains
tracks across keyframes, which adds the classic chained-LK failure mode:
DRIFT — a sliding track keeps status=1 while creeping off its landmark,
feeding slowly-corrupting observations to PnP/BA with nothing to notice.

This module gives each track an appearance anchor: a mean-removed,
unit-normalized intensity patch sampled (bilinear, subpixel) at the
track's birth position. NCC against the anchor is then a dot product, so

  * track VERIFICATION is one batched row-wise dot per keyframe
    (`ncc_scores`), and
  * lost-track RE-ASSOCIATION is one (N, D) @ (D, M) matmul —
    plus mutual-nearest and Lowe-ratio gating (`match_descriptors`).

Patch sampling reuses the sparse-LK batched bilinear sampler
(track/sparse_lk._sample_patches), so the device path stays gather-light and
static-shape; callers bucket K with slam/incremental's _pad64 to bound
per-shape compiles on long videos.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optical_flow_tpu.track.sparse_lk import _sample_patches


@partial(jax.jit, static_argnames=("half",))
def patch_descriptors(img, pts, half: int = 7) -> jnp.ndarray:
    """Normalized patch descriptors at subpixel points.

    img: (H, W) grayscale; pts: (K, 2) float xy. Returns (K, D) with
    D = (2*half+1)^2: each row is the bilinear patch around the point,
    mean-removed and L2-normalized (so a @ b.T is NCC in [-1, 1]).
    Flat/out-of-image patches (zero variance after mean removal) come out
    as all-zero rows — they match nothing, which is the right failure.
    """
    img = jnp.asarray(img, jnp.float32)
    p = _sample_patches(img, jnp.asarray(pts, jnp.float32), half, extra=0)
    d = p.reshape(p.shape[0], -1)
    d = d - jnp.mean(d, axis=1, keepdims=True)
    n = jnp.sqrt(jnp.sum(d * d, axis=1, keepdims=True))
    return jnp.where(n > 1e-6, d / jnp.maximum(n, 1e-6), 0.0)


def ncc_scores(anchor: np.ndarray, current: np.ndarray) -> np.ndarray:
    """Row-wise NCC between two aligned (K, D) descriptor tables."""
    a = np.asarray(anchor, np.float32)
    b = np.asarray(current, np.float32)
    return np.sum(a * b, axis=1)


@jax.jit
def _score_matrix(da, db):
    return jnp.matmul(
        da, db.T, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def match_descriptors(
    da: np.ndarray,
    db: np.ndarray,
    *,
    min_score: float = 0.8,
    ratio: float = 0.85,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mutual-nearest NCC matching with a Lowe ratio test.

    da: (N, D), db: (M, D) normalized descriptors. Returns (idx, ok):
    idx[i] = best column in db for row i; ok[i] = the match is mutual,
    scores >= min_score, and beats the runner-up by the ratio margin
    (second_best <= ratio * best, in similarity form). Zero rows (flat
    patches) never match.
    """
    da = np.asarray(da, np.float32)
    db = np.asarray(db, np.float32)
    if da.shape[0] == 0 or db.shape[0] == 0:
        return (np.zeros(da.shape[0], np.int64),
                np.zeros(da.shape[0], bool))
    S = np.asarray(_score_matrix(jnp.asarray(da), jnp.asarray(db)))
    idx = np.argmax(S, axis=1)
    best = S[np.arange(len(da)), idx]
    # runner-up along each row for the ratio test (guard M == 1)
    if S.shape[1] > 1:
        S2 = S.copy()
        S2[np.arange(len(da)), idx] = -np.inf
        second = S2.max(axis=1)
    else:
        second = np.full(len(da), -np.inf, np.float32)
    mutual = np.argmax(S, axis=0)[idx] == np.arange(len(da))
    # Lowe ratio only makes sense for positive best scores: for best < 0,
    # ratio*best would INVERT the gate's semantics (ADVICE r3). Rows with
    # best <= 0 fail the ratio test outright — an NCC best match that is
    # anti-correlated is never a distinctive match.
    ok = (
        mutual
        & (best >= min_score)
        & (best > 0)
        & (second <= ratio * best)
    )
    return idx.astype(np.int64), ok


def verify_tracks(
    anchor_desc: np.ndarray,
    img,
    pts: np.ndarray,
    *,
    gate: float,
    half: int = 7,
) -> np.ndarray:
    """True where the current appearance still matches the track's anchor.

    anchor_desc: (K, D) descriptors captured at track birth; pts: (K, 2)
    current positions in img. A row passes when NCC(anchor, now) >= gate.
    Rows whose anchor is all-zero (flat at birth) are passed through —
    there is no appearance identity to enforce.
    """
    now = np.asarray(patch_descriptors(img, pts, half=half))
    s = ncc_scores(anchor_desc, now)
    no_anchor = np.abs(anchor_desc).sum(axis=1) < 1e-6
    return no_anchor | (s >= gate)
