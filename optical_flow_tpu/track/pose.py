"""Pose estimation from sparse feature tracks (north-star extension,
SURVEY.md section 7.7: LK -> tracks -> pose -> distributed BA).

Batched RANSAC: instead of the classic sequential hypothesize-verify
loop, ALL hypotheses are drawn, solved, and scored as one batch —
`n_hypotheses` minimal 4-point sets are sampled with a counter-based PRNG,
each yields a homography by normalized DLT (batched SVD), and
inlier counting is one (n_hypotheses, K) broadcast. Fixed shapes, no
data-dependent control flow; argmax picks the winner, refined by a final
DLT on its inliers (weighted, fixed-shape).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    n_hypotheses: int = 256
    inlier_px: float = 3.0
    seed: int = 0


def _normalize_points(pts, w):
    """Hartley normalization with weights w (K,): similarity T s.t. the
    weighted centroid is 0 and mean distance sqrt(2). Returns (pts_n, T)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    c = jnp.sum(pts * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((pts - c) ** 2, axis=-1))
    mean_d = jnp.sum(d * w) / wsum
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-9)
    T = jnp.array(
        [[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]], pts.dtype
    )
    pn = (pts - c) * s
    return pn, T


def _dlt_homography(p1, p2, w):
    """Weighted DLT: homography H (3,3) s.t. p2 ~ H p1, from K>=4 pairs.

    p1/p2: (K, 2); w: (K,) weights (0 excludes a pair). Normalized,
    solved by SVD of the (2K, 9) design matrix.
    """
    p1n, T1 = _normalize_points(p1, w)
    p2n, T2 = _normalize_points(p2, w)
    x, y = p1n[:, 0], p1n[:, 1]
    u, v = p2n[:, 0], p2n[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=-1)
    r2 = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, -v], axis=-1)
    A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)  # (2K, 9)
    # h = the null direction of A, via the 9x9 normal matrix: eigh's
    # smallest-eigenvalue eigenvector. The previous
    # svd(full_matrices=False) was WRONG for the documented K=4 minimal
    # case — an (8, 9) reduced vt spans only the row space, so vt[-1]
    # was not the vector with Ah=0 and exact correspondences produced a
    # garbage homography (round-5 review). full_matrices=True would fix
    # it but materializes a (2K, 2K) U inside the vmapped RANSAC; the
    # fixed-size normal matrix is exact for the minimal case and
    # conditioning-safe here (points are Hartley-normalized).
    ew, ev = jnp.linalg.eigh(A.T @ A)
    Hn = ev[:, 0].reshape(3, 3)  # ascending eigenvalues: column 0
    H = jnp.linalg.solve(T2, Hn @ T1)
    return H / jnp.where(jnp.abs(H[2, 2]) > 1e-12, H[2, 2], 1.0)


def _transfer_error(H, p1, p2):
    """Symmetric-free forward transfer error |H p1 - p2| per pair (K,)."""
    ones = jnp.ones((p1.shape[0], 1), p1.dtype)
    ph = jnp.concatenate([p1, ones], axis=-1) @ H.T
    proj = ph[:, :2] / jnp.where(jnp.abs(ph[:, 2:3]) > 1e-12, ph[:, 2:3], 1e-12)
    return jnp.sqrt(jnp.sum((proj - p2) ** 2, axis=-1))


@partial(jax.jit, static_argnames=("n_hypotheses",))
def _ransac_homography(p1, p2, valid, inlier_px, seed, n_hypotheses: int):
    K = p1.shape[0]
    key = jax.random.PRNGKey(seed)
    # Sample 4 indices per hypothesis, biased to valid points by gumbel
    # top-k over masked uniform scores (duplicates are astronomically
    # unlikely for K >> 4 and harmless: the DLT degenerates, scoring low).
    scores = jax.random.uniform(key, (n_hypotheses, K))
    scores = jnp.where(valid[None, :], scores, -jnp.inf)
    _, idx = jax.lax.top_k(scores, 4)  # (n_hypotheses, 4)

    def solve_one(ids):
        w = jnp.zeros((K,), p1.dtype).at[ids].set(1.0) * valid
        return _dlt_homography(p1, p2, w)

    Hs = jax.vmap(solve_one)(idx)  # (n, 3, 3)
    errs = jax.vmap(_transfer_error, in_axes=(0, None, None))(Hs, p1, p2)
    inl = (errs <= inlier_px) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    best_inl = inl[best]
    # Final refinement: weighted DLT over the winning consensus set.
    H = _dlt_homography(p1, p2, best_inl.astype(p1.dtype))
    final_err = _transfer_error(H, p1, p2)
    final_inl = (final_err <= inlier_px) & valid
    return H, final_inl, jnp.sum(final_inl)


def estimate_homography(
    pts1,
    pts2,
    valid=None,
    config: RansacConfig = RansacConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RANSAC homography from matched points.

    pts1/pts2: (K, 2) float32; valid: optional (K,) bool.
    Returns (H (3,3), inlier mask (K,) bool, inlier count).
    """
    p1 = jnp.asarray(pts1, jnp.float32)
    p2 = jnp.asarray(pts2, jnp.float32)
    v = (
        jnp.ones((p1.shape[0],), bool)
        if valid is None
        else jnp.asarray(valid, bool)
    )
    return _ransac_homography(
        p1, p2, v, jnp.float32(config.inlier_px), config.seed, config.n_hypotheses
    )
