"""Pose-graph optimization, loop-closure detection, and relocalization.

The drift-correction layer above the incremental front end (SURVEY.md
section 7.7 north star; the reference has no SLAM at all). Keyframe poses
are nodes; relative-pose measurements (odometry from the two-view/PnP
chain, loop closures from place recognition + geometric verification) are
edges. Gauss-Newton on SE(3) with the first pose fixed distributes the
accumulated drift around every cycle.

Device-first shape: all residuals/Jacobians evaluate as one batched jit
(edges are arrays, not Python objects), the normal equations are a dense
6(N-1) system solved as one dense solve — for the hundreds-of-keyframes scale
this targets, dense beats sparse bookkeeping.

Pose convention: T_i = (R_i, t_i) maps WORLD -> CAMERA i (X_c = R X_w + t),
matching epipolar.recover_pose / pnp_dlt. An edge (i, j) measures
T_ij = T_j * T_i^{-1} (camera-j-from-camera-i).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optical_flow_tpu.slam.epipolar import _exp_so3  # shared SO(3) utils


def _log_so3(R):
    """Axis-angle from a rotation matrix, VALUE- and GRADIENT-safe at the
    identity — where every pose-graph residual lives. (An arccos(trace)
    form has an infinite derivative at theta=0, which silently NaNs the
    Gauss-Newton Jacobian and freezes the optimizer.) Like all skew-part
    formulas it degrades as theta -> pi; graph residuals never get there.
    """
    v = 0.5 * jnp.asarray(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )  # sin(theta) * axis
    c = jnp.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    s = jnp.sqrt(jnp.sum(v * v) + 1e-12)  # floored: theta/s -> 1 at identity
    # (1e-12, not smaller: grad paths through 1/s^2 must stay normal f32)
    return v * (jnp.arctan2(s, c) / s)


@dataclasses.dataclass
class PoseGraph:
    """Nodes: (N, 3, 3) rotations + (N, 3) translations (world->cam).
    Edges: index arrays + measured relative poses + scalar weights."""

    Rs: np.ndarray
    ts: np.ndarray
    ei: List[int] = dataclasses.field(default_factory=list)
    ej: List[int] = dataclasses.field(default_factory=list)
    Rm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tm: List[np.ndarray] = dataclasses.field(default_factory=list)
    wt: List[float] = dataclasses.field(default_factory=list)

    def add_edge(self, i: int, j: int, R_ij, t_ij, weight: float = 1.0):
        self.ei.append(int(i))
        self.ej.append(int(j))
        self.Rm.append(np.asarray(R_ij, np.float32))
        self.tm.append(np.asarray(t_ij, np.float32))
        self.wt.append(float(weight))

    @staticmethod
    def from_odometry(Rs, ts, weight: float = 1.0) -> "PoseGraph":
        """Chain graph: consecutive relative poses measured from the given
        (possibly drifted) trajectory itself — the usual starting point
        before loop closures are added."""
        Rs = np.asarray(Rs, np.float32)
        ts = np.asarray(ts, np.float32)
        g = PoseGraph(Rs=Rs.copy(), ts=ts.copy())
        for i in range(len(Rs) - 1):
            R_ij, t_ij = relative_pose(Rs[i], ts[i], Rs[i + 1], ts[i + 1])
            g.add_edge(i, i + 1, R_ij, t_ij, weight)
        return g

    def optimize(self, iters: int = 12) -> Tuple[np.ndarray, np.ndarray]:
        """Gauss-Newton; returns optimized (Rs, ts). Pose 0 is the gauge."""
        E = len(self.ei)
        if E == 0:
            return self.Rs.copy(), self.ts.copy()
        Rn, tn = _optimize_pose_graph(
            jnp.asarray(self.Rs),
            jnp.asarray(self.ts),
            jnp.asarray(self.ei, jnp.int32),
            jnp.asarray(self.ej, jnp.int32),
            jnp.asarray(np.stack(self.Rm)),
            jnp.asarray(np.stack(self.tm)),
            jnp.asarray(self.wt, jnp.float32),
            iters,
        )
        return np.asarray(Rn), np.asarray(tn)

    def residual_norms(self) -> np.ndarray:
        """Per-edge residual magnitudes (se3 norm) at the current poses."""
        if not self.Rm:  # edgeless graph (e.g. a 1-pose chain)
            return np.zeros((0,), np.float32)
        r = _edge_residuals(
            jnp.asarray(self.Rs), jnp.asarray(self.ts),
            jnp.asarray(self.ei, jnp.int32), jnp.asarray(self.ej, jnp.int32),
            jnp.asarray(np.stack(self.Rm)), jnp.asarray(np.stack(self.tm)),
        )
        return np.asarray(jnp.linalg.norm(r, axis=-1))


def relative_pose(Ri, ti, Rj, tj):
    """T_j * T_i^{-1}: the pose of camera j expressed relative to i."""
    Ri, ti, Rj, tj = (np.asarray(a, np.float32) for a in (Ri, ti, Rj, tj))
    R = Rj @ Ri.T
    t = tj - R @ ti
    return R, t


def _edge_residuals(Rs, ts, ei, ej, Rm, tm):
    Ri, ti = Rs[ei], ts[ei]
    Rj, tj = Rs[ej], ts[ej]
    Rrel = jnp.einsum("eab,ecb->eac", Rj, Ri)  # Rj Ri^T
    trel = tj - jnp.einsum("eab,eb->ea", Rrel, ti)
    Re = jnp.einsum("eba,ebc->eac", Rm, Rrel)  # Rm^T Rrel
    te = jnp.einsum("eba,eb->ea", Rm, trel - tm)
    rot = jax.vmap(_log_so3)(Re)
    return jnp.concatenate([rot, te], axis=-1)  # (E, 6)


@partial(jax.jit, static_argnames=("iters",))
def _optimize_pose_graph(Rs, ts, ei, ej, Rm, tm, wt, iters: int):
    N = Rs.shape[0]
    damp = jnp.asarray(1e-8, Rs.dtype)

    def residuals(theta, Rs, ts):
        # theta: (N-1, 6) left-perturbations of poses 1..N-1 (pose 0 fixed)
        delta = jnp.concatenate([jnp.zeros((1, 6), Rs.dtype), theta.reshape(-1, 6)])
        dR = jax.vmap(_exp_so3)(delta[:, :3])
        Rn = jnp.einsum("nab,nbc->nac", dR, Rs)
        tn = jnp.einsum("nab,nb->na", dR, ts) + delta[:, 3:]
        r = _edge_residuals(Rn, tn, ei, ej, Rm, tm)
        return (r * wt[:, None]).reshape(-1)

    def apply(theta, Rs, ts):
        delta = jnp.concatenate([jnp.zeros((1, 6), Rs.dtype), theta.reshape(-1, 6)])
        dR = jax.vmap(_exp_so3)(delta[:, :3])
        return (
            jnp.einsum("nab,nbc->nac", dR, Rs),
            jnp.einsum("nab,nb->na", dR, ts) + delta[:, 3:],
        )

    def step(_, carry):
        Rs, ts = carry
        z = jnp.zeros(((N - 1) * 6,), Rs.dtype)
        r = residuals(z, Rs, ts)
        J = jax.jacfwd(residuals)(z, Rs, ts)  # (6E, 6(N-1))
        H = J.T @ J + damp * jnp.eye((N - 1) * 6, dtype=Rs.dtype)
        delta = -jnp.linalg.solve(H, J.T @ r)
        r_new = residuals(delta, Rs, ts)
        ok = jnp.sum(r_new * r_new) < jnp.sum(r * r)
        delta = jnp.where(ok, delta, jnp.zeros_like(delta))
        return apply(delta, Rs, ts)

    return jax.lax.fori_loop(0, iters, step, (Rs, ts))


# ------------------------------------------------------------ place index


def thumbnail_descriptor(img, size: int = 16) -> np.ndarray:
    """Tiny normalized-intensity global descriptor (zero mean, unit norm)
    for loop-closure candidate proposal — deliberately reference-scale
    (no learned features): nearby viewpoints of the same place correlate
    strongly at 16x16."""
    import jax.image

    x = jnp.asarray(np.asarray(img), jnp.float32)
    d = jax.image.resize(x, (size, size), "linear").reshape(-1)
    d = d - jnp.mean(d)
    n = jnp.linalg.norm(d)
    return np.asarray(d / jnp.maximum(n, 1e-9))


@partial(jax.jit, static_argnames=("size", "n_rho", "n_theta"))
def _fourier_mellin(x, size: int, n_rho: int, n_theta: int):
    import jax.image

    x = jax.image.resize(x.astype(jnp.float32), (size, size), "linear")
    x = x - jnp.mean(x)
    # Hann window kills the image-border discontinuity the DFT would
    # otherwise turn into dominant axis-aligned spectral energy
    n = jnp.arange(size, dtype=jnp.float32)
    hann = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * n / (size - 1))
    x = x * hann[:, None] * hann[None, :]
    F = jnp.abs(jnp.fft.fftshift(jnp.fft.fft2(x)))
    # log-polar resample: rotation -> shift along theta, scale -> shift
    # along log-rho. Upper half-plane only (real-image spectra are
    # centrally symmetric).
    c = size / 2.0
    rho = jnp.exp(
        jnp.linspace(jnp.log(2.0), jnp.log(c * 0.9), n_rho, dtype=jnp.float32)
    )
    th = jnp.linspace(0.0, jnp.pi, n_theta, endpoint=False, dtype=jnp.float32)
    yy = c + rho[:, None] * jnp.sin(th)[None, :]
    xx = c + rho[:, None] * jnp.cos(th)[None, :]
    from jax.scipy.ndimage import map_coordinates

    L = map_coordinates(F, [yy, xx], order=1, mode="nearest")
    L = jnp.log1p(L)  # compress spectral dynamic range
    L = L - jnp.mean(L)
    # second |FFT|: the rotation/scale shifts become phase, discarded
    M = jnp.abs(jnp.fft.fft2(L))
    # low frequencies carry the place identity; high ones carry noise
    M = jnp.concatenate([M[:6], M[-5:]], axis=0)
    M = jnp.concatenate([M[:, :8], M[:, -7:]], axis=1)
    v = M.reshape(-1)
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-9)


def place_descriptor(
    img, size: int = 64, n_rho: int = 24, n_theta: int = 32
) -> np.ndarray:
    """Global place-recognition descriptor, tolerant to in-plane rotation,
    scale, translation, and brightness/contrast shifts (Fourier-Mellin):
    |FFT| of the image is translation invariant; log-polar resampling of
    the spectrum turns rotation and scale into shifts; a second |FFT|
    magnitude makes those invariant too; windowing + per-stage
    normalization handles illumination. One jitted program per size.

    Upgrade over `thumbnail_descriptor` (kept for nearby-view ranking):
    the thumbnail NCC collapses under viewpoint change — a 25-degree
    rotation + 15% zoom + brightness shift defeats it while this
    descriptor still ranks the true revisit first
    (tests/test_pose_graph.py::test_place_descriptor_survives_viewpoint_change).
    """
    x = jnp.asarray(np.asarray(img), jnp.float32)
    return np.asarray(_fourier_mellin(x, size, n_rho, n_theta))


def propose_loop_candidates(
    descriptors, min_separation: int = 10, max_candidates: int = 5
) -> List[Tuple[int, int, float]]:
    """(i, j, distance) pairs with |i - j| >= min_separation, closest
    first — candidates for geometric verification."""
    D = np.stack([np.asarray(d) for d in descriptors])
    N = len(D)
    dist = np.linalg.norm(D[:, None, :] - D[None, :, :], axis=-1)
    ii, jj = np.triu_indices(N, k=min_separation)
    if len(ii) == 0:
        return []
    order = np.argsort(dist[ii, jj])[:max_candidates]
    return [(int(ii[k]), int(jj[k]), float(dist[ii[k], jj[k]])) for k in order]


def verify_loop_closure(
    img_i,
    img_j,
    focal: float,
    cx: float,
    cy: float,
    *,
    min_inliers: int = 30,
    max_corners: int = 300,
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Geometric verification of a loop candidate: corners on img_i,
    sparse-LK matches into img_j, minimal (5-point) essential RANSAC + LO
    pose refinement. Loop-candidate matches are exactly where inlier
    ratios run low (independent corner sets, appearance drift), which is
    where minimal 5-samples (w^5 all-inlier odds vs w^8) earn their keep.
    Returns (R_ij, t_ij (unit), n_inliers) — camera-j-from-camera-i with
    UNOBSERVABLE translation scale (scale it from the map before adding
    the edge) — or None if support is too weak."""
    from optical_flow_tpu.slam.epipolar import (
        estimate_essential,
        normalize_pixels,
        ransac_essential_5pt,
        recover_pose,
        refine_pose,
    )
    from optical_flow_tpu.track.features import good_features_to_track
    from optical_flow_tpu.track.sparse_lk import track_features

    pts, valid = good_features_to_track(jnp.asarray(img_i), max_corners, 0.01, 8)
    new, status, _ = track_features(img_i, img_j, pts)
    ok = np.asarray(valid) & np.asarray(status)
    if ok.sum() < 8:
        return None
    p1 = np.asarray(normalize_pixels(np.asarray(pts), focal, cx, cy))
    p2 = np.asarray(normalize_pixels(np.asarray(new), focal, cx, cy))
    try:
        E, inl, count = ransac_essential_5pt(p1, p2, valid=ok)
    except (RuntimeError, np.linalg.LinAlgError):
        # every minimal sample degenerate, or a batched eig blow-up:
        # the 8-point batch is the fallback
        E, inl, count = estimate_essential(p1, p2, valid=ok)
    if int(count) < min_inliers:
        return None
    inl_np = np.asarray(inl)
    R0, t0, _ = recover_pose(E, jnp.asarray(p1)[inl_np], jnp.asarray(p2)[inl_np])
    R1, t1, _ = refine_pose(R0, t0, p1, p2, inliers=inl_np)
    return np.asarray(R1), np.asarray(t1), int(count)


# ----------------------------------------------------------- relocalization


def relocalize(
    frame,
    keyframes,
    kf_tracks,
    points,
    focal: float,
    cx: float,
    cy: float,
    *,
    min_inliers: int = 20,
) -> Optional[Tuple[np.ndarray, np.ndarray, int, int]]:
    """Recover the pose of a 'lost' frame against an existing map.

    Place recognition picks the closest keyframe by thumbnail descriptor;
    that keyframe's 2D observations of the map points (kf_tracks[k]:
    (P, 2) pixels, e.g. MultiViewReconstruction.tracks) are sparse-LK
    tracked into the new frame; robust PnP against the (P, 3) world
    points yields the absolute pose. Returns (R, t, keyframe_index,
    n_inliers) — world->camera like pnp_dlt — or None when tracking or
    PnP support is too weak.
    """
    from optical_flow_tpu.slam.epipolar import normalize_pixels
    from optical_flow_tpu.slam.pnp import pnp_ransac
    from optical_flow_tpu.track.sparse_lk import track_features

    d = thumbnail_descriptor(frame)
    dists = [float(np.linalg.norm(thumbnail_descriptor(k) - d)) for k in keyframes]
    best = int(np.argmin(dists))
    new, status, _ = track_features(keyframes[best], frame, np.asarray(kf_tracks[best]))
    ok = np.asarray(status)
    if ok.sum() < 6:
        return None
    xn = np.asarray(normalize_pixels(np.asarray(new), focal, cx, cy))
    R, t, inl = pnp_ransac(np.asarray(points), xn, valid=ok)
    n = int(np.asarray(inl).sum())
    if n < min_inliers:
        return None
    return np.asarray(R), np.asarray(t), best, n


# ------------------------------------------------------------- Sim(3) graph
#
# Monocular SLAM accumulates SCALE drift that an SE(3) pose graph cannot
# express (its edges pin metric translations). The standard fix (Strasdat's
# ScaViSLAM formulation) optimizes over similarity transforms
# S = (s, R, t): X_cam = s * R @ X_world + t, with per-edge residuals in
# the direct parameterization
#     r(i, j) = [ log_so3(Re), te, log(se) ]   of   E = Sm^-1 * Sj * Si^-1
# (7 numbers; exact Sim(3) log/exp of the translation block is not needed
# for Gauss-Newton — this residual vanishes iff the constraint holds and
# has full-rank Jacobians, which is all GN requires). Loop-closure edges
# measured at true scale then spread the accumulated log-scale error
# around the cycle like rotation/translation drift.


def sim3_compose(a, b):
    """(s, R, t) of A∘B (apply B first): X -> sa*Ra*(sb*Rb*X + tb) + ta."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta)


def sim3_inverse(a):
    s, R, t = a
    return (1.0 / s, R.T, -(R.T @ t) / s)


def _sim3_edge_residuals(ss, Rs, ts, ei, ej, sm, Rm, tm):
    si, Ri, ti = ss[ei], Rs[ei], ts[ei]
    sj, Rj, tj = ss[ej], Rs[ej], ts[ej]
    # Sj * Si^-1 = (sj/si, Rj Ri^T, tj - (sj/si) Rj Ri^T ti)
    srel = sj / si
    Rrel = jnp.einsum("eab,ecb->eac", Rj, Ri)
    trel = tj - srel[:, None] * jnp.einsum("eab,eb->ea", Rrel, ti)
    # Sm^-1 * rel = (srel/sm, Rm^T Rrel, (Rm^T (trel - tm)) / sm)
    se = srel / sm
    Re = jnp.einsum("eba,ebc->eac", Rm, Rrel)
    te = jnp.einsum("eba,eb->ea", Rm, trel - tm) / sm[:, None]
    rot = jax.vmap(_log_so3)(Re)
    return jnp.concatenate([rot, te, jnp.log(se)[:, None]], axis=-1)  # (E, 7)


@partial(jax.jit, static_argnames=("iters",))
def _optimize_sim3_graph(ss, Rs, ts, ei, ej, sm, Rm, tm, wt, iters: int):
    N = Rs.shape[0]
    damp = jnp.asarray(1e-8, Rs.dtype)

    def apply(theta, ss, Rs, ts):
        # left perturbation: S_i <- (e^sigma_i, Exp(w_i), delta_i) ∘ S_i
        d = jnp.concatenate([jnp.zeros((1, 7), Rs.dtype), theta.reshape(-1, 7)])
        dR = jax.vmap(_exp_so3)(d[:, :3])
        es = jnp.exp(d[:, 6])
        Rn = jnp.einsum("nab,nbc->nac", dR, Rs)
        tn = es[:, None] * jnp.einsum("nab,nb->na", dR, ts) + d[:, 3:6]
        return es * ss, Rn, tn

    def residuals(theta, ss, Rs, ts):
        s2, R2, t2 = apply(theta, ss, Rs, ts)
        r = _sim3_edge_residuals(s2, R2, t2, ei, ej, sm, Rm, tm)
        return (r * wt[:, None]).reshape(-1)

    def step(_, carry):
        ss, Rs, ts = carry
        z = jnp.zeros(((N - 1) * 7,), Rs.dtype)
        r = residuals(z, ss, Rs, ts)
        J = jax.jacfwd(residuals)(z, ss, Rs, ts)
        H = J.T @ J + damp * jnp.eye((N - 1) * 7, dtype=Rs.dtype)
        delta = -jnp.linalg.solve(H, J.T @ r)
        r_new = residuals(delta, ss, Rs, ts)
        ok = jnp.sum(r_new * r_new) < jnp.sum(r * r)
        delta = jnp.where(ok, delta, jnp.zeros_like(delta))
        return apply(delta, ss, Rs, ts)

    return jax.lax.fori_loop(0, iters, step, (ss, Rs, ts))


@dataclasses.dataclass
class Sim3PoseGraph:
    """Pose graph over similarity transforms (s, R, t) — node 0 is the
    gauge (fixes the global scale as well as the frame)."""

    ss: np.ndarray  # (N,)
    Rs: np.ndarray  # (N, 3, 3)
    ts: np.ndarray  # (N, 3)
    ei: List[int] = dataclasses.field(default_factory=list)
    ej: List[int] = dataclasses.field(default_factory=list)
    sm: List[float] = dataclasses.field(default_factory=list)
    Rm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tm: List[np.ndarray] = dataclasses.field(default_factory=list)
    wt: List[float] = dataclasses.field(default_factory=list)

    def add_edge(self, i, j, s_ij, R_ij, t_ij, weight: float = 1.0):
        self.ei.append(int(i))
        self.ej.append(int(j))
        self.sm.append(float(s_ij))
        self.Rm.append(np.asarray(R_ij, np.float32))
        self.tm.append(np.asarray(t_ij, np.float32))
        self.wt.append(float(weight))

    @staticmethod
    def from_se3_odometry(Rs, ts) -> "Sim3PoseGraph":
        """Start from an SE(3) trajectory (all scales 1) with chain edges
        measured from the trajectory itself."""
        Rs = np.asarray(Rs, np.float32)
        ts = np.asarray(ts, np.float32)
        g = Sim3PoseGraph(ss=np.ones(len(Rs), np.float32), Rs=Rs.copy(), ts=ts.copy())
        for i in range(len(Rs) - 1):
            R_ij, t_ij = relative_pose(Rs[i], ts[i], Rs[i + 1], ts[i + 1])
            g.add_edge(i, i + 1, 1.0, R_ij, t_ij)
        return g

    def optimize(self, iters: int = 15):
        """Returns (ss, Rs, ts) optimized, pose 0 fixed."""
        if not self.ei:
            return self.ss.copy(), self.Rs.copy(), self.ts.copy()
        ss, Rs, ts = _optimize_sim3_graph(
            jnp.asarray(self.ss),
            jnp.asarray(self.Rs),
            jnp.asarray(self.ts),
            jnp.asarray(self.ei, jnp.int32),
            jnp.asarray(self.ej, jnp.int32),
            jnp.asarray(self.sm, jnp.float32),
            jnp.asarray(np.stack(self.Rm)),
            jnp.asarray(np.stack(self.tm)),
            jnp.asarray(self.wt, jnp.float32),
            iters,
        )
        return np.asarray(ss), np.asarray(Rs), np.asarray(ts)

    def centers(self, ss=None, Rs=None, ts=None) -> np.ndarray:
        """Camera centers in the world frame: -(1/s) R^T t."""
        ss = self.ss if ss is None else ss
        Rs = self.Rs if Rs is None else Rs
        ts = self.ts if ts is None else ts
        return np.stack([-(R.T @ t) / s for s, R, t in zip(ss, Rs, ts)])


def umeyama_alignment(X, Y, w=None):
    """Least-squares similarity transform between matched 3D point sets
    (Umeyama 1991): returns (s, R, t) minimizing sum w ||(s R X + t) - Y||^2.

    This is how a REAL monocular loop edge's scale is measured: triangulate
    common structure in both keyframes' local frames and align — the
    recovered s feeds Sim3PoseGraph.add_edge. Batched jnp (one SVD);
    w: optional (K,) weights (e.g. the verification inlier mask).
    """
    X = jnp.asarray(X, jnp.float32)
    Y = jnp.asarray(Y, jnp.float32)
    K = X.shape[0]
    w = jnp.ones((K,), X.dtype) if w is None else jnp.asarray(w, X.dtype)
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mx = jnp.sum(X * w[:, None], axis=0) / wsum
    my = jnp.sum(Y * w[:, None], axis=0) / wsum
    Xc = X - mx
    Yc = Y - my
    cov = (Yc * w[:, None]).T @ Xc / wsum  # (3,3)
    U, D, Vt = jnp.linalg.svd(cov)
    S = jnp.diag(
        jnp.asarray([1.0, 1.0, jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))],
                    X.dtype)
    )
    R = U @ S @ Vt
    var_x = jnp.sum(w[:, None] * Xc * Xc) / wsum
    s = jnp.sum(D * jnp.diag(S)) / jnp.maximum(var_x, 1e-12)
    t = my - s * (R @ mx)
    return float(s), np.asarray(R), np.asarray(t)


def measure_loop_sim3(
    img_i,
    img_j,
    obs_i,
    obs_j,
    points,
    R_i,
    t_i,
    R_j,
    t_j,
    *,
    min_support: int = 12,
    max_scale: float = 4.0,
) -> Optional[Tuple[float, np.ndarray, np.ndarray, int]]:
    """Measure a loop edge as a FULL similarity S_ji = (s, R, t):
    X_j = s R X_i + t, mapping keyframe i's local-map coordinates to
    keyframe j's — the constraint a Sim(3) pose graph needs to correct
    monocular scale drift (Strasdat's ScaViSLAM loop formulation; the
    reference has no SLAM at all).

    Monocular drift means the map near i and the map near j disagree
    about the world's scale — the same physical scene exists TWICE in the
    drifted map, once as i's landmarks and once (different pids, different
    scale) as j's. The measurement exploits that duplication, ORB-SLAM
    style: sparse-LK-track i's landmark pixels (`obs_i`: [(pid, absolute
    pixel)]) into frame j, associate each tracked position with keyframe
    j's own nearest landmark observation (`obs_j`) — the two detectors
    latched onto the same physical corners at the revisit — and
    trim-Umeyama-align the two local point clouds (i's landmarks in
    camera-i coordinates vs the matched j landmarks in camera-j
    coordinates). No triangulation is involved, so the measurement is
    well-conditioned even at an exact revisit (zero i-j baseline —
    exactly where loop closures live, and exactly where a
    triangulation-based measurement would be poisoned).

    Returns (s, R, t, n_support) or None when tracking/association/
    alignment support is too weak or the scale is implausible
    (> max_scale drift)."""
    from optical_flow_tpu.track.sparse_lk import track_features

    match_radius = 3.0  # px: corner re-detection jitter at the revisit

    A = [(p, px) for p, px in obs_i if p in points]
    B = [(p, px) for p, px in obs_j if p in points]
    if len(A) < min_support or len(B) < min_support:
        return None
    R_i, t_i = np.asarray(R_i, np.float64), np.asarray(t_i, np.float64)
    R_j, t_j = np.asarray(R_j, np.float64), np.asarray(t_j, np.float64)

    # i's landmarks carried into frame j by LK
    a_px = np.asarray([px for _, px in A], np.float32)
    a_j, sa, _ = track_features(img_i, img_j, a_px)
    a_j = np.asarray(a_j, np.float32)
    sa = np.asarray(sa)
    if sa.sum() < min_support:
        return None

    # associate tracked positions with j's own landmark observations:
    # greedy nearest-neighbor, one-to-one, gated at match_radius
    b_px = np.asarray([px for _, px in B], np.float32)
    d = np.linalg.norm(a_j[:, None, :] - b_px[None, :, :], axis=-1)
    d[~sa] = np.inf
    pairs = []
    used_b = np.zeros(len(B), bool)
    for ai in np.argsort(d.min(axis=1)):
        row = np.where(used_b, np.inf, d[ai])
        bi = int(np.argmin(row))
        # gate on the MASKED distance: once every B landmark is used the
        # masked row is all-inf and argmin degenerates to 0 — gating on
        # the raw d[ai, bi] would then re-match B[0] one-to-many
        if row[bi] <= match_radius:
            used_b[bi] = True
            pairs.append((ai, bi))
    if len(pairs) < min_support:
        return None
    ia = np.asarray([a for a, _ in pairs])
    ib = np.asarray([b for _, b in pairs])

    Xa = np.stack([points[A[a][0]] for a in ia])
    Xb = np.stack([points[B[b][0]] for b in ib])
    X_i_loc = Xa @ R_i.T + t_i  # i's local map, i's scale
    X_j_loc = Xb @ R_j.T + t_j  # j's local map, j's scale
    w = (X_i_loc[:, 2] > 0.1) & (X_j_loc[:, 2] > 0.1)
    if w.sum() < min_support:
        return None
    # trimmed Umeyama: least squares is outlier-fragile, so align, drop
    # residuals beyond 2.5x the median, and re-align on the survivors
    s, R, t = umeyama_alignment(X_i_loc, X_j_loc, w.astype(np.float32))
    r = np.linalg.norm(s * (X_i_loc @ R.T) + t - X_j_loc, axis=1)
    med = np.median(r[w])
    w2 = w & (r <= 2.5 * max(med, 1e-9))
    if w2.sum() < min_support:
        return None
    s, R, t = umeyama_alignment(X_i_loc, X_j_loc, w2.astype(np.float32))
    if not (1.0 / max_scale < s < max_scale):
        return None
    return float(s), np.asarray(R), np.asarray(t), int(w2.sum())
