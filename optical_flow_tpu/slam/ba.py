"""Bundle adjustment: Gauss-Newton with Schur complement, single-device and
device-sharded (psum-reduced camera system).

Problem: cameras c = (axis-angle rotation r, translation t) in R^6, points
X in R^3, pinhole observations obs = (cam_idx, pt_idx, uv). Minimize
sum |pi(R_c X_p + t_c) - uv|^2 with pi(x, y, z) = f (x/z, y/z).

Device-side structure:
- residuals and Jacobians for ALL observations in one batch (vmap of a
  closed-form 2x6 / 2x3 Jacobian — no autodiff in the loop, everything
  fuses);
- normal equations assembled with `segment_sum` (dense per-point 3x3 and
  per-camera 6x6 blocks);
- the point blocks are eliminated per point (batched 3x3 Cholesky-free
  solve) and the REDUCED CAMERA SYSTEM S = Hcc - W Vinv W^T is the only
  thing that needs global reduction: in the sharded path each device owns a
  slice of the points (and its observations), computes its partial S and
  rhs, and one `psum` over the mesh produces the global camera system —
  back-substitution for the point updates is local. This is the
  distributed-BA pattern of SURVEY.md section 5 (Schur complement over
  psum); the collective traffic per iteration is O((6C)^2), independent of the
  number of points.

Gauss-Newton with Levenberg damping, fixed iteration count (jit-stable);
gauge freedom is fixed by damping + holding camera 0 at its prior.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax


class BAProblem(NamedTuple):
    cams: jnp.ndarray  # (C, 6): axis-angle (3) + translation (3)
    points: jnp.ndarray  # (P, 3)
    cam_idx: jnp.ndarray  # (M,) int32
    pt_idx: jnp.ndarray  # (M,) int32
    obs: jnp.ndarray  # (M, 2) pixel observations
    focal: float = 1.0
    weight: jnp.ndarray | None = None  # (M,) optional per-obs weights
    # (M,) optional rectified-rig eye offsets: observation m was made by a
    # camera displaced baseline[m] along the host camera's +x axis (0 for
    # the host/left eye). residual = pi(R X + t - [b, 0, 0]) - uv, which
    # makes a stereo right-eye measurement a first-class BA constraint —
    # depth is observable from a SINGLE keyframe, so thin temporal
    # baselines no longer leave the problem scale-indeterminate.
    baseline: jnp.ndarray | None = None


def build_track_table(pt_idx, P: int, K: int | None = None, valid=None):
    """Host-side (numpy) observation table: (P, K) int32 of observation
    indices per point, padded with -1. K defaults to the longest track.

    This is the sparsity structure of the W (camera-point) off-diagonal
    block: point p couples only the <= K cameras observing it, so the
    Schur complement assembles in O(P K^2) instead of densifying a
    (P, C, 6, 3) block over ALL cameras (VERDICT r1 item 8).

    valid: optional (M,) bool — observations excluded from the table
    (zero-weight padding rows; their W blocks are exactly zero, so
    skipping them is exact and keeps K tight)."""
    import numpy as np

    pt = np.asarray(pt_idx)
    live = np.ones(len(pt), bool) if valid is None else np.asarray(valid, bool)
    counts = np.bincount(pt[live], minlength=P)
    k_needed = int(counts.max()) if live.any() else 1
    if K is None:
        K = max(k_needed, 1)
    elif k_needed > K:
        raise ValueError(f"track length {k_needed} exceeds table width {K}")
    table = np.full((P, K), -1, np.int32)
    slot = np.zeros(P, np.int64)
    order = np.argsort(pt, kind="stable")
    for m in order:
        if not live[m]:
            continue
        p = pt[m]
        table[p, slot[p]] = m
        slot[p] += 1
    return table


def _rodrigues(r):
    """Axis-angle (3,) -> rotation matrix (3,3), smooth at 0."""
    th2 = jnp.sum(r * r)
    th = jnp.sqrt(th2 + 1e-24)
    k = r / th
    K = jnp.array(
        [[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]], r.dtype
    )
    s, c = jnp.sin(th), jnp.cos(th)
    R_big = jnp.eye(3, dtype=r.dtype) + s * K + (1 - c) * (K @ K)
    # small-angle fallback: I + [r]x
    Rx = jnp.array(
        [[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]], r.dtype
    )
    R_small = jnp.eye(3, dtype=r.dtype) + Rx
    return jnp.where(th2 > 1e-12, R_big, R_small)


def project(cam, X, focal, baseline=0.0):
    """Pinhole projection of one point by one camera; `baseline` shifts
    the eye along the camera's +x axis (a rectified rig's right eye)."""
    R = _rodrigues(cam[:3])
    xc = R @ X + cam[3:]
    z = jnp.where(jnp.abs(xc[2]) > 1e-9, xc[2], 1e-9)
    return focal * jnp.stack([xc[0] - baseline, xc[1]]) / z


def _residual_jac(cam, X, uv, focal, baseline):
    """(r (2,), J_cam (2,6), J_pt (2,3)) in closed form via jacfwd (traced
    once; everything fuses into the batch)."""
    def res(cX):
        c, x = cX
        return project(c, x, focal, baseline) - uv

    r = res((cam, X))
    Jc, Jp = jax.jacfwd(res)((cam, X))
    return r, Jc, Jp


def _baselines(problem: BAProblem):
    if problem.baseline is not None:
        return problem.baseline
    return jnp.zeros(problem.obs.shape[:1], problem.obs.dtype)


def _assemble(problem: BAProblem, C: int, P: int, table, residual_jac=None):
    """Per-observation residuals/Jacobians and block accumulations.

    table: (P, K) int32 observation indices per point, -1-padded
    (build_track_table) — the W block's sparsity structure. Padded slots
    carry zero W blocks and camera index 0, so they contribute exact
    zeros everywhere downstream.

    residual_jac: override for the per-observation (r, J_cam, J_pt)
    function — vi_ba passes its 9-DOF variant (problem.cams then holds
    (C, 9) states); everything downstream is width-generic."""
    if residual_jac is None:
        residual_jac = _residual_jac
    f = jnp.asarray(problem.focal, problem.points.dtype)
    r, Jc, Jp = jax.vmap(residual_jac, in_axes=(0, 0, 0, None, 0))(
        problem.cams[problem.cam_idx], problem.points[problem.pt_idx],
        problem.obs, f, _baselines(problem),
    )
    if problem.weight is not None:
        w = problem.weight[:, None]
        r = r * w
        Jc = Jc * w[..., None]
        Jp = Jp * w[..., None]
    # Blocks
    Hcc = jax.ops.segment_sum(
        jnp.einsum("mki,mkj->mij", Jc, Jc), problem.cam_idx, C
    )  # (C,6,6)
    Hpp = jax.ops.segment_sum(
        jnp.einsum("mki,mkj->mij", Jp, Jp), problem.pt_idx, P
    )  # (P,3,3)
    bc = jax.ops.segment_sum(jnp.einsum("mki,mk->mi", Jc, r), problem.cam_idx, C)
    bp = jax.ops.segment_sum(jnp.einsum("mki,mk->mi", Jp, r), problem.pt_idx, P)
    # W blocks gathered per (point, track slot): (P, K, 6, 3). Memory is
    # O(observations), never O(P*C) — each point couples only the cameras
    # that see it.
    Wm = jnp.einsum("mki,mkj->mij", Jc, Jp)  # (M,6,3)
    mask = table >= 0
    tt = jnp.where(mask, table, 0)
    Wp = Wm[tt] * mask[..., None, None]
    camT = jnp.where(mask, problem.cam_idx[tt], 0)
    return Hcc, Hpp, bc, bp, Wp, camT, r


def _schur_reduce(Hpp, bp, Wp, camT, lam, C: int):
    """Partial reduced camera system from a (possibly sharded) point set.

    S_partial = - sum_p W_p Vinv_p W_p^T, assembled per track-slot pair
    (k, q) and scatter-added into camera blocks: O(P K^2) work, O(P K)
    memory per slot — the sparse Schur assembly.

    Camera-block width D comes from Wp (..., D, 3): 6 for pure-visual BA,
    9 for visual-inertial states (slam/vi_ba.py) — the math is identical."""
    P, K = camT.shape
    D = Wp.shape[-2]
    eye3 = jnp.eye(3, dtype=Hpp.dtype)
    Vinv = jnp.linalg.inv(Hpp + lam * eye3[None])  # (P,3,3)
    WV = jnp.einsum("pkij,pjl->pkil", Wp, Vinv)  # (P,K,D,3)
    S = jnp.zeros((C * C, D, D), Hpp.dtype)
    for k in range(K):  # static unroll; K = longest track
        contrib = -jnp.einsum("pil,pqjl->pqij", WV[:, k], Wp)  # (P,K,D,D)
        seg = camT[:, k][:, None] * C + camT  # (P,K) -> flat cam-pair ids
        S = S + jax.ops.segment_sum(
            contrib.reshape(P * K, D, D), seg.reshape(P * K), C * C
        )
    S = S.reshape(C, C, D, D).transpose(0, 2, 1, 3)  # (C,D,C,D)
    rhs = jax.ops.segment_sum(
        jnp.einsum("pkil,pl->pki", WV, bp).reshape(P * K, D),
        camT.reshape(P * K),
        C,
    )  # (C,D): + W Vinv bp
    return S, rhs, Vinv


def _solve_cameras(Hcc, bc, S_partial, rhs_partial, lam, fixed=None,
                   fixed_dofs=None, precondition=False):
    """Dense solve of the reduced camera system
    S = blockdiag(Hcc + lam I) - W Vinv W^T (the latter is S_partial).

    fixed: optional (C,) bool — cameras whose delta is constrained to 0
    (windowed BA holds out-of-window cameras). Defaults to camera 0 only
    (gauge anchor). fixed_dofs: optional (C*D,) bool overriding the
    per-camera mask with per-DOF pins (vi_ba pins keyframe 0's pose but
    leaves its velocity live).

    precondition: symmetric Jacobi scaling D^-1/2 S D^-1/2 before the
    solve — required for f32 visual-inertial systems, whose rows mix
    pixel-, rad- and m/s-unit residuals with 1e6-spread information
    weights (an unpreconditioned f32 solve walks the metric scale far
    from 1; preconditioned matches the f64 result)."""
    C, D = Hcc.shape[0], Hcc.shape[-1]
    block = Hcc + lam * jnp.eye(D, dtype=Hcc.dtype)[None]

    def add_block(c, M):
        cur = lax.dynamic_slice(M, (c * D, c * D), (D, D))
        return lax.dynamic_update_slice(M, cur + block[c], (c * D, c * D))

    S = lax.fori_loop(0, C, add_block, S_partial.reshape(C * D, C * D))
    rhs = (-bc + rhs_partial).reshape(C * D)
    # Gauge fix INSIDE the system: constrain pinned cameras' deltas to 0
    # (replace their rows/cols with identity) so the point
    # back-substitution sees the pinned solution — zeroing delta after the
    # solve would let each iteration's point updates track a camera motion
    # that is then discarded, and leaves the gauge direction to lam alone.
    if fixed_dofs is not None:
        free = ~fixed_dofs
    else:
        if fixed is None:
            fixed = jnp.arange(C) == 0
        free = jnp.repeat(~fixed, D)  # (DC,) True where the solve is live
    keep = free[:, None] & free[None, :]
    S = jnp.where(keep, S, 0.0)
    S = S + jnp.diag(jnp.where(free, 0.0, 1.0).astype(S.dtype))
    rhs = jnp.where(free, rhs, 0.0)
    if precondition:
        d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(S)), 1e-12))
        S = S / (d[:, None] * d[None, :])
        return (jnp.linalg.solve(S, rhs / d) / d).reshape(C, D)
    return jnp.linalg.solve(S, rhs).reshape(C, D)


def _back_substitute(Vinv, Wp, camT, bp, delta_c):
    """Point updates given camera updates (local to each point shard)."""
    corr = jnp.einsum("pkij,pki->pj", Wp, delta_c[camT])  # (P,3)
    return jnp.einsum("pij,pj->pi", Vinv, -(bp + corr))


def _gn_step(problem: BAProblem, lam, C: int, P: int, table, psum_axes=None, fixed=None):
    Hcc, Hpp, bc, bp, Wp, camT, r = _assemble(problem, C, P, table)
    S_partial, rhs_partial, Vinv = _schur_reduce(Hpp, bp, Wp, camT, lam, C)
    if psum_axes is not None:
        # Points (and their observations) are sharded; the camera system is
        # the one global object. A single psum assembles it over the mesh.
        S_partial = lax.psum(S_partial, psum_axes)
        rhs_partial = lax.psum(rhs_partial, psum_axes)
        Hcc = lax.psum(Hcc, psum_axes)
        bc = lax.psum(bc, psum_axes)
    delta_c = _solve_cameras(Hcc, bc, S_partial, rhs_partial, lam, fixed=fixed)
    delta_p = _back_substitute(Vinv, Wp, camT, bp, delta_c)
    cams = problem.cams + delta_c
    points = problem.points + delta_p
    return problem._replace(cams=cams, points=points), jnp.mean(r * r)


def _huber_sqrt_weights(problem: BAProblem, delta):
    """IRLS sqrt-weights for the Huber loss at scale `delta` px: 1 inside
    the quadratic zone, sqrt(delta/r) beyond — _assemble multiplies both
    the residual and the Jacobians by the weight, so the effective
    least-squares weight is its square."""
    f = jnp.asarray(problem.focal, problem.points.dtype)
    pred = jax.vmap(project, in_axes=(0, 0, None, 0))(
        problem.cams[problem.cam_idx], problem.points[problem.pt_idx], f,
        _baselines(problem),
    )
    rn = jnp.sqrt(jnp.sum((pred - problem.obs) ** 2, axis=-1))
    return jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(rn, 1e-12)))


@partial(jax.jit, static_argnames=("iters", "robust"))
def _bundle_adjust_jit(
    problem: BAProblem, table, fixed, iters: int, lam, robust: bool = False,
    delta=None,
):
    C = problem.cams.shape[0]
    P = problem.points.shape[0]
    base_w = problem.weight

    def body(carry, _):
        prob, l = carry
        if robust:
            # IRLS: reweight at the CURRENT estimate each iteration, from
            # the caller's base weights (padding zeros stay zero)
            prob = prob._replace(
                weight=base_w * _huber_sqrt_weights(prob, delta)
            )
        prob, msr = _gn_step(prob, l, C, P, table, fixed=fixed)
        return (prob._replace(weight=base_w), l), msr

    # full-f32 matmul passes: the GPU default runs f32 einsums/solves
    # in TF32 (10-bit mantissa) — harmless for image ops, but the normal
    # equations SQUARE the conditioning and the Schur complement
    # cancels, so reduced-precision products walk VI-BA's metric scale
    # away from the f64 answer. No-op on CPU (always full precision).
    with jax.default_matmul_precision("float32"):
        (out, _), hist = lax.scan(body, (problem, lam), None, length=iters)
    return out, hist


def bundle_adjust(
    problem: BAProblem,
    iters: int = 10,
    lam: float = 1e-3,
    fixed_cams=None,
    robust_delta=None,
) -> Tuple[BAProblem, jnp.ndarray]:
    """Gauss-Newton BA; returns (refined problem, per-iter mean sq residual).

    The observation table (W-block sparsity) is built host-side from
    pt_idx, so this entry point needs concrete (non-traced) indices — call
    it from the host loop, not from inside jit.

    fixed_cams: optional (C,) bool mask of cameras held constant (windowed
    BA); camera 0 is always pinned as the gauge anchor.

    robust_delta: optional Huber scale in PIXELS — observations whose
    reprojection error exceeds it are IRLS-downweighted by delta/r each
    iteration, so gross mismatches (a wrong track association) cannot
    drag the whole solution the way squared loss lets them."""
    import numpy as np

    P = problem.points.shape[0]
    C = problem.cams.shape[0]
    valid = None if problem.weight is None else np.asarray(problem.weight) > 0
    table = jnp.asarray(build_track_table(problem.pt_idx, P, valid=valid))
    fixed = jnp.zeros((C,), bool).at[0].set(True)
    if fixed_cams is not None:
        fixed = fixed | jnp.asarray(fixed_cams, bool)
    lam = jnp.asarray(lam, problem.points.dtype)
    robust = robust_delta is not None
    if robust and problem.weight is None:
        # materialize base weights so the scan carry has a fixed pytree
        problem = problem._replace(
            weight=jnp.ones((problem.obs.shape[0],), problem.obs.dtype)
        )
    delta = (
        jnp.asarray(robust_delta, problem.points.dtype) if robust else None
    )
    return _bundle_adjust_jit(
        problem, table, fixed, iters, lam, robust=robust, delta=delta
    )


def reprojection_rmse(problem: BAProblem) -> jnp.ndarray:
    """RMS pixel reprojection error; zero-weight (padding) observations
    are excluded from the mean."""
    f = jnp.asarray(problem.focal, problem.points.dtype)
    pred = jax.vmap(project, in_axes=(0, 0, None, 0))(
        problem.cams[problem.cam_idx], problem.points[problem.pt_idx], f,
        _baselines(problem),
    )
    sq = jnp.sum((pred - problem.obs) ** 2, axis=-1)
    if problem.weight is None:
        return jnp.sqrt(jnp.mean(sq))
    live = (problem.weight > 0).astype(sq.dtype)
    return jnp.sqrt(jnp.sum(sq * live) / jnp.maximum(jnp.sum(live), 1))


def sharded_bundle_adjust(
    problem: BAProblem,
    mesh,
    iters: int = 10,
    lam: float = 1e-3,
    robust_delta=None,
) -> Tuple[BAProblem, jnp.ndarray]:
    """BA with points + observations sharded over every mesh axis (flattened
    into one logical device ring); cameras replicated.

    Requires: P and M divisible by mesh.size, and observations pre-grouped
    so device d's observation slice references only its point slice
    (pt_idx is LOCAL to the shard). Camera updates are identical on every
    device (psum-reduced system); point updates stay local. Results match
    the unsharded solver up to f32 reduction order.
    """
    from jax.sharding import PartitionSpec as P_

    axes = tuple(mesh.axis_names)
    n = mesh.size
    P_pts = problem.points.shape[0]
    M = problem.obs.shape[0]
    if P_pts % n or M % n:
        raise ValueError(f"points {P_pts} and obs {M} must divide mesh size {n}")
    C = problem.cams.shape[0]
    lamv = jnp.asarray(lam, problem.points.dtype)
    P_local = P_pts // n
    M_local = M // n

    # Per-shard observation tables (host-side): shard d's observations are
    # rows [d*M_local, (d+1)*M_local) and reference its local points, so
    # its table indexes into the LOCAL observation slice. One global K
    # keeps the stacked table rectangular (jit-static).
    import numpy as np

    pt_np = np.asarray(problem.pt_idx)
    K = max(
        int(np.bincount(pt_np[d * M_local : (d + 1) * M_local], minlength=1).max())
        for d in range(n)
    )
    tables = np.stack(
        [
            build_track_table(pt_np[d * M_local : (d + 1) * M_local], P_local, K)
            for d in range(n)
        ]
    ).reshape(n * P_local, K)

    robust = robust_delta is not None
    delta = (
        jnp.asarray(robust_delta, problem.points.dtype) if robust else None
    )

    def local_ba(cams, points, cam_idx, pt_idx, obs, weight, bline, table):
        prob = BAProblem(
            cams, points, cam_idx, pt_idx, obs, problem.focal, weight, bline
        )

        def body(carry, _):
            pr, l = carry
            if robust:
                # Huber IRLS per shard-local observation (slam/ba.py
                # bundle_adjust) — purely local, no extra collectives
                pr = pr._replace(
                    weight=weight * _huber_sqrt_weights(pr, delta)
                )
            pr, msr = _gn_step(pr, l, C, P_local, table, psum_axes=axes)
            return (pr._replace(weight=weight), l), lax.psum(msr, axes) / n

        # full-f32 matmul passes, no TF32 (see _bundle_adjust_jit)
        with jax.default_matmul_precision("float32"):
            (out, _), hist = lax.scan(body, (prob, lamv), None, length=iters)
        return out.cams, out.points, hist

    spec_pt = P_(axes)  # shard leading dim over the flattened mesh
    spec_rep = P_()
    fn = jax.shard_map(
        local_ba,
        mesh=mesh,
        in_specs=(
            spec_rep, spec_pt, spec_pt, spec_pt, spec_pt, spec_pt, spec_pt,
            spec_pt,
        ),
        out_specs=(spec_rep, spec_pt, spec_rep),
    )
    weight = (
        problem.weight
        if problem.weight is not None
        else jnp.ones((M,), problem.obs.dtype)
    )
    cams, points, hist = fn(
        problem.cams,
        problem.points,
        problem.cam_idx,
        problem.pt_idx,
        problem.obs,
        weight,
        _baselines(problem),
        jnp.asarray(tables),
    )
    return problem._replace(cams=cams, points=points), hist
