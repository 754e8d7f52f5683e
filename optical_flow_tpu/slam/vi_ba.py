"""Tightly-coupled visual-inertial bundle adjustment.

The reference is pure vision (SURVEY.md §2); `slam/imu.py` added the
loosely-coupled layer (preintegration + the linear VI initialization).
This module closes the remaining gap to a production VI stack: the
preintegrated IMU deltas become FACTORS inside bundle adjustment, jointly
refined with the reprojection residuals, instead of a one-shot alignment
applied after vision has already converged.

State per keyframe is 9-DOF — axis-angle rotation r and translation t of
the world->cam pose (as in `ba.BAProblem`) plus the world-frame velocity
v — or 15-DOF with per-keyframe bias deltas (dbg, dba) relative to the
preintegration linearization point (bias-state mode, VERDICT r4 #4:
first-order Forster bias corrections on the deltas + between-keyframe
bias random-walk factors, so biases DRIFT on long logs instead of
staying frozen at the one-shot upstream estimate). Gravity is a known
constant of the problem (from `visual_inertial_alignment*`). In 9-DOF
mode biases are corrected upstream (`estimate_gyro_bias` / the
accel-bias columns) and the factors consume already-corrected deltas.
Between consecutive keyframes i -> i+1 the standard preintegration
constraints contribute 9 residuals:

    r_R = Log(dR_i^T  R_i R_{i+1}^T)                       (body frame)
    r_v = R_i (v_{i+1} - v_i - g T_i)            - dv_i
    r_p = R_i (c_{i+1} - c_i - v_i T_i - g T_i^2/2) - dp_i

with R_i the world->cam rotation, c_i = -R_i^T t_i the camera center and
body == camera frame (the `slam/imu.py` convention). Each residual block
is scaled by an information weight (1/sigma); reprojection residuals are
in pixels, so the defaults assume sigma_R ~ 1e-3 rad, sigma_v ~ 1e-2 m/s,
sigma_p ~ 1e-3 m for a ~1 px pixel sigma — pass `imu_weight` to match a
real sensor's noise model.

Device-side structure (same skeleton as `slam/ba.py`): all reprojection
residuals/Jacobians in one vmap batch, the point blocks eliminated by the
sparse Schur complement, and the IMU factors — which never touch points —
assembled directly into the REDUCED camera system as (i, i), (i, i+1),
(i+1, i), (i+1, i+1) blocks of the dense (C*9)^2 solve. The whole
Gauss-Newton loop is one `lax.scan` under jit. The IMU terms make metric
scale OBSERVABLE: a uniformly rescaled monocular solution has identical
reprojection residuals (the gauge direction vision cannot see) but
violates the metric dv/dp deltas, so VI-BA pulls the map back to metric
scale — pinned by tests/test_vi_ba.py.

Gauge: keyframe 0's POSE is pinned (6 DOF); its velocity stays live (the
IMU observes it). With gravity known the residual yaw-about-g gauge is
absorbed by the pose pin, exactly as in standard VI odometry.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .ba import (
    BAProblem,
    _assemble,
    _back_substitute,
    _huber_sqrt_weights,
    _rodrigues,
    _schur_reduce,
    _solve_cameras,
    build_track_table,
)
from .imu import _exp_so3, _log_so3


class VIBAProblem(NamedTuple):
    """Visual-inertial BA problem over C keyframes and P points.

    The visual part mirrors `ba.BAProblem` with D-wide states (D = 9,
    or 15 in bias-state mode); the inertial part carries one
    preintegrated interval per consecutive keyframe pair
    (`slam.imu.preintegrate` on each interval's samples,
    bias-corrected)."""

    # (C, 9): axis-angle r, translation t, velocity v — or (C, 15) with
    # per-keyframe bias deltas (dbg, dba) appended (bias-state mode;
    # requires bias_jac)
    states: jnp.ndarray
    points: jnp.ndarray  # (P, 3)
    cam_idx: jnp.ndarray  # (M,) int32
    pt_idx: jnp.ndarray  # (M,) int32
    obs: jnp.ndarray  # (M, 2) pixel observations
    dR: jnp.ndarray  # (C-1, 3, 3) preintegrated rotations
    dv: jnp.ndarray  # (C-1, 3)
    dp: jnp.ndarray  # (C-1, 3)
    interval_T: jnp.ndarray  # (C-1,) interval durations [s]
    gravity: jnp.ndarray  # (3,) world gravity (acceleration, e.g. (0,-9.81,0))
    focal: float = 1.0
    weight: jnp.ndarray | None = None  # (M,) optional per-obs weights
    baseline: jnp.ndarray | None = None  # (M,) optional rig eye offsets
    # information weights (1/sigma) for the (rotation, velocity, position)
    # residual blocks, in (rad, m/s, m)^-1 against pixel-unit reprojection
    imu_weight: jnp.ndarray = None  # (3,)
    # 15-DOF bias-state mode (VERDICT r4 #4): when states are (C, 15) —
    # (r, t, v, dbg, dba), the bias DELTAS relative to the linearization
    # point the deltas were preintegrated at — bias_jac carries the
    # first-order preintegration bias Jacobians per interval,
    # (C-1, 5, 3, 3) ordered [J_dR_bg, J_dv_bg, J_dv_ba, J_dp_bg, J_dp_ba]
    # (`slam.imu.preintegrate_with_bias_jacobians`), and each factor gains
    # 6 bias random-walk residuals w_rw (b_{i+1} - b_i) / sqrt(T_i).
    bias_jac: jnp.ndarray | None = None
    bias_rw_weight: jnp.ndarray | None = None  # (2,): (gyro, accel) 1/sigma_rw


DEFAULT_IMU_WEIGHT = (1e3, 1e2, 1e3)
# Bias random-walk information (1/sigma per sqrt-second): defaults sized
# for a consumer-grade MEMS IMU (gyro sigma_rw ~ 1e-3 rad/s/sqrt(s),
# accel ~ 1e-2 m/s^2/sqrt(s)) — pass your sensor's continuous-time bias
# instability for a calibrated solve.
DEFAULT_BIAS_RW_WEIGHT = (1e3, 1e2)


def _imu_residual(si, sj, dR, dv, dp, T, g, w3):
    """The 9 preintegration residuals between consecutive states (see
    module docstring), each block scaled by its information weight."""
    Ri = _rodrigues(si[:3])
    Rj = _rodrigues(sj[:3])
    ci = -Ri.T @ si[3:6]
    cj = -Rj.T @ sj[3:6]
    vi, vj = si[6:9], sj[6:9]
    r_rot = _log_so3(dR.T @ (Ri @ Rj.T))
    r_vel = Ri @ (vj - vi - g * T) - dv
    r_pos = Ri @ (cj - ci - vi * T - 0.5 * g * T * T) - dp
    return jnp.concatenate([w3[0] * r_rot, w3[1] * r_vel, w3[2] * r_pos])


def _imu_residual_jac(si, sj, dR, dv, dp, T, g, w3):
    r = _imu_residual(si, sj, dR, dv, dp, T, g, w3)
    Ji, Jj = jax.jacfwd(_imu_residual, argnums=(0, 1))(
        si, sj, dR, dv, dp, T, g, w3
    )
    return r, Ji, Jj


def _imu_residual15(si, sj, dR, dv, dp, T, g, w3, Jb, wrw):
    """Bias-state variant (15-DOF states): the 9 preintegration residuals
    evaluated at first-order bias-corrected deltas
        dR(dbg_i) = dR Exp(J_dR_bg dbg_i)
        dv(db_i)  = dv + J_dv_bg dbg_i + J_dv_ba dba_i   (dp likewise)
    plus 6 bias random-walk residuals wrw (b_{i+1} - b_i) / sqrt(T_i) —
    the between-keyframe factor that lets biases DRIFT at the rate the
    sensor's bias instability allows instead of freezing them for the
    whole log. Jb: (5, 3, 3) [J_dR_bg, J_dv_bg, J_dv_ba, J_dp_bg,
    J_dp_ba] from `slam.imu.preintegrate_with_bias_jacobians`."""
    dbg_i, dba_i = si[9:12], si[12:15]
    dR_c = dR @ _exp_so3(Jb[0] @ dbg_i)
    dv_c = dv + Jb[1] @ dbg_i + Jb[2] @ dba_i
    dp_c = dp + Jb[3] @ dbg_i + Jb[4] @ dba_i
    # the 9 preintegration residuals at the corrected deltas: ONE source
    # of the residual convention (_imu_residual slices si[:9] itself)
    r9 = _imu_residual(si, sj, dR_c, dv_c, dp_c, T, g, w3)
    inv_sqT = lax.rsqrt(jnp.maximum(T, 1e-6))
    r_bg = (sj[9:12] - si[9:12]) * (wrw[0] * inv_sqT)
    r_ba = (sj[12:15] - si[12:15]) * (wrw[1] * inv_sqT)
    return jnp.concatenate([r9, r_bg, r_ba])


def _imu_residual_jac15(si, sj, dR, dv, dp, T, g, w3, Jb, wrw):
    r = _imu_residual15(si, sj, dR, dv, dp, T, g, w3, Jb, wrw)
    Ji, Jj = jax.jacfwd(_imu_residual15, argnums=(0, 1))(
        si, sj, dR, dv, dp, T, g, w3, Jb, wrw
    )
    return r, Ji, Jj


def _imu_system(problem: VIBAProblem, C: int):
    """Gauss-Newton contribution of the IMU factors to the camera system.

    Returns (H (C,D,C,D), b (C,D), mean_sq_residual), D the state width
    (9, or 15 in bias-state mode). H carries the off-block-diagonal
    (i, i+1) coupling the block-diagonal `Hcc` path of `_solve_cameras`
    cannot hold, so the caller folds it into S_partial (which is added
    to the dense system in full)."""
    s = problem.states
    w3 = (
        problem.imu_weight
        if problem.imu_weight is not None
        else jnp.asarray(DEFAULT_IMU_WEIGHT, s.dtype)
    )
    if s.shape[1] == 15:
        if problem.bias_jac is None:
            raise ValueError("15-DOF states need bias_jac "
                             "(preintegrate_with_bias_jacobians)")
        wrw = (
            problem.bias_rw_weight
            if problem.bias_rw_weight is not None
            else jnp.asarray(DEFAULT_BIAS_RW_WEIGHT, s.dtype)
        )
        r, Ji, Jj = jax.vmap(
            _imu_residual_jac15,
            in_axes=(0, 0, 0, 0, 0, 0, None, None, 0, None),
        )(
            s[:-1], s[1:], problem.dR, problem.dv, problem.dp,
            problem.interval_T, problem.gravity, w3, problem.bias_jac, wrw,
        )
    else:
        r, Ji, Jj = jax.vmap(
            _imu_residual_jac, in_axes=(0, 0, 0, 0, 0, 0, None, None)
        )(
            s[:-1], s[1:], problem.dR, problem.dv, problem.dp,
            problem.interval_T, problem.gravity, w3,
        )
    n = C - 1
    i_idx = jnp.arange(n, dtype=jnp.int32)
    j_idx = i_idx + 1
    # the four (row, col) block families of each binary factor
    Hm = jnp.concatenate(
        [
            jnp.einsum("mki,mkj->mij", Ji, Ji),
            jnp.einsum("mki,mkj->mij", Ji, Jj),
            jnp.einsum("mki,mkj->mij", Jj, Ji),
            jnp.einsum("mki,mkj->mij", Jj, Jj),
        ]
    )
    seg = jnp.concatenate(
        [
            i_idx * C + i_idx,
            i_idx * C + j_idx,
            j_idx * C + i_idx,
            j_idx * C + j_idx,
        ]
    )
    D = s.shape[1]
    H = jax.ops.segment_sum(Hm, seg, C * C)
    H = H.reshape(C, C, D, D).transpose(0, 2, 1, 3)  # (C,D,C,D)
    bm = jnp.concatenate(
        [jnp.einsum("mki,mk->mi", Ji, r), jnp.einsum("mki,mk->mi", Jj, r)]
    )
    b = jax.ops.segment_sum(bm, jnp.concatenate([i_idx, j_idx]), C)
    return H, b, jnp.mean(r * r)


def _assemble_vis(problem: VIBAProblem, C: int, P: int, table):
    """Visual blocks at WIDTH 6 — only the pose columns (vision never
    sees velocities or biases, so their Jacobian columns are exact
    zeros): `ba._assemble` runs on states[:, :6] with the standard
    residual function, and the caller embeds the 6-wide blocks into the
    D-wide camera system. Versus riding the full (C, D) states through
    the assembly this removes all per-observation work on known-zero
    columns (~2.8x per-observation FLOPs at D=15; the embedded zeros are
    arithmetically identical — 0-contributions everywhere downstream)."""
    shim = BAProblem(
        cams=problem.states[:, :6], points=problem.points,
        cam_idx=problem.cam_idx, pt_idx=problem.pt_idx, obs=problem.obs,
        focal=problem.focal, weight=problem.weight,
        baseline=problem.baseline,
    )
    return _assemble(shim, C, P, table)


def _embed6(M, D: int, axes):
    """Zero-embed width-6 pose blocks into width-D state blocks along the
    given axes (the last-axis positions 0..5 of each D-wide slot)."""
    pad = [(0, 0)] * M.ndim
    for ax in axes:
        pad[ax] = (0, D - 6)
    return jnp.pad(M, pad)


def _gn_step_vi(problem: VIBAProblem, lam, C: int, P: int, table, fixed_dofs,
                psum_axes=None):
    D = problem.states.shape[1]
    Hcc6, Hpp, bc6, bp, Wp6, camT, r = _assemble_vis(problem, C, P, table)
    S6, rhs6, Vinv = _schur_reduce(Hpp, bp, Wp6, camT, lam, C)
    if psum_axes is not None:
        # Points/observations are sharded; the camera system is the one
        # global object (slam/ba.py `_gn_step`). The IMU factors are added
        # AFTER the psum: their inputs (states, deltas) are replicated, so
        # every device computes the identical H_imu once — psumming it
        # would multiply the factor by the mesh size. (Reduced at width 6
        # — no collective bytes spent on the structurally-zero columns.)
        S6 = lax.psum(S6, psum_axes)
        rhs6 = lax.psum(rhs6, psum_axes)
        Hcc6 = lax.psum(Hcc6, psum_axes)
        bc6 = lax.psum(bc6, psum_axes)
    # embed the pose-only visual system into the D-wide state system
    Hcc = _embed6(Hcc6, D, (1, 2))  # (C,6,6) -> (C,D,D)
    bc = _embed6(bc6, D, (1,))
    S_partial = _embed6(S6, D, (1, 3))  # (C,6,C,6) -> (C,D,C,D)
    rhs_partial = _embed6(rhs6, D, (1,))
    H_imu, b_imu, msr_imu = _imu_system(problem, C)
    delta_c = _solve_cameras(
        Hcc, bc + b_imu, S_partial + H_imu, rhs_partial, lam,
        fixed_dofs=fixed_dofs, precondition=True,
    )
    delta_p = _back_substitute(Vinv, Wp6, camT, bp, delta_c[:, :6])
    out = problem._replace(
        states=problem.states + delta_c, points=problem.points + delta_p
    )
    return out, jnp.mean(r * r), msr_imu


def _huber_weights_vi(prob: VIBAProblem, base_w, delta):
    """Visual-residual IRLS sqrt-weights for a VI problem (the IMU factors
    are never downweighted — they are not pixel associations that can be
    wrong, and robustifying them would re-open the scale gauge)."""
    shim = BAProblem(
        cams=prob.states[:, :6], points=prob.points, cam_idx=prob.cam_idx,
        pt_idx=prob.pt_idx, obs=prob.obs, focal=prob.focal, weight=base_w,
        baseline=prob.baseline,
    )
    return base_w * _huber_sqrt_weights(shim, delta)


@partial(jax.jit, static_argnames=("iters", "robust"))
def _vi_bundle_adjust_jit(problem: VIBAProblem, table, fixed_dofs, iters, lam,
                          robust: bool = False, delta=None):
    C = problem.states.shape[0]
    P = problem.points.shape[0]
    base_w = problem.weight

    def body(carry, _):
        prob, l = carry
        if robust:
            prob = prob._replace(weight=_huber_weights_vi(prob, base_w, delta))
        prob, msr_vis, msr_imu = _gn_step_vi(prob, l, C, P, table, fixed_dofs)
        return (prob._replace(weight=base_w), l), jnp.stack([msr_vis, msr_imu])

    # full-f32 matmul passes: the GPU default's TF32 multiplies corrupt
    # the Schur cancellation + mixed-unit solve (see ba._bundle_adjust_jit)
    with jax.default_matmul_precision("float32"):
        (out, _), hist = lax.scan(body, (problem, lam), None, length=iters)
    return out, hist


def vi_bundle_adjust(
    problem: VIBAProblem,
    iters: int = 12,
    lam: float = 1e-3,
    fixed_states=None,
    robust_delta=None,
) -> Tuple[VIBAProblem, jnp.ndarray]:
    """Joint Gauss-Newton over 9-DOF states + points with IMU factors.

    Returns (refined problem, (iters, 2) history of mean-square visual /
    IMU residuals). Needs concrete pt_idx (the observation table is built
    host-side) — call from the host loop, not inside jit.

    fixed_states: optional (C,) bool of keyframes whose POSE is held
    (windowed use); keyframe 0's pose is always pinned as the gauge
    anchor. Velocities are never pinned — the IMU observes them.

    robust_delta: optional Huber scale in PIXELS — visual observations
    whose reprojection error exceeds it are IRLS-downweighted each
    iteration (`ba.bundle_adjust` semantics); the IMU factors are never
    downweighted."""
    import numpy as np

    C = problem.states.shape[0]
    P = problem.points.shape[0]
    if C < 2:
        raise ValueError("VI-BA needs >= 2 keyframes (one IMU interval)")
    valid = None if problem.weight is None else np.asarray(problem.weight) > 0
    table = jnp.asarray(build_track_table(problem.pt_idx, P, valid=valid))
    pinned = np.zeros(C, bool)
    pinned[0] = True
    if fixed_states is not None:
        pinned |= np.asarray(fixed_states, bool)
    D = problem.states.shape[1]
    dofs = np.zeros((C, D), bool)
    dofs[pinned, :6] = True  # pose pinned; velocity (and biases) live
    lam = jnp.asarray(lam, problem.points.dtype)
    robust = robust_delta is not None
    if robust and problem.weight is None:
        problem = problem._replace(
            weight=jnp.ones((problem.obs.shape[0],), problem.obs.dtype)
        )
    delta = (
        jnp.asarray(robust_delta, problem.points.dtype) if robust else None
    )
    return _vi_bundle_adjust_jit(
        problem, table, jnp.asarray(dofs.reshape(-1)), iters, lam,
        robust=robust, delta=delta,
    )


def sharded_vi_bundle_adjust(
    problem: VIBAProblem,
    mesh,
    iters: int = 12,
    lam: float = 1e-3,
) -> Tuple[VIBAProblem, jnp.ndarray]:
    """VI-BA with points + observations sharded over every mesh axis;
    states, IMU deltas and gravity replicated (same contract as
    `ba.sharded_bundle_adjust`: P and M divisible by mesh.size, pt_idx
    LOCAL to each shard's point slice). The visual camera system is
    psum-reduced; the IMU factors — O(C) data, replicated — are assembled
    identically on every device after the reduction, so state updates are
    identical everywhere and point updates stay local. Collective traffic
    per iteration is O((9C)^2), independent of the number of points."""
    import numpy as np
    from jax.sharding import PartitionSpec as P_

    from .ba import build_track_table as _btt

    axes = tuple(mesh.axis_names)
    n = mesh.size
    P_pts = problem.points.shape[0]
    M = problem.obs.shape[0]
    if P_pts % n or M % n:
        raise ValueError(f"points {P_pts} and obs {M} must divide mesh size {n}")
    if problem.states.shape[1] == 15 and problem.bias_jac is None:
        # same contract as the unsharded path: zero-filled Jacobians
        # would silently decouple the bias states from the IMU residuals
        raise ValueError(
            "15-DOF states need bias_jac (preintegrate_with_bias_jacobians)"
        )
    C = problem.states.shape[0]
    lamv = jnp.asarray(lam, problem.points.dtype)
    P_local = P_pts // n
    M_local = M // n

    pt_np = np.asarray(problem.pt_idx)
    K = max(
        int(np.bincount(pt_np[d * M_local : (d + 1) * M_local], minlength=1).max())
        for d in range(n)
    )
    tables = np.stack(
        [
            _btt(pt_np[d * M_local : (d + 1) * M_local], P_local, K)
            for d in range(n)
        ]
    ).reshape(n * P_local, K)

    D = problem.states.shape[1]
    dofs = np.zeros((C, D), bool)
    dofs[0, :6] = True  # gauge anchor; velocities (and biases) always live
    fixed_dofs = jnp.asarray(dofs.reshape(-1))

    def local_vi_ba(
        states, points, cam_idx, pt_idx, obs, weight, bline, table,
        dR, dv, dp, T, g, w3, bjac, wrw,
    ):
        prob = VIBAProblem(
            states=states, points=points, cam_idx=cam_idx, pt_idx=pt_idx,
            obs=obs, dR=dR, dv=dv, dp=dp, interval_T=T, gravity=g,
            focal=problem.focal, weight=weight, baseline=bline,
            imu_weight=w3,
            bias_jac=bjac if D == 15 else None,
            bias_rw_weight=wrw if D == 15 else None,
        )

        def body(carry, _):
            pr, l = carry
            pr, msr_vis, msr_imu = _gn_step_vi(
                pr, l, C, P_local, table, fixed_dofs, psum_axes=axes
            )
            return (pr, l), jnp.stack([lax.psum(msr_vis, axes) / n, msr_imu])

        # full-f32 matmul passes, no TF32 (see ba._bundle_adjust_jit)
        with jax.default_matmul_precision("float32"):
            (out, _), hist = lax.scan(body, (prob, lamv), None, length=iters)
        return out.states, out.points, hist

    spec_pt = P_(axes)
    spec_rep = P_()
    fn = jax.shard_map(
        local_vi_ba,
        mesh=mesh,
        in_specs=(
            spec_rep, spec_pt, spec_pt, spec_pt, spec_pt, spec_pt, spec_pt,
            spec_pt, spec_rep, spec_rep, spec_rep, spec_rep, spec_rep,
            spec_rep, spec_rep, spec_rep,
        ),
        out_specs=(spec_rep, spec_pt, spec_rep),
    )
    weight = (
        problem.weight
        if problem.weight is not None
        else jnp.ones((M,), problem.obs.dtype)
    )
    bline = (
        problem.baseline
        if problem.baseline is not None
        else jnp.zeros((M,), problem.obs.dtype)
    )
    w3 = (
        problem.imu_weight
        if problem.imu_weight is not None
        else jnp.asarray(DEFAULT_IMU_WEIGHT, problem.states.dtype)
    )
    bjac = (
        problem.bias_jac
        if problem.bias_jac is not None
        else jnp.zeros((C - 1, 5, 3, 3), problem.states.dtype)
    )
    wrw = (
        problem.bias_rw_weight
        if problem.bias_rw_weight is not None
        else jnp.asarray(DEFAULT_BIAS_RW_WEIGHT, problem.states.dtype)
    )
    states, points, hist = fn(
        problem.states, problem.points, problem.cam_idx, problem.pt_idx,
        problem.obs, weight, bline, jnp.asarray(tables),
        problem.dR, problem.dv, problem.dp, problem.interval_T,
        problem.gravity, w3, bjac, wrw,
    )
    return problem._replace(states=states, points=points), hist


def vi_problem_from_ba(
    ba_problem,
    velocities,
    dR,
    dv,
    dp,
    interval_T,
    gravity,
    imu_weight=DEFAULT_IMU_WEIGHT,
    bias_jac=None,
    bias_rw_weight=DEFAULT_BIAS_RW_WEIGHT,
) -> VIBAProblem:
    """Lift a visual `ba.BAProblem` (consecutive-keyframe cameras) into a
    `VIBAProblem` given initial velocities and the preintegrated deltas of
    each consecutive interval (bias-corrected; `slam.imu.preintegrate`).

    bias_jac: optional (C-1, 5, 3, 3) first-order bias Jacobians
    (`slam.imu.preintegrate_with_bias_jacobians`) — providing them
    switches to 15-DOF bias-state mode: each state gains (dbg, dba),
    initialized at zero (the deltas' linearization point), coupled across
    keyframes by random-walk factors weighted `bias_rw_weight`."""
    states = jnp.concatenate(
        [ba_problem.cams, jnp.asarray(velocities, ba_problem.cams.dtype)],
        axis=-1,
    )
    if bias_jac is not None:
        states = jnp.concatenate(
            [states, jnp.zeros((states.shape[0], 6), states.dtype)], axis=-1
        )
    return VIBAProblem(
        states=states,
        points=ba_problem.points,
        cam_idx=ba_problem.cam_idx,
        pt_idx=ba_problem.pt_idx,
        obs=ba_problem.obs,
        dR=jnp.asarray(dR, states.dtype),
        dv=jnp.asarray(dv, states.dtype),
        dp=jnp.asarray(dp, states.dtype),
        interval_T=jnp.asarray(interval_T, states.dtype),
        gravity=jnp.asarray(gravity, states.dtype),
        focal=ba_problem.focal,
        weight=ba_problem.weight,
        baseline=ba_problem.baseline,
        imu_weight=jnp.asarray(imu_weight, states.dtype),
        bias_jac=(
            None if bias_jac is None else jnp.asarray(bias_jac, states.dtype)
        ),
        bias_rw_weight=(
            None
            if (bias_jac is None or bias_rw_weight is None)
            # an explicit None means "use the default" (the VIBAProblem
            # contract _imu_system honors) — not a crash in asarray
            else jnp.asarray(bias_rw_weight, states.dtype)
        ),
    )


def group_imu_by_keyframes(t, gyro, accel, kf_t):
    """Slice a continuous IMU log into padded per-keyframe-interval arrays
    (the layout `preintegrate`/`visual_inertial_alignment_with_bias`
    batch over).

    t: (N,) sample timestamps (sorted); gyro/accel: (N, 3); kf_t: (K,)
    keyframe timestamps. Sample k covers [t_k, t_{k+1}) and belongs to the
    interval containing t_k; samples outside [kf_t[0], kf_t[-1]) are
    dropped. Returns (gyro (K-1, W, 3), accel (K-1, W, 3), dt (K-1, W),
    valid (K-1, W))."""
    import numpy as np

    t = np.asarray(t, np.float64)
    kf_t = np.asarray(kf_t, np.float64)
    gyro = np.asarray(gyro, np.float64)
    accel = np.asarray(accel, np.float64)
    if len(t) < 2:
        raise ValueError("need >= 2 IMU samples")
    if len(kf_t) < 2:
        raise ValueError("need >= 2 keyframe timestamps")
    dt_all = np.diff(t)
    dt_all = np.append(dt_all, dt_all[-1])  # last sample: carry its period
    seg = np.searchsorted(kf_t, t, side="right") - 1  # interval of each sample
    K = len(kf_t)
    live = (seg >= 0) & (seg < K - 1)
    # vectorized grouping: stable-sort live samples by interval, then each
    # sample's slot is its rank within the interval (arange minus the
    # interval's start offset) — no per-sample Python loop (hour-long
    # 200 Hz logs are ~1e6 samples)
    idx = np.nonzero(live)[0]
    idx = idx[np.argsort(seg[idx], kind="stable")]
    segs = seg[idx]
    counts = np.bincount(segs, minlength=K - 1)
    W = max(int(counts.max()), 1) if len(idx) else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.arange(len(idx)) - np.repeat(starts, counts)
    g_out = np.zeros((K - 1, W, 3))
    a_out = np.zeros((K - 1, W, 3))
    h_out = np.zeros((K - 1, W))
    ok = np.zeros((K - 1, W), bool)
    g_out[segs, slots] = gyro[idx]
    a_out[segs, slots] = accel[idx]
    h_out[segs, slots] = dt_all[idx]
    ok[segs, slots] = True
    return g_out, a_out, h_out, ok


def refine_slam_with_imu(
    result,
    focal,
    imu_t,
    gyro,
    accel,
    kf_t,
    *,
    gravity_mag: float = 9.81,
    imu_weight=DEFAULT_IMU_WEIGHT,
    iters: int = 12,
    lam: float = 1e-3,
    estimate_accel_bias: bool = True,
    robust_delta=3.0,
    bias_states: bool = False,
    bias_rw_weight=DEFAULT_BIAS_RW_WEIGHT,
):
    """Tightly-coupled VI refinement of a finished `incremental_slam`
    solution: the SlamResult carries its own observations (cam_idx/pt_idx/
    obs), so no re-tracking is needed — group the raw IMU log by the
    keyframe timestamps, then run the full `refine_with_imu` pipeline.

    result: SlamResult (monocular, up-to-scale); imu_t/gyro/accel: the
    continuous IMU log; kf_t: (K,) capture timestamps of
    `result.keyframes` (e.g. np.asarray(result.keyframes) / fps).

    Returns (refined VIBAProblem, info dict) — metric poses in
    `out.states[:, :6]`, metric map in `out.points`.

    robust_delta defaults to 3 px (Huber IRLS on the visual residuals),
    matching the final global BA's discipline: the exported observations
    span every association ever made, and one wrong track must not drag
    the metric trajectory (incremental.py). Pass None for squared loss."""
    import numpy as np

    if result.cam_idx is None or len(result.cam_idx) == 0:
        raise ValueError("SlamResult carries no observations to refine")
    g, a, h, ok = group_imu_by_keyframes(imu_t, gyro, accel, kf_t)
    if not ok.any(axis=1).all():
        raise ValueError("an inter-keyframe interval has no IMU samples")
    return refine_with_imu(
        result.poses,
        result.trans,
        result.points,
        result.cam_idx,
        result.pt_idx,
        result.obs,
        focal,
        g, a, h, ok,
        gravity_mag=gravity_mag,
        imu_weight=imu_weight,
        iters=iters,
        lam=lam,
        estimate_accel_bias=estimate_accel_bias,
        baseline=result.obs_baseline,
        robust_delta=robust_delta,
        bias_states=bias_states,
        bias_rw_weight=bias_rw_weight,
    )


def refine_with_imu(
    poses,
    trans,
    points,
    cam_idx,
    pt_idx,
    obs,
    focal,
    gyro,
    accel,
    dt,
    valid=None,
    *,
    gravity_mag: float = 9.81,
    imu_weight=DEFAULT_IMU_WEIGHT,
    iters: int = 12,
    lam: float = 1e-3,
    estimate_accel_bias: bool = True,
    baseline=None,
    robust_delta=None,
    bias_states: bool = False,
    bias_rw_weight=DEFAULT_BIAS_RW_WEIGHT,
):
    """End-to-end tightly-coupled refinement of a monocular solution.

    baseline: optional (M,) rectified-rig eye offsets (`BAProblem.baseline`)
    so stereo right-eye observations keep constraining the joint solve.

    bias_states: carry per-keyframe bias DELTAS (15-DOF states) through
    the joint solve with random-walk coupling (weight `bias_rw_weight`,
    1/sigma_rw per sqrt-second) — required on logs long enough for the
    biases to drift past the one-shot upstream estimate (which fits a
    single constant bias to the whole log). The info dict then reports
    per-keyframe absolute biases (upstream estimate + solved deltas).

    estimate_accel_bias: pass False on rotation-poor trajectories — accel
    bias is separable from gravity only when the body rotates about
    varied axes (slam/imu.py); on a near-translation-only log the joint
    solve is rank-deficient and the spurious bias corrupts the deltas.

    Pipeline: gyro/accel bias estimation + the linear VI alignment
    (`slam.imu.visual_inertial_alignment_with_bias`) initialize metric
    scale, gravity and velocities; the visual solution is rescaled to
    metric; then `vi_bundle_adjust` jointly refines poses, velocities and
    points against reprojection + preintegration factors.

    poses/trans: (K,3,3)/(K,3) world->cam keyframe poses (up-to-scale);
    points (P,3) in the same frame; cam_idx/pt_idx/obs the keyframe
    observations (`ba.BAProblem` layout); gyro/accel/dt/valid the
    per-interval IMU logs as in `visual_inertial_alignment_with_bias`.

    Returns (VIBAProblem refined, info dict with scale/gravity/biases and
    the residual history)."""
    import cv2
    import numpy as np

    from .imu import (
        preintegrate,
        preintegrate_with_bias_jacobians,
        visual_inertial_alignment_with_bias,
    )

    live = np.ones(np.asarray(dt).shape, bool) if valid is None else np.asarray(valid, bool)
    T = np.sum(np.asarray(dt, np.float64) * live, axis=-1)  # (K-1,)
    s, g, vels, bg, ba_bias, rms = visual_inertial_alignment_with_bias(
        poses, trans, T, gyro, accel, dt, valid, gravity_mag=gravity_mag,
        estimate_accel_bias=estimate_accel_bias,
    )
    corrected_gyro = np.asarray(gyro, np.float32) - np.asarray(bg, np.float32)
    corrected_accel = (
        np.asarray(accel, np.float32) - np.asarray(ba_bias, np.float32)
    )
    bias_jac = None
    if bias_states:
        dR, dv, dp, bias_jac = preintegrate_with_bias_jacobians(
            corrected_gyro, corrected_accel, dt, live
        )
    else:
        dR, dv, dp = preintegrate(corrected_gyro, corrected_accel, dt, live)
    s_apply = s
    if baseline is not None and np.any(np.asarray(baseline) != 0):
        # stereo input: the solution is ALREADY metric (rig-anchored) and
        # the baseline residuals assume fixed metric units — applying the
        # alignment's noisy s (≈1) would push the init off metric and
        # fight the rig observations. Keep the geometry; the alignment
        # still supplies gravity/velocities/biases.
        s_apply = 1.0
    cams = jnp.asarray(
        np.concatenate(
            [
                np.stack([cv2.Rodrigues(np.asarray(R))[0].ravel() for R in poses]),
                s_apply * np.asarray(trans, np.float64),  # metric translations
            ],
            axis=-1,
        ),
        jnp.float32,
    )

    prob = vi_problem_from_ba(
        BAProblem(
            cams=cams,
            points=jnp.asarray(s_apply * np.asarray(points, np.float64), jnp.float32),
            cam_idx=jnp.asarray(cam_idx, jnp.int32),
            pt_idx=jnp.asarray(pt_idx, jnp.int32),
            obs=jnp.asarray(obs, jnp.float32),
            baseline=(
                None if baseline is None else jnp.asarray(baseline, jnp.float32)
            ),
            focal=focal,
        ),
        vels, dR, dv, dp, T, g, imu_weight=imu_weight,
        bias_jac=bias_jac, bias_rw_weight=bias_rw_weight,
    )
    out, hist = vi_bundle_adjust(
        prob, iters=iters, lam=lam, robust_delta=robust_delta
    )
    info = {
        "scale": float(s),
        "scale_applied": float(s_apply),
        "gravity": np.asarray(g),
        "gyro_bias": np.asarray(bg),
        "accel_bias": np.asarray(ba_bias),
        "alignment_rms": float(rms),
        "history": np.asarray(hist),
    }
    if bias_states:
        # absolute per-keyframe biases: the one-shot upstream estimate
        # plus the solved per-keyframe deltas
        st = np.asarray(out.states)
        info["gyro_bias_per_kf"] = np.asarray(bg)[None] + st[:, 9:12]
        info["accel_bias_per_kf"] = np.asarray(ba_bias)[None] + st[:, 12:15]
    return out, info
