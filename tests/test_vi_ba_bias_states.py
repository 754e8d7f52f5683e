"""Bias-state VI-BA (VERDICT r4 #4): 15-DOF states carrying per-keyframe
bias deltas with first-order preintegration bias Jacobians and
between-keyframe random-walk factors.

The regime that motivates them: a DRIFTING bias. The frozen-bias pipeline
(9-DOF) fits ONE constant bias to the whole log — on a log whose gyro
bias walks, the per-interval residual bias corrupts the preintegrated
rotations and the metric estimate measurably degrades; the bias-state
solve lets each keyframe's bias follow the walk and recovers."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from optical_flow_tpu.slam.imu import (
    preintegrate,
    preintegrate_with_bias_jacobians,
)
from optical_flow_tpu.slam.vi_ba import (
    refine_with_imu,
    vi_bundle_adjust,
    vi_problem_from_ba,
)
from tests.test_vi_ba import FOCAL, G_W, _make_scene, _scale_of
from optical_flow_tpu.slam.ba import BAProblem


def _sample_times(sc):
    """(K-1, N) absolute time of each IMU sample in the scene layout."""
    K1, n = sc["dt"].shape
    h = sc["dt"][0, 0]
    kf_t = sc["kf_t"][:-1][:, None]
    return kf_t + np.arange(n)[None, :] * h


def _add_drifting_bias(sc, bg0, bg_slope, ba0, ba_slope):
    """Inject time-varying biases b(t) = b0 + slope * t into the exact
    IMU log (slope in units/s — a linear stand-in for the random walk)."""
    t = _sample_times(sc)[..., None]  # (K-1, N, 1)
    gyro = sc["gyro"] + np.asarray(bg0) + np.asarray(bg_slope) * t
    accel = sc["accel"] + np.asarray(ba0) + np.asarray(ba_slope) * t
    return gyro, accel


def test_bias_jacobians_match_finite_differences():
    """The jacfwd-through-the-scan Jacobians equal central differences of
    the preintegration (rotation block in the Exp-correction chart)."""
    from optical_flow_tpu.slam.imu import _log_so3

    sc = _make_scene(K=4)
    dR0, dv0, dp0, J = preintegrate_with_bias_jacobians(
        sc["gyro"], sc["accel"], sc["dt"]
    )
    dR0, dv0, dp0, J = map(np.asarray, (dR0, dv0, dp0, J))
    # cross-check the zero-delta deltas against plain preintegrate
    dR_p, dv_p, dp_p = map(
        np.asarray, preintegrate(sc["gyro"], sc["accel"], sc["dt"])
    )
    np.testing.assert_allclose(dR0, dR_p, atol=1e-6)
    np.testing.assert_allclose(dv0, dv_p, atol=1e-6)

    # eps sized for f32 preintegration noise: the deltas are LINEAR in
    # the accel bias (any eps is exact) and the rotation's second-order
    # term at eps=3e-3 rad/s over a 0.5 s interval is ~(1.5e-3)^2 —
    # far below the tolerance, while the f32 FD noise shrinks with eps
    eps_g, eps_a = 3e-3, 1e-2
    for axis in range(3):
        dbg = np.zeros(3)
        dbg[axis] = eps_g
        # b enters as (measurement - b): perturb the measurements
        dRp, dvp, dpp = map(
            np.asarray,
            preintegrate(sc["gyro"] - dbg, sc["accel"], sc["dt"]),
        )
        dRm, dvm, dpm = map(
            np.asarray,
            preintegrate(sc["gyro"] + dbg, sc["accel"], sc["dt"]),
        )
        rp = np.stack(
            [np.asarray(_log_so3(jnp.asarray(dR0[i].T @ dRp[i])))
             for i in range(len(dR0))]
        )
        rm = np.stack(
            [np.asarray(_log_so3(jnp.asarray(dR0[i].T @ dRm[i])))
             for i in range(len(dR0))]
        )
        tol = dict(atol=5e-3, rtol=5e-3)
        np.testing.assert_allclose(
            J[:, 0, :, axis], (rp - rm) / (2 * eps_g), **tol
        )
        np.testing.assert_allclose(
            J[:, 1, :, axis], (dvp - dvm) / (2 * eps_g), **tol
        )
        np.testing.assert_allclose(
            J[:, 3, :, axis], (dpp - dpm) / (2 * eps_g), **tol
        )
        dba = np.zeros(3)
        dba[axis] = eps_a
        dva, dpa = map(
            np.asarray,
            preintegrate(sc["gyro"], sc["accel"] - dba, sc["dt"])[1:],
        )
        np.testing.assert_allclose(
            J[:, 2, :, axis], (dva - dv0) / eps_a, **tol
        )
        np.testing.assert_allclose(
            J[:, 4, :, axis], (dpa - dp0) / eps_a, **tol
        )


def test_bias_states_recover_drifting_gyro_bias():
    """On a log whose gyro bias DRIFTS, the frozen-bias refinement
    measurably degrades while the bias-state solve recovers the
    trajectory AND tracks the per-keyframe bias walk."""
    pytest.importorskip("cv2")  # refine_with_imu needs cv2
    sc = _make_scene()
    s_true = 3.0
    bg0 = np.asarray([0.01, -0.008, 0.012])
    bg_slope = np.asarray([0.016, -0.012, 0.014])  # rad/s per s of log
    ba0 = np.asarray([0.08, -0.05, 0.10])
    gyro, accel = _add_drifting_bias(sc, bg0, bg_slope, ba0, 0.0)

    common = dict(
        cam_idx=sc["cam_idx"], pt_idx=sc["pt_idx"], obs=sc["obs"],
    )
    out_f, info_f = refine_with_imu(
        sc["poses"], sc["trans"] / s_true, sc["X"] / s_true,
        common["cam_idx"], common["pt_idx"], common["obs"], FOCAL,
        gyro, accel, sc["dt"], iters=12,
    )
    # random-walk weight matched to the injected walk, as a user would
    # set it from the sensor spec: |db| ~ 0.008 rad/s per 0.5 s interval
    # -> sigma_rw ~ 0.011 rad/s/sqrt(s) -> information ~ 1e2 (the 1e3
    # default models a 10x gentler consumer-MEMS walk)
    out_b, info_b = refine_with_imu(
        sc["poses"], sc["trans"] / s_true, sc["X"] / s_true,
        common["cam_idx"], common["pt_idx"], common["obs"], FOCAL,
        gyro, accel, sc["dt"], iters=12, bias_states=True,
        bias_rw_weight=(1e2, 1e2),
    )
    _, est_f = _scale_of(np.asarray(out_f.states), sc)
    _, est_b = _scale_of(np.asarray(out_b.states), sc)
    err_f = np.linalg.norm(est_f - sc["centers"], axis=1).mean()
    err_b = np.linalg.norm(est_b - sc["centers"], axis=1).mean()
    span = np.linalg.norm(sc["centers"], axis=1).max()
    # the frozen-bias pipeline degrades measurably under the drift...
    assert err_f > 2.0 * err_b, (err_f, err_b)
    # ...while the bias-state solve holds production accuracy
    assert err_b < 0.03 * span, (err_b, span)
    # and the per-keyframe gyro biases track the injected walk
    bg_kf = info_b["gyro_bias_per_kf"]  # (K, 3)
    true_bg = bg0[None] + bg_slope[None] * sc["kf_t"][:, None]
    track_err = np.abs(bg_kf - true_bg)
    assert track_err.mean() < 0.2 * np.abs(
        bg_slope * sc["kf_t"][-1]
    ).mean(), (track_err.mean(), bg_kf, true_bg)


def test_bias_states_noop_on_clean_log():
    """Regression guard: with constant (well-estimated) biases, the
    bias-state solve matches the frozen-bias result and its solved bias
    deltas stay near zero."""
    pytest.importorskip("cv2")  # refine_with_imu needs cv2
    sc = _make_scene()
    s_true = 2.0
    bg = np.asarray([0.01, -0.008, 0.012])
    ba = np.asarray([0.08, -0.05, 0.10])
    gyro, accel = sc["gyro"] + bg, sc["accel"] + ba
    out_f, _ = refine_with_imu(
        sc["poses"], sc["trans"] / s_true, sc["X"] / s_true,
        sc["cam_idx"], sc["pt_idx"], sc["obs"], FOCAL,
        gyro, accel, sc["dt"], iters=12,
    )
    out_b, info_b = refine_with_imu(
        sc["poses"], sc["trans"] / s_true, sc["X"] / s_true,
        sc["cam_idx"], sc["pt_idx"], sc["obs"], FOCAL,
        gyro, accel, sc["dt"], iters=12, bias_states=True,
    )
    _, est_f = _scale_of(np.asarray(out_f.states), sc)
    _, est_b = _scale_of(np.asarray(out_b.states), sc)
    np.testing.assert_allclose(est_b, est_f, atol=5e-3)
    assert np.abs(np.asarray(out_b.states)[:, 9:15]).max() < 5e-3


def test_sharded_bias_state_vi_ba_matches_unsharded():
    """15-DOF bias-state VI-BA under the 8-device mesh: points sharded,
    states + deltas + bias Jacobians replicated — matches unsharded at
    1e-6 (the replicated-factor contract extends to the bias blocks)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from optical_flow_tpu.parallel import flow_mesh
    from optical_flow_tpu.slam.vi_ba import sharded_vi_bundle_adjust

    mesh = flow_mesh(frames=2, rows=2, cols=2)
    sc = _make_scene()
    # drifting bias so the bias states do real work in the solve
    gyro, accel = _add_drifting_bias(
        sc, [0.005, -0.004, 0.006], [0.01, -0.008, 0.009], 0.0, 0.0
    )
    dR, dv, dp, J = preintegrate_with_bias_jacobians(gyro, accel, sc["dt"])
    T = np.sum(sc["dt"], -1)
    rng = np.random.RandomState(5)
    pert = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert[1:, :3] += rng.randn(len(pert) - 1, 3) * 0.01
    pert[1:, 3:6] += rng.randn(len(pert) - 1, 3) * 0.02
    Xp = sc["X"] + rng.randn(*sc["X"].shape) * 0.02
    base = BAProblem(
        cams=jnp.asarray(pert[:, :6]), points=jnp.asarray(Xp),
        cam_idx=jnp.asarray(sc["cam_idx"]), pt_idx=jnp.asarray(sc["pt_idx"]),
        obs=jnp.asarray(sc["obs"]), focal=FOCAL,
    )
    prob = vi_problem_from_ba(
        base, pert[:, 6:9], dR, dv, dp, T, G_W, bias_jac=J
    )
    assert prob.states.shape[1] == 15
    ref, _ = vi_bundle_adjust(prob, iters=6, lam=1e-4)

    n = mesh.size
    P_loc = sc["X"].shape[0] // n
    order = np.argsort(sc["pt_idx"], kind="stable")
    prob_s = prob._replace(
        cam_idx=jnp.asarray(sc["cam_idx"][order]),
        pt_idx=jnp.asarray(sc["pt_idx"][order] % P_loc),
        obs=jnp.asarray(sc["obs"][order]),
    )
    out_s, _ = sharded_vi_bundle_adjust(prob_s, mesh, iters=6, lam=1e-4)
    np.testing.assert_allclose(
        np.asarray(out_s.states), np.asarray(ref.states), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out_s.points), np.asarray(ref.points), atol=1e-6
    )
