"""Tightly-coupled visual-inertial BA (slam/vi_ba.py): the preintegration
residual conventions pinned at ground truth, joint convergence from a
perturbed init, and the headline property vision alone cannot provide —
METRIC SCALE OBSERVABILITY: a uniformly rescaled monocular solution has
identical reprojection residuals (the scale gauge), but violates the
metric IMU deltas, so VI-BA pulls the map back to true scale while
vision-only BA provably leaves it where it started."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

jnp = pytest.importorskip("jax.numpy")

from optical_flow_tpu.slam.ba import BAProblem, bundle_adjust, project
from optical_flow_tpu.slam.imu import preintegrate
from optical_flow_tpu.slam.vi_ba import (
    VIBAProblem,
    refine_with_imu,
    vi_bundle_adjust,
    vi_problem_from_ba,
)

G_W = np.asarray([0.0, -9.81, 0.0])
FOCAL = 500.0


def _rotvec_to_mat(r):
    """Axis-angle (3,) -> rotation matrix (cv2.Rodrigues' forward map)."""
    return Rotation.from_rotvec(np.array(r, np.float64).ravel()).as_matrix()


def _mat_to_rotvec(R):
    """Rotation matrix -> axis-angle (3,) (cv2.Rodrigues' inverse map)."""
    return Rotation.from_matrix(np.array(R, np.float64)).as_rotvec()


def _traj(t):
    """Analytic trajectory: center, world acceleration, world->cam R."""
    om = 2 * np.pi / 8.0
    r, a = 0.4, 0.1
    t = np.asarray(t, np.float64)
    c = np.stack(
        [r * np.sin(om * t), a * (1 - np.cos(2 * om * t)), r * (1 - np.cos(om * t))],
        -1,
    )
    acc = np.stack(
        [
            -r * om * om * np.sin(om * t),
            4 * a * om * om * np.cos(2 * om * t),
            r * om * om * np.cos(om * t),
        ],
        -1,
    )

    def rot(ti):
        # time-varying rotation about two DIFFERENT axes (bias estimation
        # in refine_with_imu needs the axis variety; see slam/imu.py)
        ry = _rotvec_to_mat([0.0, 0.25 * np.sin(om * ti), 0.0])
        rx = _rotvec_to_mat(
            np.asarray([0.15 * np.sin(2 * om * ti + 0.5), 0.0, 0.0])
        )
        return rx @ ry  # world->cam

    R = np.stack([rot(ti) for ti in np.atleast_1d(t)])
    return c, acc, R


def _make_scene(K=8, dt_kf=0.5, rate=200.0, seed=0):
    """K keyframes on the analytic trajectory, a landmark cloud observed
    by all of them, and the exact IMU log of each interval."""
    rng = np.random.RandomState(seed)
    kf_t = np.arange(K) * dt_kf
    centers, _, poses = _traj(kf_t)
    trans = np.einsum("kij,kj->ki", poses, -centers)
    X = np.stack(
        [
            rng.uniform(-1.2, 1.2, 120),
            rng.uniform(-0.9, 0.9, 120),
            rng.uniform(3.0, 6.0, 120),
        ],
        -1,
    )
    cams = np.concatenate(
        [np.stack([_mat_to_rotvec(R) for R in poses]), trans], -1
    )
    # vectorized ground-truth projections (numpy, cam-major order)
    P = len(X)
    Xc = np.einsum("kij,pj->kpi", poses, X) + trans[:, None, :]
    uv_all = FOCAL * Xc[..., :2] / Xc[..., 2:3]
    cam_idx = np.repeat(np.arange(K), P)
    pt_idx = np.tile(np.arange(P), K)
    obs = list(uv_all.reshape(K * P, 2))
    # IMU: numeric gyro from the relative-rotation log, analytic accel
    n = int(round(dt_kf * rate))
    h = 1.0 / rate
    gyro = np.zeros((K - 1, n, 3))
    accel = np.zeros((K - 1, n, 3))
    dt = np.full((K - 1, n), h)
    vel = np.zeros((K, 3))
    eps = 1e-6
    for k in range(K):
        c0, _, _ = _traj(kf_t[k] - eps)
        c1, _, _ = _traj(kf_t[k] + eps)
        vel[k] = (c1 - c0) / (2 * eps)
    for i in range(K - 1):
        for s in range(n):
            t0 = kf_t[i] + s * h
            tm = t0 + 0.5 * h
            _, _, R0 = _traj(t0)
            _, _, R1 = _traj(t0 + h)
            w = _mat_to_rotvec(R0[0] @ R1[0].T)
            gyro[i, s] = w / h
            _, am, Rm = _traj(tm)
            accel[i, s] = Rm[0] @ (am - G_W)
    return {
        "kf_t": kf_t,
        "poses": poses,
        "trans": trans,
        "centers": centers,
        "vel": vel,
        "X": X,
        "cams": cams,
        "cam_idx": np.asarray(cam_idx, np.int32),
        "pt_idx": np.asarray(pt_idx, np.int32),
        "obs": np.stack(obs),
        "gyro": gyro,
        "accel": accel,
        "dt": dt,
    }


def _problem(sc, states=None, points=None):
    dR, dv, dp = preintegrate(sc["gyro"], sc["accel"], sc["dt"])
    base = BAProblem(
        cams=jnp.asarray(sc["cams"] if states is None else states[:, :6]),
        points=jnp.asarray(sc["X"] if points is None else points),
        cam_idx=jnp.asarray(sc["cam_idx"]),
        pt_idx=jnp.asarray(sc["pt_idx"]),
        obs=jnp.asarray(sc["obs"]),
        focal=FOCAL,
    )
    v = sc["vel"] if states is None else states[:, 6:9]
    T = np.sum(sc["dt"], -1)
    return vi_problem_from_ba(base, v, dR, dv, dp, T, G_W)


def _scale_of(states, sc):
    """Mean trajectory-scale ratio vs ground truth (c_0 = 0 by design)."""
    est = np.stack(
        [
            -_rotvec_to_mat(s[:3]).T @ np.asarray(s[3:6])
            for s in states
        ]
    )
    true = sc["centers"]
    num = np.linalg.norm(est[1:], axis=1)
    den = np.linalg.norm(true[1:], axis=1)
    return float(np.mean(num / den)), est


def test_vi_residuals_zero_at_ground_truth():
    """The formulation's conventions (world->cam poses, c = -R^T t, body
    == camera, gravity sign) pinned: at ground truth every residual is
    integration error only."""
    from optical_flow_tpu.slam.vi_ba import _imu_residual

    sc = _make_scene()
    prob = _problem(sc)
    w3 = jnp.asarray([1.0, 1.0, 1.0])
    for i in range(len(sc["kf_t"]) - 1):
        r = np.asarray(
            _imu_residual(
                prob.states[i], prob.states[i + 1], prob.dR[i], prob.dv[i],
                prob.dp[i], prob.interval_T[i], prob.gravity, w3,
            )
        )
        assert np.abs(r[:3]).max() < 2e-4, (i, r)  # rad
        assert np.abs(r[3:6]).max() < 2e-3, (i, r)  # m/s (f32 preint)
        assert np.abs(r[6:9]).max() < 1e-3, (i, r)  # m


def test_vi_ba_converges_from_perturbed_init():
    sc = _make_scene()
    rng = np.random.RandomState(7)
    states = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert = states.copy()
    pert[1:, :3] += rng.randn(len(states) - 1, 3) * 0.01
    pert[1:, 3:6] += rng.randn(len(states) - 1, 3) * 0.02
    pert[:, 6:9] += rng.randn(len(states), 3) * 0.05
    Xp = sc["X"] + rng.randn(*sc["X"].shape) * 0.02
    prob = _problem(sc, states=pert, points=Xp)
    out, hist = vi_bundle_adjust(prob, iters=12, lam=1e-4)
    scale, est = _scale_of(np.asarray(out.states), sc)
    err = np.linalg.norm(est - sc["centers"], axis=1)
    assert err.mean() < 5e-3, err
    assert abs(scale - 1.0) < 0.01, scale
    v_err = np.abs(np.asarray(out.states)[:, 6:9] - sc["vel"]).max()
    assert v_err < 0.03, v_err
    # residual history decreases
    h = np.asarray(hist)
    assert h[-1, 0] < h[0, 0]


def test_vi_ba_recovers_metric_scale_where_vision_cannot():
    """The headline: scale the whole monocular solution by 1.15 — vision
    is blind to it (gauge), the IMU factors are not."""
    sc = _make_scene()
    s0 = 1.15
    states = np.concatenate([sc["cams"], sc["vel"]], -1)
    scaled = states.copy()
    scaled[:, 3:6] *= s0  # t = -R c scales with c
    scaled[:, 6:9] *= s0
    Xs = sc["X"] * s0

    # vision-only BA: the scaled solution is a zero-gradient gauge point
    vis, _ = bundle_adjust(
        BAProblem(
            cams=jnp.asarray(scaled[:, :6]),
            points=jnp.asarray(Xs),
            cam_idx=jnp.asarray(sc["cam_idx"]),
            pt_idx=jnp.asarray(sc["pt_idx"]),
            obs=jnp.asarray(sc["obs"]),
            focal=FOCAL,
        ),
        iters=8,
    )
    s_vis, _ = _scale_of(
        np.concatenate([np.asarray(vis.cams), scaled[:, 6:9]], -1), sc
    )
    assert s_vis > 1.12, s_vis  # scale untouched by vision

    out, _ = vi_bundle_adjust(_problem(sc, states=scaled, points=Xs), iters=15, lam=1e-4)
    s_vi, est = _scale_of(np.asarray(out.states), sc)
    assert abs(s_vi - 1.0) < 0.015, s_vi
    err = np.linalg.norm(est - sc["centers"], axis=1)
    assert err.mean() < 5e-3, err


def test_refine_with_imu_end_to_end_under_bias():
    """Up-to-scale visual solution + BIASED raw IMU logs -> metric
    trajectory: bias estimation, linear alignment init, then the joint
    VI-BA — the full tightly-coupled pipeline in one call."""
    pytest.importorskip("cv2")  # refine_with_imu needs cv2
    sc = _make_scene()
    s_true = 3.0  # metric = s_true * visual units
    bg = np.asarray([0.01, -0.008, 0.012])
    ba = np.asarray([0.08, -0.05, 0.10])
    gyro = sc["gyro"] + bg
    accel = sc["accel"] + ba
    out, info = refine_with_imu(
        sc["poses"],
        sc["trans"] / s_true,
        sc["X"] / s_true,
        sc["cam_idx"],
        sc["pt_idx"],
        sc["obs"],
        FOCAL,
        gyro,
        accel,
        sc["dt"],
        iters=12,
    )
    assert abs(info["scale"] - s_true) / s_true < 0.05, info["scale"]
    np.testing.assert_allclose(info["gyro_bias"], bg, atol=2e-3)
    scale, est = _scale_of(np.asarray(out.states), sc)
    err = np.linalg.norm(est - sc["centers"], axis=1)
    span = np.linalg.norm(sc["centers"], axis=1).max()
    assert err.mean() < 0.03 * span, (err.mean(), span)
    assert abs(scale - 1.0) < 0.03, scale


def test_sharded_vi_ba_matches_unsharded():
    """Points + observations sharded over the 8-device mesh, states and
    IMU factors replicated: state/point updates match the unsharded VI-BA
    (the IMU system is assembled AFTER the psum, once per device — the
    replicated-factor contract of slam/vi_ba.py)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from optical_flow_tpu.parallel import flow_mesh
    from optical_flow_tpu.slam.vi_ba import sharded_vi_bundle_adjust

    mesh = flow_mesh(frames=2, rows=2, cols=2)
    sc = _make_scene()
    rng = np.random.RandomState(5)
    states = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert = states.copy()
    pert[1:, :3] += rng.randn(len(states) - 1, 3) * 0.01
    pert[1:, 3:6] += rng.randn(len(states) - 1, 3) * 0.02
    Xp = sc["X"] + rng.randn(*sc["X"].shape) * 0.02
    prob = _problem(sc, states=pert, points=Xp)
    ref, _ = vi_bundle_adjust(prob, iters=6, lam=1e-4)

    # group observations by owning shard (15 points x 8 obs per shard)
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


def test_robust_vi_ba_survives_gross_outliers():
    """Huber IRLS on the visual residuals (robust_delta): 8% of
    observations corrupted by 30-60 px wrong associations. Squared loss
    drags the metric trajectory; the robust solve stays near clean-data
    accuracy. IMU factors are never downweighted."""
    sc = _make_scene()
    rng = np.random.RandomState(13)
    M = len(sc["obs"])
    bad = rng.choice(M, M // 12, replace=False)
    obs_bad = sc["obs"].copy()
    obs_bad[bad] += rng.uniform(30, 60, (len(bad), 2)) * np.sign(
        rng.randn(len(bad), 2)
    )
    sc_bad = dict(sc, obs=obs_bad)
    states = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert = states.copy()
    pert[1:, 3:6] += rng.randn(len(states) - 1, 3) * 0.02

    out_sq, _ = vi_bundle_adjust(
        _problem(sc_bad, states=pert), iters=12, lam=1e-4
    )
    out_rb, _ = vi_bundle_adjust(
        _problem(sc_bad, states=pert), iters=12, lam=1e-4, robust_delta=3.0
    )
    _, est_sq = _scale_of(np.asarray(out_sq.states), sc)
    _, est_rb = _scale_of(np.asarray(out_rb.states), sc)
    err_sq = np.linalg.norm(est_sq - sc["centers"], axis=1).mean()
    err_rb = np.linalg.norm(est_rb - sc["centers"], axis=1).mean()
    assert err_rb < 5e-3, err_rb
    assert err_rb < 0.5 * err_sq, (err_rb, err_sq)


def test_cli_slam_with_imu(tmp_path, capsys):
    """The application driver end-to-end: rendered loop -> mp4 ->
    `slam --imu log.npz` -> metric trajectory printed and saved (no
    scale fit anywhere)."""
    cv2 = pytest.importorskip("cv2")
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_incremental_slam import _render_loop

    n = 12
    period = 6.0
    frames, centers, focal = _render_loop(n_frames=n)
    h, w = frames[0].shape
    path = str(tmp_path / "loop.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 20.0, (w, h), False)
    if not vw.isOpened():
        pytest.skip("no mp4 encoder available")
    for f in frames:
        vw.write(f)
    vw.release()

    om = 2 * np.pi / period
    rate = 200.0
    t = np.arange(0.0, period, 1.0 / rate)
    acc = np.stack(
        [
            -0.12 * om * om * np.sin(om * t),
            0.08 * om * om * np.cos(om * t),
            np.zeros_like(t),
        ],
        -1,
    )
    imu_path = str(tmp_path / "imu.npz")
    np.savez(imu_path, t=t, gyro=np.zeros((len(t), 3)), accel=acc - G_W)

    from optical_flow_tpu.__main__ import main

    out = str(tmp_path / "traj.npz")
    main([
        "--cpu", "slam", "--input", path, "--frames", str(n),
        "--focal", str(focal), "--kf-disparity", "0",
        "--imu", imu_path, "--video-fps", str(n / period),
        "--no-accel-bias", "--out", out,
    ])
    text = capsys.readouterr().out
    assert "VI refinement: scale" in text and "METRIC center" in text
    got = np.load(out)
    est = np.stack([-R.T @ t_ for R, t_ in zip(got["poses"], got["trans"])])
    true = np.asarray([centers[i] for i in got["keyframes"]])
    # metric, through lossy encoding, no fit
    assert np.linalg.norm(est - true, axis=1).mean() < 0.05


def test_refine_stereo_slam_result_keeps_metric():
    """A STEREO SlamResult is already metric (rig-anchored): the refiner
    must skip the alignment rescale (scale_applied == 1) — the rig
    baselines stay in fixed units, and applying the alignment's noisy
    scale estimate would push the init off metric — and the refined
    trajectory must stay at stereo accuracy."""
    pytest.importorskip("cv2")  # refine_with_imu needs cv2
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_stereo_slam import _render_stereo_loop

    from optical_flow_tpu.slam import incremental_slam
    from optical_flow_tpu.slam.vi_ba import refine_slam_with_imu

    n = 10
    period = 6.0
    pairs, centers, focal, _, _ = _render_stereo_loop(n_frames=n, baseline=0.3)
    res = incremental_slam(
        pairs, focal, stereo_baseline=0.3, loop_min_separation=20,
        min_tracks=40, window=8,
    )
    assert res is not None and np.any(res.obs_baseline != 0)
    err_in = np.linalg.norm(
        res.centers() - np.asarray([centers[i] for i in res.keyframes]), axis=1
    ).mean()

    om = 2 * np.pi / period
    rate = 200.0
    t = np.arange(0.0, period, 1.0 / rate)
    acc = np.stack(
        [
            -0.12 * om * om * np.sin(om * t),
            0.08 * om * om * np.cos(om * t),
            np.zeros_like(t),
        ],
        -1,
    )
    kf_t = np.asarray(res.keyframes) * (period / n)
    out, info = refine_slam_with_imu(
        res, focal, t, np.zeros((len(t), 3)), acc - G_W, kf_t,
        estimate_accel_bias=False,
    )
    assert info["scale_applied"] == 1.0, info
    est = np.stack(
        [
            -_rotvec_to_mat(s[:3]).T @ np.asarray(s[3:6])
            for s in np.asarray(out.states)
        ]
    )
    true = np.asarray([centers[i] for i in res.keyframes])
    err_out = np.linalg.norm(est - true, axis=1).mean()
    # still metric, not degraded by the refinement
    assert err_out < max(2.0 * err_in, 0.05), (err_in, err_out)


def test_vi_ba_rejects_single_keyframe():
    sc = _make_scene(K=8)
    prob = _problem(sc)
    with pytest.raises(ValueError):
        vi_bundle_adjust(prob._replace(states=prob.states[:1]))


def test_group_imu_by_keyframes():
    """Continuous-log slicing: per-interval counts/durations, tail drop,
    and preintegration equivalence with the hand-grouped layout."""
    from optical_flow_tpu.slam.vi_ba import group_imu_by_keyframes

    rate = 100.0
    t = np.arange(0, 4.0, 1.0 / rate)
    rng = np.random.RandomState(2)
    gyro = rng.randn(len(t), 3) * 0.3
    accel = rng.randn(len(t), 3)
    kf_t = np.asarray([0.0, 1.0, 2.0, 3.0])
    g, a, h, ok = group_imu_by_keyframes(t, gyro, accel, kf_t)
    assert g.shape[0] == 3 and ok.sum(axis=1).tolist() == [100, 100, 100]
    np.testing.assert_allclose((h * ok).sum(axis=1), 1.0, atol=1e-9)
    # samples at/after kf_t[-1] are dropped
    assert ok.sum() == 300
    # grouped preintegration == direct preintegration of each slice
    dR, dv, dp = preintegrate(g, a, h, ok)
    dR0, dv0, dp0 = preintegrate(gyro[:100], accel[:100], np.full(100, 0.01))
    np.testing.assert_allclose(np.asarray(dR[0]), np.asarray(dR0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(dv[0]), np.asarray(dv0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(dp[0]), np.asarray(dp0), atol=1e-6)


def test_refine_slam_result_with_imu():
    """The production hook: incremental_slam's SlamResult now carries its
    own observations, so the tightly-coupled refiner runs on a FINISHED
    monocular solution + a continuous IMU log — metric trajectory with no
    oracle scale fit anywhere."""
    pytest.importorskip("cv2")  # refine_with_imu needs cv2
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_incremental_slam import _render_loop

    from optical_flow_tpu.slam import incremental_slam
    from optical_flow_tpu.slam.ba import BAProblem, reprojection_rmse
    from optical_flow_tpu.slam.vi_ba import refine_slam_with_imu

    n = 12
    frames, centers, focal = _render_loop(n_frames=n)
    res = incremental_slam(
        frames, focal, loop_min_separation=20, min_tracks=40, window=8
    )
    assert res is not None and len(res.keyframes) >= 6
    # the exported observations reproject consistently with the solution
    assert res.cam_idx is not None and len(res.cam_idx) > 100
    cams6 = np.concatenate(
        [
            np.stack([_mat_to_rotvec(R) for R in res.poses]),
            res.trans,
        ],
        -1,
    )
    rmse = float(
        reprojection_rmse(
            BAProblem(
                jnp.asarray(cams6), jnp.asarray(res.points),
                jnp.asarray(res.cam_idx), jnp.asarray(res.pt_idx),
                jnp.asarray(res.obs), focal,
                baseline=jnp.asarray(res.obs_baseline),
            )
        )
    )
    assert rmse < 2.0, rmse

    # continuous IMU log of the TRUE trajectory (identity orientation)
    period = 6.0
    om = 2 * np.pi / period
    rate = 200.0
    t = np.arange(0.0, period, 1.0 / rate)
    acc = np.stack(
        [
            -0.12 * om * om * np.sin(om * t),
            0.08 * om * om * np.cos(om * t),
            np.zeros_like(t),
        ],
        -1,
    )
    kf_t = np.asarray(res.keyframes) * (period / n)
    out, info = refine_slam_with_imu(
        res, focal, t, np.zeros((len(t), 3)), acc - G_W, kf_t,
        estimate_accel_bias=False,
    )
    est = np.stack(
        [
            -_rotvec_to_mat(s[:3]).T @ np.asarray(s[3:6])
            for s in np.asarray(out.states)
        ]
    )
    true = np.asarray([centers[i] for i in res.keyframes])
    err = np.linalg.norm(est - true, axis=1)
    assert err.mean() < 0.05, (info["scale"], err)
    # the tight solve's trajectory is at metric scale (no fit): compare
    # inter-keyframe span directly
    span_est = np.linalg.norm(est[1:] - est[:-1], axis=1).sum()
    span_true = np.linalg.norm(true[1:] - true[:-1], axis=1).sum()
    assert abs(span_est / span_true - 1.0) < 0.15, (span_est, span_true)
