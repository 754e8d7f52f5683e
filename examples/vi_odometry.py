#!/usr/bin/env python
"""Tightly-coupled visual-inertial refinement: metric scale from an IMU.

A monocular SLAM solution is defined only up to scale — and on top of
that, real IMUs carry gyro/accel biases that corrupt naive integration.
This demo builds an up-to-scale visual solution of a known trajectory,
injects realistic sensor biases into its IMU log, and runs the full
tightly-coupled pipeline (`slam.vi_ba.refine_with_imu`):

  1. gyro bias from the bias-free visual rotations (Gauss-Newton),
  2. the linear VI alignment with accel-bias columns + |g| refinement
     -> scale, gravity, velocities,
  3. metric rescale, then JOINT visual-inertial bundle adjustment:
     9-DOF states (pose + velocity), reprojection AND preintegration
     factors through the same sparse-Schur machinery as `slam/ba.py`.

Prints the recovered scale/biases and the absolute (metric!) trajectory
error before and after the joint refinement — no oracle scale fit
anywhere.

With --bias-drift, the injected gyro bias WALKS over the log (real MEMS
behavior): the frozen-bias 9-DOF solve visibly degrades while
`bias_states=True` (15-DOF states with per-keyframe bias deltas +
random-walk factors) tracks the walk and recovers — both are printed
for comparison.

  python examples/vi_odometry.py [--scale 3.0] [--bias-drift] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=3.0,
                    help="true metric scale of the visual solution")
    ap.add_argument("--vis-noise", type=float, default=1.0,
                    help="visual-solution noise level (x the default)")
    ap.add_argument("--bias-drift", action="store_true",
                    help="let the gyro bias WALK over the log and compare "
                    "frozen-bias vs bias-state (15-DOF) refinement")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    from test_vi_ba import _make_scene, _scale_of

    from optical_flow_tpu.slam.vi_ba import refine_with_imu

    sc = _make_scene()
    s_true = args.scale
    bg = np.asarray([0.01, -0.008, 0.012])  # rad/s
    ba = np.asarray([0.08, -0.05, 0.10])  # m/s^2

    # a REALISTIC visual solution: small pose/point errors (as windowed BA
    # on noisy tracks would leave) on top of the unknown global scale
    rng = np.random.RandomState(11)
    nz = args.vis_noise
    import cv2

    poses_n = np.stack(
        [
            cv2.Rodrigues(
                cv2.Rodrigues(R)[0].ravel() + rng.randn(3) * 2e-3 * nz
            )[0]
            for R in sc["poses"]
        ]
    )
    trans_n = sc["trans"] / s_true + rng.randn(*sc["trans"].shape) * 2e-3 * nz
    X_n = sc["X"] / s_true + rng.randn(*sc["X"].shape) * 3e-3 * nz

    gyro_log = sc["gyro"] + bg
    if args.bias_drift:
        # bias walk: b(t) = bg + slope*t (a linear stand-in; see
        # tests/test_vi_ba_bias_states.py)
        slope = np.asarray([0.016, -0.012, 0.014])
        h = sc["dt"][0, 0]
        t = (sc["kf_t"][:-1][:, None]
             + np.arange(sc["dt"].shape[1])[None, :] * h)[..., None]
        gyro_log = gyro_log + slope * t

    out, info = refine_with_imu(
        poses_n, trans_n, X_n,
        sc["cam_idx"], sc["pt_idx"], sc["obs"], 500.0,
        gyro_log, sc["accel"] + ba, sc["dt"], iters=12,
    )
    if args.bias_drift:
        out_b, info_b = refine_with_imu(
            poses_n, trans_n, X_n,
            sc["cam_idx"], sc["pt_idx"], sc["obs"], 500.0,
            gyro_log, sc["accel"] + ba, sc["dt"], iters=12,
            bias_states=True, bias_rw_weight=(1e2, 1e2),
        )
    scale, est = _scale_of(np.asarray(out.states), sc)
    err = np.linalg.norm(est - sc["centers"], axis=1)
    # alignment-only metric trajectory: the NOISY visual centers x scale
    cen_n = np.stack([-R.T @ t for R, t in zip(poses_n, trans_n)])
    init_err = np.linalg.norm(cen_n * info["scale"] - sc["centers"], axis=1)
    print(f"true metric scale        : {s_true:.3f}")
    print(f"alignment-recovered scale: {info['scale']:.3f}")
    print(f"gyro bias  true/est      : {bg} / {info['gyro_bias'].round(4)}")
    print(f"accel bias true/est      : {ba} / {info['accel_bias'].round(3)}")
    print(f"gravity (world)          : {info['gravity'].round(3)}")
    print(f"mean |center err| metric : align-only {init_err.mean():.4f} m"
          f" -> joint VI-BA {err.mean():.4f} m")
    print(f"final trajectory scale   : {scale:.4f} (1.0 = metric)")
    if args.bias_drift:
        _, est_b = _scale_of(np.asarray(out_b.states), sc)
        err_b = np.linalg.norm(est_b - sc["centers"], axis=1)
        walk = (info_b["gyro_bias_per_kf"][-1]
                - info_b["gyro_bias_per_kf"][0])
        print()
        print("-- gyro bias walks over the log --")
        print(f"frozen-bias (9-DOF)  err : {err.mean():.4f} m")
        print(f"bias-state (15-DOF)  err : {err_b.mean():.4f} m")
        print(f"solved bias walk         : {walk.round(4)} rad/s "
              f"(true {tuple(slope)} x {sc['kf_t'][-1]:.1f}s)")


if __name__ == "__main__":
    main()
