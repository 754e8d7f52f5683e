#!/usr/bin/env python
"""Loop-closure demo: drift accumulates along an odometry chain; place
recognition finds the revisit; pose-graph optimization closes the loop.

A camera circles a synthetic textured wall: frames are rendered with real
parallax (depth-dependent disparity), consecutive pairs give essential-
matrix odometry (accumulating drift), the thumbnail place index flags the
first/last revisit pair, geometric verification (sparse-LK matches +
essential RANSAC + Gauss-Newton LO) measures the loop edge, and the
pose graph distributes the drift. Prints endpoint error before/after.

  python examples/loop_closure.py [--frames 12] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def render_loop_frames(n_frames, h=320, w=416, focal=400.0, seed=11):
    """Camera translating around a small closed loop in front of a rocky
    depth field; frame i is the wall remapped by its per-pixel disparity."""
    import cv2

    rng = np.random.RandomState(seed)
    base = cv2.resize(
        rng.rand(80, 104).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC
    )
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    depth = np.clip(
        4.0 + 6.0 * cv2.resize(rng.rand(10, 13).astype(np.float32), (w, h),
                               interpolation=cv2.INTER_CUBIC), 3.0, 12.0
    )
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    inv = focal / depth
    frames, centers = [], []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        cx_w = 0.12 * np.sin(th)  # camera center, world units
        cy_w = 0.08 * (1 - np.cos(th))
        frames.append(
            cv2.remap(base, (xs + cx_w * inv).astype(np.float32),
                      (ys + cy_w * inv).astype(np.float32), cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REFLECT_101)
        )
        centers.append((cx_w, cy_w, 0.0))
    return frames, np.asarray(centers), focal


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from optical_flow_tpu.slam import (
        EssentialRansacConfig,
        PoseGraph,
        estimate_essential,
        normalize_pixels,
        propose_loop_candidates,
        recover_pose,
        refine_pose,
        thumbnail_descriptor,
        verify_loop_closure,
    )
    from optical_flow_tpu.track.features import good_features_to_track
    from optical_flow_tpu.track.sparse_lk import track_features

    frames, centers, focal = render_loop_frames(args.frames)
    h, w = frames[0].shape
    cx, cy = w / 2.0, h / 2.0

    # --- odometry chain: essential matrix per consecutive pair ------------
    import jax.numpy as jnp

    Rs = [np.eye(3, dtype=np.float32)]
    ts = [np.zeros(3, np.float32)]
    step_scale = None
    for i in range(len(frames) - 1):
        pts, valid = good_features_to_track(jnp.asarray(frames[i]), 300, 0.01, 8)
        new, status, _ = track_features(frames[i], frames[i + 1], pts)
        ok = np.asarray(valid) & np.asarray(status)
        p1 = np.asarray(normalize_pixels(np.asarray(pts), focal, cx, cy))
        p2 = np.asarray(normalize_pixels(np.asarray(new), focal, cx, cy))
        E, inl, n = estimate_essential(p1, p2, valid=ok,
                                       config=EssentialRansacConfig(seed=i))
        inl_np = np.asarray(inl)
        R0, t0, _ = recover_pose(E, jnp.asarray(p1)[inl_np], jnp.asarray(p2)[inl_np])
        R1, t1, _ = refine_pose(R0, t0, p1, p2, inliers=inl_np)
        R1, t1 = np.asarray(R1), np.asarray(t1)
        # monocular scale: fix the first step's ground-truth length, reuse
        # it for every step (the loop is near-uniform speed)
        true_len = np.linalg.norm(centers[i + 1] - centers[i])
        if step_scale is None:
            step_scale = true_len
        t1 = t1 * step_scale
        Rs.append((R1 @ Rs[-1]).astype(np.float32))
        ts.append((R1 @ ts[-1] + t1).astype(np.float32))
        print(f"odometry {i}->{i+1}: {int(n)} inliers")
    Rs, ts = np.stack(Rs), np.stack(ts)

    def center_of(R, t):
        return -R.T @ t

    end_err0 = np.linalg.norm(center_of(Rs[-1], ts[-1]) - centers[-1])

    # --- place recognition + loop verification -----------------------------
    descs = [thumbnail_descriptor(f) for f in frames]
    cands = propose_loop_candidates(descs, min_separation=max(3, args.frames - 3))
    print("loop candidates:", [(i, j, round(d, 3)) for i, j, d in cands[:3]])
    graph = PoseGraph.from_odometry(Rs, ts)
    added = 0
    for i, j, _ in cands[:2]:
        got = verify_loop_closure(frames[i], frames[j], focal, cx, cy,
                                  min_inliers=25)
        if got is None:
            continue
        R_ij, t_ij, n = got
        # scale the unit loop translation from the ground-truth revisit gap
        gap = np.linalg.norm(centers[j] - centers[i])
        graph.add_edge(i, j, R_ij, t_ij * gap, weight=4.0)
        added += 1
        print(f"loop edge {i}->{j}: {n} inliers")
    if added == 0:
        print("no loop edge verified; exiting")
        return 1

    Rn, tn = graph.optimize()
    end_err1 = np.linalg.norm(center_of(Rn[-1], tn[-1]) - centers[-1])
    mean0 = np.mean([np.linalg.norm(center_of(R, t) - c)
                     for R, t, c in zip(Rs, ts, centers)])
    mean1 = np.mean([np.linalg.norm(center_of(R, t) - c)
                     for R, t, c in zip(Rn, tn, centers)])
    print(f"endpoint error: {end_err0:.4f} -> {end_err1:.4f} (world units)")
    print(f"mean center error: {mean0:.4f} -> {mean1:.4f}")
    return 0 if end_err1 <= end_err0 else 2


if __name__ == "__main__":
    sys.exit(main())
