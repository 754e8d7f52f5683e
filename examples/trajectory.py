#!/usr/bin/env python
"""Camera-motion trajectory from a video — tracks + RANSAC homographies.

The north-star pipeline slice (SURVEY.md section 7.7): Shi-Tomasi corners
-> pyramidal sparse LK tracks -> per-frame-pair RANSAC homography ->
cumulative trajectory of the inter-frame translation.

  python examples/trajectory.py --input /root/reference/pacman.mp4 --frames 10
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--corners", type=int, default=300)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if getattr(args, 'cpu', False):
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax.numpy as jnp

    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu.track import good_features_to_track, track_features
    from optical_flow_tpu.track.pose import estimate_homography

    prev = None
    pts = valid = None
    tx = ty = 0.0
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        gray = np.asarray(bgr_to_gray(jnp.asarray(frame)))
        if prev is None:
            prev = gray
            pts, valid = good_features_to_track(jnp.asarray(gray), args.corners, 0.01, 8)
            continue
        new, status, _ = track_features(prev, gray, pts)
        ok = np.asarray(status) & np.asarray(valid)
        if ok.sum() >= 8:
            H, inl, count = estimate_homography(
                np.asarray(pts), np.asarray(new), ok
            )
            H = np.asarray(H)
            tx += H[0, 2]
            ty += H[1, 2]
            print(
                f"frame {i}: {int(count)}/{int(ok.sum())} inliers  "
                f"dt=({H[0,2]:+.2f},{H[1,2]:+.2f})  cumulative=({tx:+.1f},{ty:+.1f})"
            )
        else:
            print(f"frame {i}: too few tracks ({int(ok.sum())}); skipping pose")
        prev = gray
        pts, valid = good_features_to_track(jnp.asarray(gray), args.corners, 0.01, 8)


if __name__ == "__main__":
    main()
