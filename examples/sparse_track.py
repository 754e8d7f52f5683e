#!/usr/bin/env python
"""Sparse feature tracking demo — this engine's of.cpp.

The reference demo (of.cpp:21-101) seeds 500 Shi-Tomasi corners on webcam
frames and tracks them with 31x31 / 3-level pyramidal LK, drawing tracks
red/green by x-direction. This demo runs on a video file headless and
writes a track-overlay PNG per frame.

  python examples/sparse_track.py --input /root/reference/pacman.mp4 --frames 8
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--corners", type=int, default=500)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if getattr(args, 'cpu', False):
        import jax
        jax.config.update('jax_platforms', 'cpu')

    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu.track import good_features_to_track, track_features
    from optical_flow_tpu.utils.viz import save_png

    import jax.numpy as jnp

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    prev_gray = None
    pts = valid = None
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        gray = np.asarray(bgr_to_gray(jnp.asarray(frame)))
        if prev_gray is None:
            prev_gray = gray
            pts, valid = good_features_to_track(jnp.asarray(gray), args.corners, 0.01, 10)
            print(f"frame {i}: seeded {int(np.asarray(valid).sum())} corners")
            continue
        new, status, err = track_features(prev_gray, gray, pts)
        status = np.asarray(status) & np.asarray(valid)
        moved = np.asarray(new) - np.asarray(pts)
        print(
            f"frame {i}: tracked {int(status.sum())}/{len(status)} "
            f"median |flow| {np.median(np.linalg.norm(moved[status], axis=-1)) if status.any() else 0:.2f} px"
        )
        if args.out:
            from optical_flow_tpu.utils.viz import draw_arrows

            overlay = draw_arrows(
                frame[..., ::-1], np.asarray(pts), moved, mask=status
            )
            save_png(overlay, os.path.join(args.out, f"tracks_{i:04d}.png"))
        prev_gray = gray
        pts = new
        # re-seed when too many tracks die (of.cpp:82 re-detects each frame)
        if status.sum() < args.corners // 4:
            pts, valid = good_features_to_track(jnp.asarray(gray), args.corners, 0.01, 10)
        else:
            valid = jnp.asarray(status)


if __name__ == "__main__":
    main()
