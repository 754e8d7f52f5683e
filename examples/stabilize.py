#!/usr/bin/env python
"""Video stabilization — tracks + homographies + inverse warps.

A capability demo composed entirely from engine pieces: Shi-Tomasi
corners -> sparse pyramidal LK -> RANSAC homography per frame pair ->
accumulated motion -> each frame warped back toward the first frame's
coordinates with the engine's remap.

  python examples/stabilize.py --input video.mp4 --frames 30 --out /tmp/stab
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--corners", type=int, default=300)
    ap.add_argument("--out", default=None, help="write stabilized PNGs here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if getattr(args, 'cpu', False):
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax.numpy as jnp

    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.ops.warp import remap_bilinear
    from optical_flow_tpu.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu.track import good_features_to_track, track_features
    from optical_flow_tpu.track.pose import estimate_homography
    from optical_flow_tpu.utils.viz import save_png

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    H_acc = np.eye(3)
    prev_gray = None
    jitter = []
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        gray = np.asarray(bgr_to_gray(jnp.asarray(frame)))
        h, w = gray.shape
        if prev_gray is not None:
            pts, valid = good_features_to_track(
                jnp.asarray(prev_gray), args.corners, 0.01, 8
            )
            new, status, _ = track_features(prev_gray, gray, np.asarray(pts))
            ok = np.asarray(status) & np.asarray(valid)
            if ok.sum() >= 8:
                Hf, _, _ = estimate_homography(np.asarray(pts), np.asarray(new), ok)
                H_acc = np.asarray(Hf, np.float64) @ H_acc
        prev_gray = gray

        # inverse-warp the frame toward frame 0: sample at H_acc applied to
        # the output grid (maps output pixels back into this frame)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        ones = np.ones_like(xs)
        coords = np.stack([xs, ys, ones], axis=0).reshape(3, -1)
        mapped = H_acc @ coords
        mx = (mapped[0] / mapped[2]).reshape(h, w).astype(np.float32)
        my = (mapped[1] / mapped[2]).reshape(h, w).astype(np.float32)
        # one dispatch for all three channels: remap_bilinear accepts
        # leading axes (the per-channel loop tripled dispatch + transfer)
        stab_chw = np.asarray(
            remap_bilinear(
                jnp.asarray(np.ascontiguousarray(frame.transpose(2, 0, 1))),
                jnp.asarray(mx), jnp.asarray(my),
            )
        )
        stab = stab_chw.transpose(1, 2, 0)
        jitter.append((H_acc[0, 2], H_acc[1, 2]))
        print(
            f"frame {i}: cumulative motion ({H_acc[0,2]:+7.2f}, {H_acc[1,2]:+7.2f}) px"
        )
        if args.out:
            save_png(stab[..., ::-1], os.path.join(args.out, f"stab_{i:04d}.png"))
    if jitter:
        j = np.asarray(jitter)
        print(
            f"motion range stabilized: x [{j[:,0].min():.1f}, {j[:,0].max():.1f}] "
            f"y [{j[:,1].min():.1f}, {j[:,1].max():.1f}] px over {len(j)} frames"
        )


if __name__ == "__main__":
    main()
