#!/usr/bin/env python
"""Multi-view structure-from-motion demo (the full north-star pipeline).

Renders an N-frame parallax sequence over a random depth field (or takes a
real video), then: corners -> chained sparse LK tracks -> essential-matrix
init -> PnP keyframe localization -> global Schur-complement bundle
adjustment. Prints the recovered trajectory and writes a top-down map
scatter (PNG) if --out is given.

  python examples/sfm_demo.py [--cpu] [--frames 4] [--out /tmp/sfm]
  python examples/sfm_demo.py --input video.mp4 --focal 800
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _render_sequence(n, seed=9, h=320, w=416, focal=400.0, step=0.05):
    import cv2

    rng = np.random.RandomState(seed)
    base = cv2.resize(
        rng.rand(80, 104).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC
    )
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    depth = np.clip(
        4.0 + 6.0 * cv2.resize(rng.rand(10, 13).astype(np.float32), (w, h),
                               interpolation=cv2.INTER_CUBIC), 3.0, 12.0
    )
    frames = [base]
    for k in range(1, n):
        disp = focal * step * k / depth
        frames.append(
            cv2.remap(base, xs + disp, ys, cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REFLECT_101)
        )
    return frames, focal


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None, help="video file (default: rendered synthetic)")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--focal", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from optical_flow_tpu.slam.frontend import multi_view_reconstruct

    if args.input:
        from optical_flow_tpu.io.video_reader import read_frames
        from optical_flow_tpu.pipeline.preprocess import bgr_to_gray

        frames = [
            np.asarray(bgr_to_gray(jnp.asarray(f)))
            for f in read_frames(args.input, max_frames=args.frames)
        ]
        if not frames:
            sys.exit(f"no frames decoded from {args.input}")
        focal = args.focal or 0.9 * frames[0].shape[1]
    else:
        frames, focal = _render_sequence(args.frames)
        focal = args.focal or focal

    if len(frames) < 3:
        sys.exit(f"need at least 3 frames, got {len(frames)}")
    rec = multi_view_reconstruct(frames, focal)
    if rec is None:
        sys.exit("reconstruction failed: too few surviving tracks")
    print(f"{len(frames)} frames, {len(rec.points)} map points")
    print(f"reprojection RMSE: {rec.rmse_before:.3f} -> {rec.rmse_after:.3f} px")
    for i, cam in enumerate(rec.cams):
        print(
            f"cam {i}: rot |{np.linalg.norm(cam[:3]):.4f}| rad, "
            f"t = ({cam[3]:+.3f}, {cam[4]:+.3f}, {cam[5]:+.3f})"
        )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        # top-down (x, z) map scatter rendered as a PNG heat grid
        pts = rec.points
        H = W = 256
        img = np.zeros((H, W), np.float32)
        xlo, xhi = np.percentile(pts[:, 0], [2, 98])
        zlo, zhi = np.percentile(pts[:, 2], [2, 98])
        xi = np.clip(((pts[:, 0] - xlo) / max(xhi - xlo, 1e-9) * (W - 1)), 0, W - 1).astype(int)
        zi = np.clip(((pts[:, 2] - zlo) / max(zhi - zlo, 1e-9) * (H - 1)), 0, H - 1).astype(int)
        img[H - 1 - zi, xi] = 1.0
        from optical_flow_tpu.utils.viz import save_png

        save_png((np.stack([img] * 3, -1) * 255).astype(np.uint8),
                 os.path.join(args.out, "map_topdown.png"))
        print(f"wrote {args.out}/map_topdown.png")


if __name__ == "__main__":
    main()
