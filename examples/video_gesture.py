#!/usr/bin/env python
"""Video gesture tracking demo — this engine's ParallelVideoPyr.

The reference flagship (ParallelVideoPyr.cpp:730-905) captures a webcam,
preprocesses each frame, runs 4-level pyramidal LK on consecutive diffs,
and draws a circle at the motion centroid. This demo runs the same pipeline
on a video file (headless: writes PNG dumps instead of imshow) with
per-frame timing like the reference's printf timers.

  python examples/video_gesture.py --input /root/reference/pacman.mp4 \
      --frames 8 --out /tmp/gesture_out
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=256, help="square preprocess size (reference: 1080)")
    ap.add_argument("--out", default=None, help="directory for flow/overlay PNG dumps")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if getattr(args, 'cpu', False):
        import jax
        jax.config.update('jax_platforms', 'cpu')

    from optical_flow_tpu.config import PreprocessConfig, VideoConfig
    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.pipeline import VideoPipeline
    from optical_flow_tpu.utils.viz import flow_to_color, save_png

    cfg = VideoConfig(preprocess=PreprocessConfig(size=(args.size, args.size)))
    pipe = VideoPipeline(cfg)

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    frames = list(read_frames(args.input, max_frames=args.frames))
    print(f"{len(frames)} frames from {args.input}")
    n = 0
    for i, res in enumerate(pipe.run(iter(frames))):
        t0 = time.perf_counter()
        u = np.asarray(res.u)
        v = np.asarray(res.v)
        g = res.gesture
        dt = time.perf_counter() - t0
        detected = bool(g.detected)
        print(
            f"frame {i}: votes={int(g.votes)} detected={detected} "
            f"centroid=({float(g.cx):.1f},{float(g.cy):.1f}) "
            f"host-sync {dt*1e3:.1f} ms"
        )
        if args.out:
            save_png(flow_to_color(u, v), os.path.join(args.out, f"flow_{i:04d}.png"))
            if detected:
                from optical_flow_tpu.utils.viz import annotate_gesture_frame

                overlay = annotate_gesture_frame(
                    frames[i + 2], g, (args.size, args.size),
                    cfg.gesture.circle_radius,
                )
                save_png(overlay, os.path.join(args.out, f"detect_{i:04d}.png"))
        n += 1
    print(f"processed {n} flow frames")


if __name__ == "__main__":
    main()
