#!/usr/bin/env python
"""Live-camera gesture tracking — the reference flagship's exact loop.

The reference captures a webcam and runs preprocess -> pyramidal LK ->
gesture voting per frame (/root/reference/ParallelVideoPyr.cpp:737-905,
cv::VideoCapture(0)). This does the same against any of the framework's
live sources:

  python examples/live_gesture.py --input device:0            # V4L2 webcam
  python examples/live_gesture.py --input 0                   # same (cv2 form)
  python examples/live_gesture.py --input pipe:1280x720@30:/tmp/cam.fifo
  python examples/live_gesture.py --input video.mp4           # file fallback

Uses the per-frame push path (lowest latency; the chunked path trades
latency for dispatch amortization — see VideoPipeline.run_chunked).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="device:0",
                    help="device:N | N | /dev/videoN | pipe:WxH[@FPS]:PATH | file")
    ap.add_argument("--frames", type=int, default=100, help="stop after N frames")
    ap.add_argument("--size", type=int, default=None,
                    help="square preprocess size (default: the fast preset's)")
    ap.add_argument("--preview", type=int, default=None, metavar="PORT",
                    help="serve a live MJPEG view of the annotated frames "
                    "(the reference's imshow window) at http://host:PORT/")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from optical_flow_tpu.config import VideoConfig
    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.pipeline.video import VideoPipeline

    vc = VideoConfig.fast() if args.size is None else VideoConfig.fast(
        size=(args.size, args.size)
    )
    pipe = VideoPipeline(vc)
    preview = None
    if args.preview is not None:
        from optical_flow_tpu.io.preview import MjpegPreview

        preview = MjpegPreview(port=args.preview)
        print(f"live preview at {preview.url}", file=sys.stderr)
    t0 = time.perf_counter()
    n = 0
    pipe.reset()
    for frame in read_frames(args.input, max_frames=args.frames):
        res = pipe.push(frame)
        if res is None:
            continue
        n += 1
        g = res.gesture
        mark = "GESTURE" if bool(g.detected) else "       "
        print(
            f"frame {n:4d} {mark} votes={int(g.votes):5d} "
            f"centroid=({float(g.cx):6.1f},{float(g.cy):6.1f})",
            flush=True,
        )
        if preview is not None:
            from optical_flow_tpu.utils.viz import annotate_gesture_frame

            preview.push(
                annotate_gesture_frame(
                    frame, g, vc.preprocess.size, vc.gesture.circle_radius
                )
            )
    dt = time.perf_counter() - t0
    if n:
        print(f"{n} frames in {dt:.2f}s ({n / dt:.1f} fps wall incl. capture)")
    if preview is not None:
        preview.close()


if __name__ == "__main__":
    main()
