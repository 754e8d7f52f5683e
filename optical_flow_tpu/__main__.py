"""Command-line interface: python -m optical_flow_tpu <command>.

The reference has no CLI — each variant is a hardcoded main() recompiled by
hand (SURVEY.md section 2, C19). Subcommands map to those mains:

  flow     dense flow between two images  (serialOrig / SerialPyr mains)
  video    video gesture tracking         (ParallelVideoPyr main)
  track    sparse feature tracking        (of.cpp main)
  bench    the headline benchmark         (the reference's printf timers)
"""

from __future__ import annotations

import argparse
import sys


def _cmd_flow(args):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from optical_flow_tpu import FlowConfig, coarse_to_fine, lucas_kanade
    from optical_flow_tpu.utils.goldens import save_mat
    from optical_flow_tpu.utils.images import imread_gray
    from optical_flow_tpu.utils.viz import flow_to_color, save_png

    img1 = imread_gray(args.image1).astype(np.float32) / 255.0
    img2 = imread_gray(args.image2).astype(np.float32) / 255.0
    a, b = jnp.asarray(img1), jnp.asarray(img2)
    cfg = FlowConfig(levels=args.levels)
    if args.single_level:
        u, v = jax.jit(lucas_kanade)(a, b)
    else:
        u, v = jax.jit(lambda x, y: coarse_to_fine(x, y, config=cfg))(a, b)
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    mag = np.sqrt(u * u + v * v)
    print(f"flow {u.shape[1]}x{u.shape[0]}: mean |flow| {mag.mean():.4f} px, max {mag.max():.4f} px")
    if args.out_prefix:
        save_mat(u, args.out_prefix + "_u.txt")
        save_mat(v, args.out_prefix + "_v.txt")
        save_png(flow_to_color(u, v), args.out_prefix + "_flow.png")
        print(f"wrote {args.out_prefix}_{{u,v}}.txt and _flow.png")
    if args.flo:
        from optical_flow_tpu.utils.interop import save_flo

        save_flo(args.flo, u, v)
        print(f"wrote {args.flo} (Middlebury .flo)")


def _run_video(args):
    import sys as _sys

    from optical_flow_tpu.config import PreprocessConfig, VideoConfig
    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.pipeline import VideoPipeline
    from optical_flow_tpu.utils.guard import FlowGuard, NumericalFailure
    from optical_flow_tpu.utils.metrics import Metrics

    if args.gray_decode and args.annotate:
        # validate BEFORE any side effects (VideoWriter mkdirs its output)
        _sys.exit("--gray-decode and --annotate are mutually exclusive "
                  "(the overlay draws on the original BGR frame)")
    if args.fast:
        cfg = VideoConfig.fast(size=(args.size, args.size))
    else:
        cfg = VideoConfig(preprocess=PreprocessConfig(size=(args.size, args.size)))
    pipe = VideoPipeline(cfg)
    # generous: the first frame includes XLA compilation (minutes at 1080^2)
    guard = FlowGuard(stall_timeout_s=600.0)
    stop_watchdog = guard.start_watchdog()
    metrics = Metrics(sink=_sys.stderr if args.metrics else None)
    writer = None
    if args.annotate:
        from optical_flow_tpu.io.video_writer import VideoWriter

        writer = VideoWriter(args.annotate, fps=args.fps)
    preview = None
    if args.preview is not None:
        # live view (the reference's imshow surface, headless-native):
        # browser-watchable MJPEG stream of the annotated frames
        from optical_flow_tpu.io.preview import MjpegPreview

        preview = MjpegPreview(port=args.preview)
        print(f"live preview at {preview.url}", file=_sys.stderr)
    # push() frame by frame (instead of pipe.run) so each result can be
    # drawn onto ITS original frame — the reference's live overlay
    # (ParallelVideoPyr.cpp:884-891: centroid rescaled to frame coords,
    # radius-35 circle, shown per frame).
    gray_decode = args.gray_decode
    pipe.reset()
    i = -1
    for frame in read_frames(
        args.input, max_frames=args.frames, gray=gray_decode
    ):
        res = pipe.push(frame)
        if res is None:
            continue
        i += 1
        with metrics.timer("frame"):
            g = res.gesture
            try:
                guard.check(res.u, res.v, context=f"frame {i}")
            except NumericalFailure as e:
                print(f"frame {i}: GUARD TRIPPED: {e}")
                metrics.count("guard_trips")
                continue
            metrics.count("frames")
            if bool(g.detected):
                metrics.count("detections")
            print(
                f"frame {i}: votes={int(g.votes)} detected={bool(g.detected)} "
                f"centroid=({float(g.cx):.1f},{float(g.cy):.1f})"
            )
            if writer is not None or preview is not None:
                from optical_flow_tpu.utils.viz import annotate_gesture_frame

                rgb = annotate_gesture_frame(
                    frame, g, cfg.preprocess.size, cfg.gesture.circle_radius
                )
                if writer is not None:
                    writer.write(rgb)
                if preview is not None:
                    preview.push(rgb)
    if writer is not None:
        writer.close()
        print(f"wrote {writer.frames_written} annotated frames to {args.annotate}")
    if preview is not None:
        preview.close()
    stop_watchdog()
    metrics.emit()


def _cmd_track(args):
    import numpy as np
    import jax.numpy as jnp

    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu.track import good_features_to_track, track_features

    prev = None
    pts = None
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        gray = np.asarray(bgr_to_gray(jnp.asarray(frame)))
        if prev is None:
            prev = gray
            pts, valid = good_features_to_track(jnp.asarray(gray), args.corners, 0.01, 10)
            print(f"frame {i}: seeded {int(np.asarray(valid).sum())} corners")
            continue
        new, status, err = track_features(prev, gray, pts)
        ok = np.asarray(status)
        print(f"frame {i}: tracked {int(ok.sum())}/{len(ok)}")
        prev, pts = gray, new


def _cmd_serve(args):
    from optical_flow_tpu.pipeline.serve import FlowServer

    srv = FlowServer(host=args.host, port=args.port, unix_path=args.unix)
    print(f"serving flow/gesture streams on {srv.address}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


def _cmd_slam(args):
    import numpy as np
    import jax.numpy as jnp

    from optical_flow_tpu.io.video_reader import read_frames
    from optical_flow_tpu.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu.slam import incremental_slam

    import itertools

    sbs_baseline = getattr(args, "stereo_sbs", None)
    if sbs_baseline is not None:
        # side-by-side stereo video: each frame is (left|right); the map
        # comes out METRIC in the units the baseline is given in
        from optical_flow_tpu.slam.stereo import split_sbs

        gray_iter = (
            split_sbs(np.asarray(bgr_to_gray(jnp.asarray(f))))
            for f in read_frames(
                args.input, max_frames=args.frames, stride=args.stride
            )
        )
    else:
        gray_iter = (
            np.asarray(bgr_to_gray(jnp.asarray(f)))
            for f in read_frames(
                args.input, max_frames=args.frames, stride=args.stride
            )
        )
    # peek one frame for the focal default, then STREAM the rest into the
    # pipeline (incremental_slam retains only keyframe frames — memory is
    # O(keyframes), so long videos don't need to fit in host RAM)
    try:
        first = next(gray_iter)
    except StopIteration:
        sys.exit("need at least 2 decodable frames")
    h, w = (first[0] if sbs_baseline is not None else first).shape
    focal = args.focal if args.focal else 0.8 * w  # plausible default FOV
    try:
        res = incremental_slam(
            itertools.chain([first], gray_iter), focal,
            window=args.window, max_corners=args.corners,
            kf_min_disparity=args.kf_disparity,
            stereo_baseline=sbs_baseline,
        )
    except ValueError as e:
        sys.exit(str(e))
    if res is None:
        sys.exit("bootstrap failed (not enough parallax or tracks)")
    centers = res.centers()
    print(
        f"keyframes {len(res.keyframes)} (last frame {res.keyframes[-1]}) "
        f"map points "
        f"{res.points.shape[0]} BA rmse {res.rmse:.2f}px "
        f"loop edges {len(res.loop_edges)}"
    )
    for i, (kf, c) in enumerate(zip(res.keyframes, centers)):
        print(f"  kf {i} (frame {kf}): center {np.round(c, 4)}")
    if getattr(args, "imu", None):
        # tightly-coupled VI refinement: continuous IMU log (.npz with
        # t (N,), gyro (N,3) rad/s, accel (N,3) m/s^2, body==camera) ->
        # metric trajectory (slam/vi_ba.refine_slam_with_imu)
        import cv2

        from optical_flow_tpu.slam import refine_slam_with_imu

        try:
            log = np.load(args.imu)
            kf_t = (
                np.asarray(res.keyframes, np.float64)
                * args.stride / args.video_fps
            )
            out, info = refine_slam_with_imu(
                res, focal, log["t"], log["gyro"], log["accel"], kf_t,
                estimate_accel_bias=not args.no_accel_bias,
                bias_states=args.imu_bias_states,
            )
        except KeyError as e:
            sys.exit(f"--imu log missing array {e} (need t, gyro, accel)")
        except ValueError as e:
            sys.exit(f"--imu refinement failed: {e} "
                     "(check --video-fps covers the log's time span)")
        states = np.asarray(out.states)
        res.poses = np.stack([cv2.Rodrigues(s[:3])[0] for s in states])
        res.trans = states[:, 3:6].copy()
        res.points = np.asarray(out.points)
        centers = res.centers()
        print(
            f"VI refinement: scale {info['scale']:.4f} "
            f"gyro bias {np.round(info['gyro_bias'], 4)} "
            f"accel bias {np.round(info['accel_bias'], 3)} "
            f"gravity {np.round(info['gravity'], 3)}"
        )
        if "gyro_bias_per_kf" in info:
            drift = info["gyro_bias_per_kf"][-1] - info["gyro_bias_per_kf"][0]
            print(
                f"  bias states: gyro walked {np.round(drift, 4)} rad/s "
                f"over {len(info['gyro_bias_per_kf'])} keyframes"
            )
        for i, (kf, c) in enumerate(zip(res.keyframes, centers)):
            print(f"  kf {i} (frame {kf}): METRIC center {np.round(c, 4)}")
    if args.out:
        np.savez(
            args.out, poses=res.poses, trans=res.trans, points=res.points,
            keyframes=np.asarray(res.keyframes),
        )
        print(f"wrote trajectory + map to {args.out}")
    if args.out_tum:
        from optical_flow_tpu.utils.interop import save_tum_trajectory

        kf_ts = (
            np.asarray(res.keyframes, np.float64)
            * args.stride / args.video_fps
        )
        save_tum_trajectory(args.out_tum, kf_ts, res.poses, res.trans)
        print(f"wrote TUM trajectory to {args.out_tum} "
              f"(evaluate with e.g. `evo_traj tum {args.out_tum}`)")
    if args.eval_tum:
        from optical_flow_tpu.utils.interop import (
            associate_by_timestamp,
            ate_rmse,
            load_tum_trajectory,
            rpe_stats,
        )

        kf_ts = (
            np.asarray(res.keyframes, np.float64)
            * args.stride / args.video_fps
        )
        rts, rposes, rtrans = load_tum_trajectory(args.eval_tum)
        ia, ib = associate_by_timestamp(kf_ts, rts, max_diff=0.5 / args.video_fps)
        if len(ia) < 3:
            sys.exit(f"--eval-tum: only {len(ia)} timestamp matches "
                     "(check --video-fps/--stride against the reference)")
        est_c = centers[ia]
        ref_c = np.stack([-R.T @ t for R, t in zip(rposes[ib], rtrans[ib])])
        align = "se3" if (args.stereo_sbs or args.imu) else "sim3"
        rmse, err, _ = ate_rmse(est_c, ref_c, align=align)
        rpe = rpe_stats(res.poses[ia], res.trans[ia], rposes[ib], rtrans[ib])
        print(
            f"eval vs {args.eval_tum}: {len(ia)} poses matched | "
            f"ATE({align}) rmse {rmse:.4f} (max {err.max():.4f}) | "
            f"RPE trans {rpe['trans_rmse']:.4f} "
            f"rot {np.degrees(rpe['rot_rmse_rad']):.3f} deg/step"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="optical_flow_tpu")
    ap.add_argument(
        "--cpu", action="store_true", help="run on the CPU backend instead "
        "of the GPU"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("flow", help="dense optical flow between two images")
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--single-level", action="store_true")
    p.add_argument("--out-prefix", default=None)
    p.add_argument(
        "--flo", default=None, metavar="OUT.flo",
        help="also write the flow as Middlebury .flo (the interchange "
        "format of the dense-flow benchmarks; utils/interop.py)",
    )
    p.set_defaults(fn=_cmd_flow)

    p = sub.add_parser("video", help="video gesture tracking")
    p.add_argument("--input", required=True, help="video file, camera (0 / device:0 / /dev/video0) or pipe:WxH[@FPS]:PATH")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--metrics", action="store_true", help="emit JSONL metrics to stderr")
    p.add_argument(
        "--fast",
        action="store_true",
        help="production preset: displacement-true flow + clamped warp "
        "(parity quirks off; see VideoConfig.fast)",
    )
    p.add_argument(
        "--annotate",
        default=None,
        metavar="OUT",
        help="write an annotated output video (detection circle drawn on "
        "each live frame, the reference's imshow overlay) to OUT.mp4, or "
        "to a PNG directory if OUT has no extension",
    )
    p.add_argument("--fps", type=float, default=30.0, help="annotated output fps")
    p.add_argument(
        "--preview",
        type=int,
        default=None,
        metavar="PORT",
        help="serve a live MJPEG preview of the annotated frames at "
        "http://host:PORT/ (the reference's imshow window, headless-"
        "native: watch from any browser or ffplay; 0 = ephemeral port). "
        "Non-blocking — a slow or absent viewer never stalls the "
        "pipeline (io/preview.py)",
    )
    p.add_argument(
        "--gray-decode",
        action="store_true",
        help="decode to GRAY8 (libswscale BT.601 luma) instead of BGR — a "
        "third of the bytes cross host->device, the measured host-loop "
        "bottleneck (bench.py h2d legs). Gray-first consumers (--fast) "
        "lose only decode-time uint8 luma rounding vs the float path; "
        "incompatible with --annotate (the overlay needs BGR frames)",
    )
    p.set_defaults(fn=_run_video)

    p = sub.add_parser("track", help="sparse feature tracking")
    p.add_argument("--input", required=True)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--corners", type=int, default=500)
    p.set_defaults(fn=_cmd_track)

    p = sub.add_parser(
        "slam",
        help="incremental SLAM over a video (tracks -> keyframes -> "
        "windowed BA -> loop closure -> pose graph)",
    )
    p.add_argument("--input", required=True)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--focal", type=float, default=None,
                   help="focal length in px (default: 0.8 * width)")
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--corners", type=int, default=300)
    p.add_argument("--kf-disparity", type=float, default=6.0,
                   help="adaptive keyframe selection: median track "
                   "disparity (px) a frame must add since the last "
                   "keyframe (0 = keyframe every frame)")
    p.add_argument("--out", default=None, help="write poses+map to OUT.npz")
    p.add_argument(
        "--out-tum", default=None, metavar="TRAJ.txt",
        help="write the keyframe trajectory in TUM format (timestamp + "
        "camera-to-world pose per line; keyframes timestamped from "
        "--video-fps/--stride) for evo/TUM evaluation tooling",
    )
    p.add_argument(
        "--eval-tum", default=None, metavar="REF.txt",
        help="evaluate against a TUM-format reference trajectory: "
        "nearest-timestamp association, then ATE (Sim3-aligned for "
        "monocular, SE3 for stereo/--imu metric runs) and per-step RPE "
        "(utils/interop.py)",
    )
    p.add_argument(
        "--stereo-sbs", type=float, default=None, metavar="BASELINE",
        help="treat the video as side-by-side rectified stereo (left|"
        "right) with this rig baseline; trajectory and map come out "
        "METRIC in the baseline's units (slam/stereo.py)",
    )
    p.add_argument(
        "--imu", default=None, metavar="LOG.npz",
        help="tightly-coupled VI refinement from a continuous IMU log "
        "(.npz with t (N,), gyro (N,3) rad/s, accel (N,3) m/s^2, body=="
        "camera frame): bias estimation -> linear alignment -> joint "
        "VI-BA; trajectory and map come out METRIC (slam/vi_ba.py)",
    )
    p.add_argument(
        "--video-fps", type=float, default=30.0,
        help="capture frame rate, used to timestamp keyframes against "
        "the IMU log's t axis (with --imu)",
    )
    p.add_argument(
        "--no-accel-bias", action="store_true",
        help="skip accel-bias estimation (rotation-poor logs: accel bias "
        "is separable from gravity only under rotation-axis variety)",
    )
    p.add_argument(
        "--imu-bias-states", action="store_true",
        help="carry per-keyframe bias states (15-DOF) through the joint "
        "VI-BA with random-walk coupling — for logs long enough that "
        "the biases drift past a single constant estimate (vi_ba.py)",
    )
    p.set_defaults(fn=_cmd_slam)

    p = sub.add_parser(
        "serve",
        help="long-running flow/gesture server: keeps compiled pipelines "
        "hot and answers frame streams over TCP or a Unix socket "
        "(pipeline/serve.py wire protocol)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--unix", default=None, metavar="PATH",
                   help="serve on a Unix-domain socket instead of TCP")
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser(
        "bench",
        help="run the headline benchmark (remaining args pass through to bench.py)",
    )
    p.set_defaults(fn=None)

    args, extra = ap.parse_known_args(argv)
    if args.cmd != "bench" and extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif args.cmd != "bench" and jax.default_backend() != "gpu":
        # no silent CPU fallback: a CPU run must be asked for
        ap.error("JAX found no GPU; pass --cpu to run on the CPU backend")
    from optical_flow_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    if args.cmd == "bench":
        import runpy
        from pathlib import Path

        bench_path = Path(__file__).parent.parent / "bench.py"
        if not bench_path.exists():
            sys.exit(
                "bench.py is a repo-level harness and is not shipped in the "
                "installed package; run it from a source checkout"
            )
        sys.argv = ["bench.py", *extra]
        runpy.run_path(str(bench_path), run_name="__main__")
        return
    args.fn(args)


if __name__ == "__main__":
    main()
