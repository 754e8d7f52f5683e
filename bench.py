"""Headline benchmark: dense pyramidal Lucas-Kanade flow at 1080x1080.

This is the reference's flagship per-frame workload (ParallelVideoPyr.cpp:
746-747 resize to 1080^2, :831-836 getMaxLayer -> 4 levels ->
coarseToFineEstimation), timed steady-state on the GPU, in the STREAMING
formulation the flagship loop executes: per frame, one new Gaussian
pyramid is built and one pair is solved (each frame's pyramid serves both
its pairs, pipeline/video.py). `--pairwise` measures isolated pairs
instead; parity mode always does.

Times are device kernel time from a jax.profiler trace
(utils/profiling.device_seconds_from_trace), with the host wall clock
beside them. The run fails when JAX finds no GPU.

Prints ONE JSON line on stdout:
  {"metric": "...", "value": N, "unit": "frames/s", "device": {...}}
and the companion detail as one JSON line on stderr.

Usage: python bench.py [--size 1080] [--iters 30] [--batch 1]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def reconcile_host_loop(host_loop, chunk=16):
    """The host-loop coherence gate: the decomposition's legs must
    predict the measured loop within ~25%. Legs are CO-MEASURED with
    each loop by its own clock (instrumented prefetch worker +
    consumer spans — see measure_host_loop), so the prediction is
    against the exact run it explains: with a depth-2 prefetch queue
    the steady-state period per chunk is
        max(producer, consumer) = max(decode + put, dispatch + sync)
    (producer legs are serial in the worker thread; the queue decouples
    producer from consumer). Side bandwidth probes remain in the
    artifact as context only."""
    rec = {}
    for name, legs_key, meas_key in (
        ("bgr", "legs_bgr", "e2e_wall_clock_fps"),
        ("gray", "legs_gray", "e2e_wall_clock_fps_gray_decode"),
    ):
        legs = host_loop.get(legs_key)
        if not legs or meas_key not in host_loop:
            continue
        producer = legs["decode_s_per_chunk"] + legs["h2d_s_per_chunk"]
        consumer = legs["compute_sync_s_per_chunk"]
        pred = chunk / max(producer, consumer)
        # medians on both sides: the window-mean fps keeps outlier
        # chunks a median leg rightly ignores, so the gate compares
        # the TYPICAL chunk period against the typical legs; the
        # window fps stays reported as the experienced rate
        meas_med = chunk / max(legs.get("chunk_period_s_median", 0), 1e-9)
        meas = host_loop[meas_key]
        rec[name] = {
            "predicted_fps": round(pred, 2),
            "measured_fps_window": round(meas, 2),
            "measured_fps_median_period": round(meas_med, 2),
            "median_over_predicted": round(meas_med / pred, 2),
            "coheres_within_25pct": bool(0.75 <= meas_med / pred <= 1.25),
            "bound": (
                "producer(decode+h2d)" if producer >= consumer
                else "consumer(compute+sync)"
            ),
        }
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument(
        "--clamp", type=float, default=8.0,
        help="warp_clamp for the production (corrected) config; "
        "ignored under --parity",
    )
    ap.add_argument(
        "--pairwise",
        action="store_true",
        help="measure isolated flow pairs (both pyramids rebuilt per call) "
        "instead of the streaming-video formulation",
    )
    ap.add_argument(
        "--parity",
        action="store_true",
        help="bench the exact reference configuration (unbounded gather "
        "warp) instead of the production corrected/clamped config",
    )
    ap.add_argument(
        "--sweep",
        action="store_true",
        help="also run the reference's resize-ladder scaling experiment "
        "(200/400/800/1080 squared, ParallelVideoPyr.cpp:750-759) and "
        "batch scaling; table to stderr",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }

    from optical_flow_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    from optical_flow_tpu import FlowConfig, coarse_to_fine
    from optical_flow_tpu.ops.pyramid import max_pyramid_levels
    from optical_flow_tpu.utils.profiling import device_seconds_from_trace

    work = tempfile.mkdtemp(prefix="oft_bench_")

    def traced(fn, argsets):
        """Run fn over argsets under the profiler: (device s, wall s)."""
        trace_dir = tempfile.mkdtemp(dir=work)
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            outs = [fn(*a) for a in argsets]
            jax.block_until_ready(outs[-1])
        wall = time.perf_counter() - t0
        return (
            device_seconds_from_trace(trace_dir, fn.__name__, len(argsets)),
            wall,
        )

    def measure(size, batch, iters, warmup=2, levels=None, cfg=None):
        """Isolated pairs: both pyramids rebuilt per call. Returns
        (device fps, wall fps) over use-once inputs."""
        H = W = size
        levels = levels or max_pyramid_levels((H, W))
        if cfg is None:
            cfg = FlowConfig(levels=levels)
        shape = (batch, H, W) if batch > 1 else (H, W)

        def mk(seed):
            r = np.random.RandomState(seed)
            base = (r.rand(*shape) * 2040.0).astype(np.float32)
            m = (r.rand(*shape) < 0.15).astype(np.float32)
            return jnp.asarray(base * m), jnp.asarray(np.roll(base * m, 2, axis=-1))

        ps = [mk(s) for s in range(warmup + iters)]
        jax.block_until_ready(ps)

        def _bench_step(a, b):
            return coarse_to_fine(a, b, levels, config=cfg)

        fn = jax.jit(_bench_step)
        for p in ps[:warmup]:
            jax.block_until_ready(fn(*p))
        dev, wall = traced(fn, ps[warmup:])
        return iters * batch / dev, iters * batch / wall

    def measure_streaming(size, frames_per_call, iters, warmup=2,
                          levels=None, cfg=None):
        """The flagship workload as the VIDEO LOOP sees it: per frame, ONE
        new Gaussian pyramid is built and one pair is solved — each frame's
        pyramid serves both its pairs (pipeline/video.py reuse). A call
        processes frames_per_call pairs from frames_per_call+1 use-once
        diff planes via batch slices of shared pyramids."""
        from optical_flow_tpu import coarse_to_fine_pyramids
        from optical_flow_tpu.ops.pyramid import gaussian_pyramid

        H = W = size
        levels = levels or max_pyramid_levels((H, W))
        if cfg is None:
            cfg = FlowConfig(levels=levels)
        nb = frames_per_call + 1

        def mk(seed):
            r = np.random.RandomState(seed)
            base = (r.rand(nb, H, W) * 2040.0).astype(np.float32)
            m = (r.rand(nb, H, W) < 0.15).astype(np.float32)
            return (jnp.asarray(base * m),)

        ps = [mk(s) for s in range(warmup + iters)]
        jax.block_until_ready(ps)

        def _bench_stream(diffs):
            pyr = tuple(gaussian_pyramid(diffs, levels))
            prev = tuple(p[:-1] for p in pyr)
            cur = tuple(p[1:] for p in pyr)
            u, v, _, _ = coarse_to_fine_pyramids(prev, cur, config=cfg)
            return u, v

        fn = jax.jit(_bench_stream)
        for p in ps[:warmup]:
            jax.block_until_ready(fn(*p))
        dev, wall = traced(fn, ps[warmup:])
        return iters * frames_per_call / dev, iters * frames_per_call / wall

    def measure_e2e(iters, frames_per_call=4, warmup=2):
        """The FULL flagship chain as the reference times it
        (ParallelVideoPyr.cpp:836 wraps preprocess + flow + postprocess):
        720p BGR frames -> fast-preset preprocess (gray/resize/blur fused,
        diff, threshold, Sobel, morphology) -> streaming pyramidal flow ->
        gesture detection, one jit, device-time per flow frame."""
        from optical_flow_tpu import coarse_to_fine_pyramids
        from optical_flow_tpu.config import VideoConfig
        from optical_flow_tpu.ops.pyramid import gaussian_pyramid
        from optical_flow_tpu.pipeline.gesture import detect_gesture
        from optical_flow_tpu.pipeline.preprocess import (
            diff_features,
            preprocess_frame,
        )

        vc = VideoConfig.fast()
        lv = max_pyramid_levels(vc.preprocess.size)
        nb = frames_per_call + 2  # nb grays -> nb-1 diffs -> nb-2 flow pairs

        def mk(seed):
            r = np.random.RandomState(seed)
            return (jnp.asarray((r.rand(nb, 720, 1280, 3) * 255).astype(np.uint8)),)

        def _e2e(frames):
            gray = preprocess_frame(frames, vc.preprocess)
            diffs = diff_features(gray[1:], gray[:-1], vc.preprocess)
            pyr = tuple(
                gaussian_pyramid(diffs, lv)
            )
            prev = tuple(p[:-1] for p in pyr)
            cur = tuple(p[1:] for p in pyr)
            u, v, _, _ = coarse_to_fine_pyramids(prev, cur, config=vc.flow)
            g = detect_gesture(u, v, vc.gesture)
            return u, g.votes

        ps = [mk(s) for s in range(warmup + iters)]
        jax.block_until_ready(ps)
        fn = jax.jit(_e2e)
        for p in ps[:warmup]:
            jax.block_until_ready(fn(*p))
        dev, _ = traced(fn, ps[warmup:])
        return iters * frames_per_call / dev

    def measure_rooflines(iters=4, frames_per_call=4):
        """Per-stage device-time decomposition of the flagship chain with
        achieved-vs-ceiling fractions: each stage of the fast-preset video
        chain is jitted alone, device-timed on use-once inputs, and scored
        against (a) its HBM floor — stage input+output bytes at perfect
        internal fusion (utils/profiling.io_bytes) — and (b) the float32
        peak at the stages' estimated ops/px. 100 = running AT the
        ceiling; both fractions are lower bounds on true efficiency where
        the floor under-counts unavoidable traffic. The flow stage is
        additionally split per pyramid level by timing coarsest-k-level
        solves."""
        from optical_flow_tpu import coarse_to_fine_pyramids
        from optical_flow_tpu.config import VideoConfig
        from optical_flow_tpu.ops.pyramid import gaussian_pyramid
        from optical_flow_tpu.pipeline.gesture import detect_gesture
        from optical_flow_tpu.pipeline.preprocess import (
            diff_features,
            preprocess_frame,
        )
        from optical_flow_tpu.utils.profiling import io_bytes, stage_roofline

        def roof(bytes_moved, flops, us):
            return stage_roofline(bytes_moved, flops, us, device_kind=device["kind"])

        vc = VideoConfig.fast()
        lv = max_pyramid_levels(vc.preprocess.size)  # 1080 -> 4
        nb = frames_per_call + 2
        HH = vc.preprocess.size[0]

        def stage_time(fn, mk_args, warmup=1):
            f = jax.jit(fn)
            argsets = [mk_args(s) for s in range(warmup + iters)]
            jax.block_until_ready(argsets)
            for a in argsets[:warmup]:
                jax.block_until_ready(f(*a))
            dev, _ = traced(f, argsets[warmup:])
            return 1e6 * dev / iters

        def mk_frames(seed):
            r = np.random.RandomState(seed)
            return (
                jnp.asarray((r.rand(nb, 720, 1280, 3) * 255).astype(np.uint8)),
            )

        def mk_grays(seed):
            r = np.random.RandomState(100 + seed)
            return (
                jnp.asarray((r.rand(nb, HH, HH) * 255).astype(np.float32)),
            )

        def mk_diffs(seed):
            r = np.random.RandomState(200 + seed)
            base = (r.rand(nb - 1, HH, HH) * 2040.0).astype(np.float32)
            m = (r.rand(nb - 1, HH, HH) < 0.15).astype(np.float32)
            return (jnp.asarray(base * m),)

        def mk_uv(seed):
            r = np.random.RandomState(300 + seed)
            return (
                jnp.asarray(r.randn(nb - 2, HH, HH).astype(np.float32) * 3),
                jnp.asarray(r.randn(nb - 2, HH, HH).astype(np.float32) * 3),
            )

        def _st_preprocess(frames):
            return preprocess_frame(frames, vc.preprocess)

        def _st_diff(grays):
            return diff_features(grays[1:], grays[:-1], vc.preprocess)

        def _st_pyramid(diffs):
            return tuple(gaussian_pyramid(diffs, lv))

        def _st_flow(diffs):
            pyr = tuple(gaussian_pyramid(diffs, lv))
            prev = tuple(p[:-1] for p in pyr)
            cur = tuple(p[1:] for p in pyr)
            u, v, _, _ = coarse_to_fine_pyramids(prev, cur, config=vc.flow)
            return u, v

        def _st_gesture(u, v):
            return detect_gesture(u, v, vc.gesture)

        n = frames_per_call  # flow frames per call
        px = HH * HH
        stages = {}
        # flops/px are rough estimates: the HBM fraction is the
        # load-bearing number for these memory-bound stages
        t_us = stage_time(_st_preprocess, mk_frames)
        stages["preprocess"] = roof(
            io_bytes(_st_preprocess, *mk_frames(0)), nb * px * 60.0, t_us
        )
        t_us = stage_time(_st_diff, mk_grays)
        stages["diff_features"] = roof(
            io_bytes(_st_diff, *mk_grays(0)), (nb - 1) * px * 60.0, t_us
        )
        t_us = stage_time(_st_pyramid, mk_diffs)
        stages["pyramid_build"] = roof(
            io_bytes(_st_pyramid, *mk_diffs(0)), (nb - 1) * px * 1.33 * 20.0,
            t_us,
        )
        t_pyr = stages["pyramid_build"]["measured_us"]
        t_us = stage_time(_st_flow, mk_diffs)
        # flow alone = (pyramid + flow) - pyramid; areas 1 + 1/4 + 1/16
        # refine levels (pyrUp+warp+LK, ~174 flops/px, 24 B/px floor) +
        # the coarsest plain-LK level (70 flops/px, 16 B/px)
        t_flow = max(t_us - t_pyr, 1e-6)
        a_ref = px * (1 + 0.25 + 0.0625)
        a_coarse = px / 64.0
        flow_bytes = n * (24.0 * a_ref + 16.0 * a_coarse)
        flow_flops = n * (174.0 * a_ref + 70.0 * a_coarse)
        stages["flow_levels"] = roof(flow_bytes, flow_flops, t_flow)
        t_us = stage_time(_st_gesture, mk_uv)
        stages["gesture"] = roof(
            io_bytes(_st_gesture, *mk_uv(0)), n * px * 15.0, t_us
        )
        # per-level flow: solve the coarsest k levels only; successive
        # differences isolate each finer refine step (pyrUp+warp+LK)
        pyr_builder = jax.jit(_st_pyramid)

        def mk_pyr_k(k):
            def mk(seed):
                (diffs,) = mk_diffs(seed)
                return tuple(pyr_builder(diffs)[lv - k:])
            return mk

        def _st_flow_k(*pyr):
            prev = tuple(p[:-1] for p in pyr)
            cur = tuple(p[1:] for p in pyr)
            u, v, _, _ = coarse_to_fine_pyramids(prev, cur, config=vc.flow)
            return u, v

        t_k = []
        for k in range(1, lv + 1):
            t_k.append(stage_time(_st_flow_k, mk_pyr_k(k)))
        per_level = {}
        sides = [HH // (2 ** i) for i in range(lv)]  # finest..coarsest
        per_level[f"lk_{sides[-1]}"] = roof(
            n * 16.0 * sides[-1] ** 2, n * 70.0 * sides[-1] ** 2, t_k[0]
        )
        for k in range(2, lv + 1):
            side = sides[lv - k]
            per_level[f"warp_lk_{side}"] = roof(
                n * 24.0 * side * side, n * 174.0 * side * side,
                max(t_k[k - 1] - t_k[k - 2], 1e-6),
            )
        # whole frame: sum of stage HBM floors vs summed measured time
        tot_meas = sum(s["measured_us"] for s in stages.values())
        tot_floor = sum(s["sol_hbm_us"] for s in stages.values())
        whole = {
            "measured_us_per_flow_frame": tot_meas / n,
            "pct_of_hbm_roofline": 100.0 * tot_floor / tot_meas,
        }
        return {"stages": stages, "flow_per_level": per_level,
                "whole_frame": whole}

    def _bench_clip(size=(720, 1280), frames=240):
        """Deterministic synthetic test clip (textured background + moving
        blob), encoded once per run: the host-loop measurement needs a
        REAL encoded video so the decode leg is genuine work."""
        clip = os.path.join(work, f"clip_{size[0]}p_{frames}.mp4")
        if os.path.exists(clip):
            return clip
        try:
            import cv2
        except ImportError:
            return None
        H, W = size
        r = np.random.RandomState(0)
        basef = (r.rand(H, W, 3) * 60 + 60).astype(np.uint8)
        yy, xx = np.mgrid[0:H, 0:W]
        wtr = cv2.VideoWriter(
            clip + ".tmp.mp4", cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H)
        )
        if not wtr.isOpened():
            return None
        for t in range(frames):
            f = np.roll(basef, 2 * t, axis=1)
            cxb, cyb = (100 + 3 * t) % W, (200 + 2 * t) % H
            blob = np.exp(
                -(((xx - cxb) ** 2 + (yy - cyb) ** 2) / (2 * 60.0 ** 2))
            )
            wtr.write(
                np.clip(f + blob[..., None] * 160, 0, 255).astype(np.uint8)
            )
        wtr.release()
        os.rename(clip + ".tmp.mp4", clip)
        return clip

    def measure_host_loop(chunk=16, gray=False, n_chunks=14):
        """The REAL end-to-end host loop: decode ->
        chunk prefetch (H2D) -> one jitted chunk step (preprocess + flow +
        gesture) per `chunk` frames -> next chunk, sustained WALL-CLOCK
        fps with every chunk's result forced to completion. This is the
        quantity the reference's own frame timer measures
        (ParallelVideoPyr.cpp:836), minus imshow.

        Steady state only: the first two chunks compile (_chunk_first /
        _chunk_step) and the next two were prestaged into the prefetch
        queue DURING those compiles, so the first four marks are dropped;
        max_frames is a chunk multiple so the per-frame tail path (4 more
        fresh compiles) never runs.

        Returns (fps, legs): the legs are CO-MEASURED with the loop by
        the loop's own clock — producer spans (decode, put) from the
        instrumented prefetch worker, consumer spans (queue wait,
        dispatch+sync) from this thread — so the reconciliation is
        against the exact run it explains.

        Known instrumentation bias: timing the put requires
        block_until_ready in the worker, which serializes the NEXT
        chunk's decode behind the transfer; the uninstrumented production
        loop overlaps them. The bias is at most decode/(decode+put) of
        the producer period, and the reconciliation's producer model
        (decode + put, serial) matches the loop it measures."""
        from optical_flow_tpu.config import VideoConfig
        from optical_flow_tpu.io.prefetch import prefetch_chunks_to_device
        from optical_flow_tpu.io.video_reader import read_frames
        from optical_flow_tpu.pipeline.video import VideoPipeline

        clip = _bench_clip(frames=16 * (n_chunks + 1))
        if clip is None:
            return None
        pipe = VideoPipeline(VideoConfig.fast())
        timings: list = []
        chunks = prefetch_chunks_to_device(
            read_frames(clip, max_frames=chunk * n_chunks, gray=gray),
            chunk_size=chunk, depth=2, timings=timings,
        )
        carry = None
        marks = []
        waits = []
        comp = []
        n = 0
        t0 = time.perf_counter()
        for dev in chunks:
            waits.append(time.perf_counter() - (t0 + (marks[-1][0] if marks else 0.0)))
            if dev.shape[0] < chunk:
                break  # tail chunk (shouldn't occur: frame count is a multiple)
            tc = time.perf_counter()
            if carry is None:
                res, carry = pipe._chunk_first(dev)
            else:
                res, carry = pipe._chunk_step(carry, dev)
            jax.block_until_ready(res.u)  # force THIS chunk done: honest sustained rate
            comp.append(time.perf_counter() - tc)
            n += chunk
            marks.append((time.perf_counter() - t0, n))
        if len(marks) < 6:
            return None
        (t1, n1), (t2, n2) = marks[3], marks[-1]  # steady state: chunks 5..N
        fps = (n2 - n1) / (t2 - t1)
        k = 4  # align legs with the steady-state window
        # MEDIAN legs: a few outlier transfers absorbed by the queue's
        # lead would skew a mean without ever gating the consumer; the
        # per-chunk H2D list ships alongside so the spread is auditable
        med = lambda xs: float(np.median(xs)) if len(xs) else 0.0
        puts = [t["put_s"] for t in timings[k:]]
        periods = [
            marks[i][0] - marks[i - 1][0] for i in range(k, len(marks))
        ]
        legs = {
            "decode_s_per_chunk": round(med([t["decode_s"] for t in timings[k:]]), 3),
            "h2d_s_per_chunk": round(med(puts), 3),
            "h2d_s_per_chunk_all": [round(p, 2) for p in puts],
            "compute_sync_s_per_chunk": round(med(comp[k:]), 3),
            "queue_wait_s_per_chunk": round(med(waits[k:]), 3),
            # the median steady-state chunk period — what the median legs
            # must reconcile against (medians compare like with like)
            "chunk_period_s_median": round(med(periods), 3),
        }
        return fps, legs

    def sustained_h2d_pair(n_bufs=4):
        """(bgr_mbps, gray_mbps) pipelined H2D at the real chunk shapes:
        queue every put back to back, drain ONCE — what the prefetch
        thread does (transfers overlap in flight). Context only: the
        reconciliation uses the legs co-measured with the loop."""

        def one(shape):
            xs = [
                np.random.randint(0, 255, shape, np.uint8)
                for _ in range(n_bufs)
            ]
            a = jax.device_put(xs[0])
            float(np.asarray(a.ravel()[-1:])[0])  # warm + real drain
            t0 = time.perf_counter()
            arrs = [jax.device_put(x) for x in xs]
            for a in arrs:
                a.block_until_ready()
            float(np.asarray(arrs[-1].ravel()[-1:])[0])
            return sum(x.nbytes for x in xs) / 1e6 / (
                time.perf_counter() - t0
            )

        return one((16, 720, 1280, 3)), one((16, 720, 1280))

    def measure_host_decomposition():
        """Each leg of the host loop measured alone, so the gap between
        wall clock and device time is explained: decode-only fps (both
        pixel formats), sustained pipelined H2D bandwidth at the real
        chunk shapes, and per-dispatch overhead at depth for both
        chained-tiny and fresh-big-input dispatches."""
        from optical_flow_tpu.io.video_reader import read_frames

        out = {}
        clip = _bench_clip()
        if clip is not None:
            for name, gray in (("bgr", False), ("gray", True)):
                # warm-up open (first open pays one-time codec costs)
                for _ in read_frames(clip, max_frames=2, gray=gray):
                    pass
                n = 0
                t0 = time.perf_counter()
                for _ in read_frames(clip, max_frames=200, gray=gray):
                    n += 1
                out[f"decode_only_fps_{name}"] = round(
                    n / (time.perf_counter() - t0), 1
                )

        mb_bgr, mb_gray = sustained_h2d_pair()
        px = 720 * 1280
        out["h2d_sustained_mbps_bgr_chunk16"] = round(mb_bgr, 1)
        out["h2d_sustained_mbps_gray_chunk16"] = round(mb_gray, 1)
        out["h2d_bound_fps_720p_bgr"] = round(mb_bgr * 1e6 / (px * 3), 1)
        out["h2d_bound_fps_720p_gray"] = round(mb_gray * 1e6 / px, 1)
        # per-dispatch overhead at depth (async queue, one final sync)
        f = jax.jit(lambda y: y + 1)
        b = jax.device_put(np.zeros((8, 128), np.float32))
        float(np.asarray(f(b)[0, 0]))
        t0 = time.perf_counter()
        z = b
        for _ in range(100):
            z = f(z)
        float(np.asarray(z[0, 0]))
        out["dispatch_ms_per_call_depth100"] = round(
            (time.perf_counter() - t0) * 10.0, 2
        )
        # per-dispatch floor with DISTINCT prestaged large inputs — the
        # regime the streaming loop actually runs in (each call gets a
        # pair it has never seen); this is the floor that caps
        # wall_clock_fps_prestaged_inputs at small dispatch depths
        g = jax.jit(lambda y: y[..., :1, :1] + 1.0)
        bigs = [
            jax.device_put(np.zeros((5, 1080, 1080), np.float32))
            for _ in range(8)
        ]
        jax.block_until_ready(bigs)
        float(np.asarray(g(bigs[0])).ravel()[0])
        t0 = time.perf_counter()
        outs = [g(x) for x in bigs]
        jax.block_until_ready(outs)
        out["dispatch_ms_per_call_fresh_prestaged_inputs"] = round(
            (time.perf_counter() - t0) * 1e3 / len(bigs), 2
        )
        return out

    if args.sweep:
        print("size  batch  fps        Mpix/s", file=sys.stderr)
        for size in (200, 400, 800, 1080):
            for batch in (1, 8):
                lv = max_pyramid_levels((size, size))
                sweep_cfg = (
                    FlowConfig(levels=lv)
                    if args.parity
                    else FlowConfig(
                        levels=lv, mode="corrected",
                        warp_clamp=args.clamp,
                    )
                )
                fps, _ = measure(size, batch, max(6, args.iters // 3), cfg=sweep_cfg)
                print(
                    f"{size:5d} {batch:5d}  {fps:10.1f} {fps*size*size/1e6:10.1f}",
                    file=sys.stderr,
                )

    H = W = args.size
    levels = args.levels or max_pyramid_levels((H, W))  # 1080 -> 4 (reference)
    # Production configuration: displacement-true pyramid with a clamped
    # warp (the separable shift warp). Accuracy is anchored separately:
    # the parity EPE below runs the exact reference configuration.
    if args.parity:
        cfg = FlowConfig(levels=levels)
    else:
        cfg = FlowConfig(
            levels=levels,
            mode="corrected",
            warp_clamp=args.clamp,
        )
    formulation = "pairwise" if (args.parity or args.pairwise) else "streaming"
    # Headline: the streaming-video formulation (one new pyramid + one
    # pair solve per frame — what the flagship loop and pipeline/video.py
    # execute in steady state). `--pairwise` measures isolated pairs
    # (both pyramids rebuilt per call); parity mode always does.
    fps_stats = None
    dispatch_sweep = None
    if formulation == "pairwise":
        fps, wall_fps = measure(
            args.size, args.batch, args.iters, args.warmup, levels, cfg
        )
        pair_fps = fps
    else:
        # 5 repeats -> median / IQR; all runs use use-once inputs, so
        # repeats measure run-to-run spread
        n_runs = 5
        samples = []
        wall_samples = []
        for _ in range(n_runs):
            s_fps, s_wall = measure_streaming(
                args.size, max(args.batch, 4), args.iters,
                args.warmup, levels, cfg,
            )
            samples.append(s_fps)
            wall_samples.append(s_wall)
        fps = float(np.median(samples))
        wall_fps = float(np.median(wall_samples))
        q1, q3 = np.percentile(samples, [25, 75])
        fps_stats = {
            "fps_median": fps,
            "fps_iqr": float(q3 - q1),
            "fps_min": min(samples),
            "fps_max": max(samples),
            "n_runs": n_runs,
        }
        pair_fps, _ = measure(
            args.size, args.batch, max(6, args.iters // 3),
            args.warmup, levels, cfg,
        )
        if args.size == 1080:
            # dispatch-depth sweep with PRE-STAGED inputs: wall clock
            # converges toward device time as frames/dispatch grows
            dispatch_sweep = {}
            for fpc in (4, 8, 16, 32, 64):
                d_fps, w_fps = measure_streaming(
                    args.size, fpc, max(6, args.iters // 3),
                    args.warmup, levels, cfg,
                )
                dispatch_sweep[str(fpc)] = {"wall_fps": w_fps, "device_fps": d_fps}
    mpix_s = fps * H * W / 1e6
    companions = formulation == "streaming" and args.size == 1080
    # end-to-end companion: the whole flagship chain (preprocess + flow +
    # gesture), the quantity the reference's own frame timer measures
    # (ParallelVideoPyr.cpp:836)
    e2e_fps = measure_e2e(max(6, args.iters // 3)) if companions else None
    # host-loop companions: the REAL decode->H2D->compute chain's
    # sustained wall fps, plus the per-leg decomposition that explains
    # any gap to device time
    host_loop = None
    if companions:
        host_loop = measure_host_decomposition()
        r_bgr = measure_host_loop(chunk=16, gray=False)
        r_gray = measure_host_loop(chunk=16, gray=True)
        if r_bgr:
            host_loop["e2e_wall_clock_fps"] = r_bgr[0]
            host_loop["legs_bgr"] = r_bgr[1]
        if r_gray:
            host_loop["e2e_wall_clock_fps_gray_decode"] = r_gray[0]
            host_loop["legs_gray"] = r_gray[1]
        host_loop["reconciliation"] = reconcile_host_loop(host_loop, chunk=16)
    # roofline companion: per-stage achieved-vs-ceiling fractions
    rooflines = measure_rooflines() if companions else None
    # accuracy companion metric: f32 mean EPE vs the reference goldens
    epe = None
    from optical_flow_tpu.utils import goldens

    if goldens.reference_dir() is not None:
        img1, img2 = goldens.load_table_pair()
        cfg7 = FlowConfig(levels=7)
        u, v = jax.jit(lambda a, b: coarse_to_fine(a, b, 7, config=cfg7))(
            jnp.asarray(img1.astype(np.float32)),
            jnp.asarray(img2.astype(np.float32)),
        )
        gu = goldens.load_mat(goldens.reference_dir() / "UPyrTest.txt")
        gv = goldens.load_mat(goldens.reference_dir() / "VPyrTest.txt")
        epe = float(np.mean(np.hypot(np.asarray(u) - gu, np.asarray(v) - gv)))
        if not np.isfinite(epe) or epe > 0.1:
            sys.exit(f"EPE vs goldens {epe} exceeds the 0.1 px budget")

    shutil.rmtree(work, ignore_errors=True)
    print(
        json.dumps(
            {
                "detail": {
                    "mpix_per_s": mpix_s,
                    "f32_mean_epe_px_vs_goldens": epe,
                    "config": (
                        "parity" if args.parity
                        else f"corrected+clamped warp (clamp {args.clamp:g})"
                    ),
                    "formulation": formulation,
                    "pairwise_fps": pair_fps,
                    "e2e_video_fps_fast_preset": e2e_fps,
                    # wall clock over the headline run with inputs ALREADY
                    # on device: Python dispatch + sync only
                    "wall_clock_fps_prestaged_inputs": wall_fps,
                    "fps_stats": fps_stats,
                    # the production pipeline dispatches 16-frame chunks
                    # (pipeline/video.py run_chunked default)
                    "wall_clock_fps_production_chunk16": (
                        None
                        if not dispatch_sweep
                        else dispatch_sweep["16"]["wall_fps"]
                    ),
                    "dispatch_sweep_prestaged": dispatch_sweep,
                    "host_loop": host_loop,
                    "rooflines": rooflines,
                    "timing_source": "device_kernels",
                    "levels": levels,
                    "batch": args.batch,
                    "iters": args.iters,
                }
            }
        ),
        file=sys.stderr,
        flush=True,
    )
    print(
        json.dumps(
            {
                "metric": f"dense_pyramidal_lk_{args.size}p_fps",
                "value": fps,
                "unit": "frames/s",
                "formulation": formulation,
                "device": device,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
