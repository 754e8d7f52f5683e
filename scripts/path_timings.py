#!/usr/bin/env python
"""Time the two clamped-warp forms on the GPU, and profile the fast
preset's pyramid level by level. This is the measurement the clamped
warp_impl='auto' choice (flow/coarse_to_fine.py resolve_warp_impl) rests on.

    python scripts/path_timings.py [--frames 16] [--iters 6]

Each form is timed as device kernel time from a profiler trace over
use-once inputs (utils/profiling.device_kernels):
  warp          the fast preset's streaming flow chunk at 1080^2 (pyramid
                + 4-level corrected flow, clamp 8) with warp 'gather' vs
                'shift_sep'
  horn_schunck  4-level Horn-Schunck (clamp 8) on a textured 1080^2 pair
                moved by a known sub-pixel translation, with each warp:
                its time and its mean EPE against the true motion
Levels: each corrected level step of the fast preset (upsample, clamp,
warp, LK, accumulate; the coarsest level is LK alone) jitted on its own:
its kernel time, its kernel count, and its byte floor — images, coarse
flow and output flow at 4 B/px over the card's HBM rate.

Prints one JSON object; fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16, help="flow frames per chunk")
    ap.add_argument("--iters", type=int, default=6, help="timed calls per form")
    ap.add_argument("--size", type=int, default=1080)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"path_timings.py measures the GPU; JAX found {dev.platform!r}")

    from optical_flow_tpu import VideoConfig, coarse_to_fine_pyramids
    from optical_flow_tpu.flow.coarse_to_fine import resolve_warp_impl
    from optical_flow_tpu.flow.lk import lucas_kanade
    from optical_flow_tpu.flow.pyramid_loop import run_pyramid
    from optical_flow_tpu.ops.pyramid import gaussian_pyramid, max_pyramid_levels
    from optical_flow_tpu.ops.warp import symmetric_warp
    from optical_flow_tpu.flow.horn_schunck import HornSchunckConfig, horn_schunck
    from optical_flow_tpu.utils.compile_cache import enable_persistent_cache
    from optical_flow_tpu.utils.profiling import device_kernels, peaks

    enable_persistent_cache()
    work = tempfile.mkdtemp(prefix="oft_paths_")
    S, F = args.size, args.frames
    levels = max_pyramid_levels((S, S))

    def timed(fn, argsets, warmup=2):
        """(device ms per call, kernels per call) over use-once argsets."""
        f = jax.jit(fn)
        for a in argsets[:warmup]:
            jax.block_until_ready(f(*a))
        trace_dir = tempfile.mkdtemp(dir=work)
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready([f(*a) for a in argsets[warmup:]])
        k = device_kernels(trace_dir, fn.__name__)
        n = len(argsets) - warmup
        return sum(d for _, d in k) / 1e6 / n, len(k) / n

    def diffs(seed):
        r = np.random.RandomState(seed)
        base = (r.rand(F + 1, S, S) * 2040.0).astype(np.float32)
        m = (r.rand(F + 1, S, S) < 0.15).astype(np.float32)
        return (jax.device_put(base * m),)

    chunks = [diffs(s) for s in range(2 + args.iters)]
    fast = VideoConfig.fast().flow
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}

    # warp: the whole flow chunk with each clamped-warp form
    import dataclasses

    forms = ("gather", "shift_sep")
    warp = {}
    for impl in forms:
        cfg = dataclasses.replace(fast, warp_impl=impl)

        def _flow_chunk(d, cfg=cfg):
            pyr = gaussian_pyramid(d, levels)
            u, v, _, _ = coarse_to_fine_pyramids(
                [p[:-1] for p in pyr], [p[1:] for p in pyr], config=cfg
            )
            return u, v

        ms, nk = timed(_flow_chunk, chunks)
        warp[impl] = {"ms_per_frame": ms / F, "kernels_per_chunk": nk}
    out["warp"] = warp

    # horn_schunck: 4-level coarse-to-fine with each warp, known motion
    true_uv = (1.5, -0.75)

    def hs_pair(seed):
        r = np.random.RandomState(200 + seed)
        y, x = np.mgrid[0:S, 0:S].astype(np.float64)
        waves = r.uniform([-0.2, -0.2, 0], [0.2, 0.2, 6.3], (12, 3))

        def scene(dx, dy):
            return sum(
                20.0 * np.sin(kx * (x - dx) + ky * (y - dy) + p) for kx, ky, p in waves
            ) + 128.0

        a = scene(0.0, 0.0).astype(np.float32)
        b = scene(*true_uv).astype(np.float32)
        return jax.device_put(a), jax.device_put(b)

    hs_pairs = [hs_pair(s) for s in range(2 + args.iters)]
    border = S // 16
    hs = {}
    for impl in forms:
        cfg = HornSchunckConfig(levels=levels, warp_impl=impl)

        def _hs(a, b, cfg=cfg):
            return horn_schunck(a, b, cfg)

        ms, nk = timed(_hs, hs_pairs)
        u, v = jax.jit(_hs)(*hs_pairs[0])
        sl = np.s_[border:-border, border:-border]
        epe = np.hypot(np.asarray(u)[sl] - true_uv[0], np.asarray(v)[sl] - true_uv[1])
        hs[impl] = {"ms_per_call": ms, "kernels_per_call": nk,
                    "mean_epe_px": float(epe.mean()),
                    "uv": (np.asarray(u), np.asarray(v))}
    du = np.abs(hs["gather"]["uv"][0] - hs["shift_sep"]["uv"][0])
    dv = np.abs(hs["gather"]["uv"][1] - hs["shift_sep"]["uv"][1])
    for impl in forms:
        del hs[impl]["uv"]
    hs["gather_vs_shift_sep_max_abs_px"] = float(max(du.max(), dv.max()))
    hs["gather_vs_shift_sep_mean_abs_px"] = float((du.mean() + dv.mean()) / 2)
    hs["true_motion_px"] = true_uv
    hs["epe_border_cut_px"] = border
    out["horn_schunck"] = hs

    # per-level profile of the fast preset with its resolved warp
    hbm = peaks(dev.device_kind)["hbm_gbps"] * 1e9
    impl, max_disp = resolve_warp_impl(fast)
    pyr_fn = jax.jit(lambda d: gaussian_pyramid(d, levels))
    pyrs = [pyr_fn(*c) for c in chunks]
    per_level = {}
    for i in range(levels - 1, -1, -1):
        side = pyrs[0][i].shape[-1]
        if i == levels - 1:
            def _coarsest(a, b):
                return lucas_kanade(a, b)

            argsets = [(p[i][:-1], p[i][1:]) for p in pyrs]
            ms, nk = timed(_coarsest, argsets)
            planes = 4.0  # two images in, two flow planes out
        else:
            def _level_step(a, b, uc, vc):
                def solve(k, x, y):
                    return (uc, vc) if k == 1 else lucas_kanade(x, y)

                def warp_fn(_k, x, y, u, v):
                    return symmetric_warp(x, y, u, v, quantize=fast.quantize_warp,
                                          impl=impl, max_disp=max_disp)

                z = jnp.zeros(uc.shape, a.dtype)
                u, v, _, _ = run_pyramid([a, z], [b, z], solve, warp_fn, fast)
                return u, v

            rng = np.random.RandomState(i)
            argsets = []
            for p in pyrs:
                shape = p[i + 1][:-1].shape
                uc = jax.device_put(rng.randn(*shape).astype(np.float32) * 2)
                vc = jax.device_put(rng.randn(*shape).astype(np.float32) * 2)
                argsets.append((p[i][:-1], p[i][1:], uc, vc))
            ms, nk = timed(_level_step, argsets)
            planes = 4.5  # two images + quarter-size coarse flow in, flow out
        floor_ms = planes * 4 * side * side * F / hbm * 1e3
        per_level[f"level{i}_{side}"] = {
            "ms_per_chunk": ms, "kernels_per_chunk": nk,
            "byte_floor_ms": floor_ms, "over_floor": ms / floor_ms,
        }
    out["levels"] = per_level
    out["frames_per_chunk"] = F
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
