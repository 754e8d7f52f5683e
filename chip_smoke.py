#!/usr/bin/env python
"""Proof that the flow engine runs on a GPU, phase by phase, each phase
held to a CPU run of the same call in the same process.

    python chip_smoke.py               # one GPU: phases 1-6
    python chip_smoke.py --four-cards  # four GPUs: the multi-card phase only

Phases (one GPU):
  1 device      JAX's first device must be a GPU; there is no CPU fallback
  2 dense       jit(coarse_to_fine) at 1080^2 with the fast preset, against
                the CPU in float32; the parity FlowConfig() on a 448x640
                pair, against the CPU in float64
  3 video       VideoPipeline(VideoConfig.fast()).run_chunked over 48
                seeded 1280x720 BGR frames at 1080^2, 16-frame chunks
  4 served      FlowServer in a thread, 10 frames through FlowClient with
                return_flow, against phase 3's pipeline on the same frames
  5 sparse      good_features_to_track + track_features against the CPU
  6 solver      the f32 VI-BA metric-scale check under the GPU's default
                matmul precision (tests/test_vi_ba.py's scene)

Every input is made here from a seed. The CPU oracle runs in this process
on jax.devices("cpu"), so one process holds the card. Each phase prints
its line with the measured difference beside its tolerance; any failed
phase exits non-zero. The last line is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_lines():
    """`nvidia-smi` name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def require(ok, what: str) -> None:
    """Like assert, but kept under `python -O`."""
    if not ok:
        raise RuntimeError(what)


def check(phase: str, name: str, value: float, tol: float) -> None:
    ok = bool(np.isfinite(value)) and value <= tol
    say(phase, f"{name} = {value:.6g} (tolerance {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{phase}: {name} = {value} exceeds {tol}")


def textured_pair(H, W, dx, dy, seed=SEED):
    """A seeded broadband texture (40 plane waves) and its exact sub-pixel
    translation by (dx, dy)."""
    rng = np.random.RandomState(seed)
    waves = [
        (*rng.uniform(-0.6, 0.6, 2), rng.uniform(0, 2 * np.pi))
        for _ in range(40)
    ]
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)

    def tex(xx, yy):
        return 128.0 + sum(6.0 * np.sin(kx * xx + ky * yy + p) for kx, ky, p in waves)

    return tex(x, y), tex(x - dx, y - dy)


def epe(u1, v1, u2, v2) -> float:
    u1, v1, u2, v2 = (np.asarray(a, np.float64) for a in (u1, v1, u2, v2))
    return float(np.hypot(u1 - u2, v1 - v2).mean())


def maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def check_flow_bulk(phase, label, u, v, ur, vr) -> None:
    """Median EPE and the share of pixels off by over 1 px: the checks for
    flow on diff features, whose flat regions make some pixels' 3x3 solve
    chaotic (see phase_video)."""
    e = np.hypot(np.asarray(u, np.float64) - ur, np.asarray(v, np.float64) - vr)
    check(phase, f"{label} median EPE px", float(np.median(e)), 1e-3)
    check(phase, f"{label} share of pixels with EPE > 1 px", float(np.mean(e > 1.0)), 1e-3)


def check_votes(phase, label, votes, ref) -> None:
    votes, ref = np.asarray(votes, np.int64).ravel(), np.asarray(ref, np.int64).ravel()
    rel = np.abs(votes - ref) / np.maximum(ref, 1)
    check(phase, f"{label} gesture votes max relative |d| (votes {ref.min()}..{ref.max()})",
          float(rel.max()), 0.03)


class Env:
    """The devices and the CPU-oracle context of one run."""

    def __init__(self, jax):
        self.jax = jax
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]

    @contextlib.contextmanager
    def on_cpu(self):
        """Run everything inside — worker threads included — on the CPU."""
        self.jax.config.update("jax_default_device", self.cpu)
        try:
            yield
        finally:
            self.jax.config.update("jax_default_device", None)


def phase_dense(env):
    import jax
    import jax.numpy as jnp

    from optical_flow_tpu import FlowConfig, VideoConfig, coarse_to_fine

    prec = jax.config.jax_default_matmul_precision
    say("dense", f"matmul precision: {prec or 'default (f32 matmuls may use TF32)'}")
    a, b = textured_pair(1080, 1080, 1.4, -0.6)
    cfg = VideoConfig.fast().flow
    flow = jax.jit(lambda x, y: coarse_to_fine(x, y, config=cfg))
    t0 = time.perf_counter()
    ug, vg = jax.block_until_ready(flow(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
    t1 = time.perf_counter()
    ug, vg = jax.block_until_ready(flow(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
    t2 = time.perf_counter()
    with env.on_cpu():
        uc, vc = flow(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    require(ug.devices() == {env.gpu} and uc.devices() == {env.cpu}, "dense: wrong devices")
    say("dense", f"fast preset 1080^2 f32: compile+run {t1 - t0:.3f} s, warm {1e3 * (t2 - t1):.3f} ms")
    check("dense", "fast 1080^2 GPU-vs-CPU(f32) mean EPE px", epe(ug, vg, uc, vc), 1e-3)
    check("dense", "fast 1080^2 GPU-vs-CPU(f32) max |du|,|dv| px",
          max(maxdiff(ug, uc), maxdiff(vg, vc)), 1.0)
    check("dense", "fast 1080^2 GPU mean EPE vs true (1.4, -0.6) px, 16 px border cut",
          epe(np.asarray(ug)[16:-16, 16:-16], np.asarray(vg)[16:-16, 16:-16], 1.4, -0.6), 0.1)

    a, b = textured_pair(448, 640, 0.8, 0.5, seed=SEED + 1)
    par = jax.jit(lambda x, y: coarse_to_fine(x, y, config=FlowConfig()))
    ug, vg = par(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    with env.on_cpu(), jax.enable_x64(True):
        uc, vc = jax.jit(lambda x, y: coarse_to_fine(x, y, config=FlowConfig()))(
            jnp.asarray(a, jnp.float64), jnp.asarray(b, jnp.float64)
        )
        require(uc.dtype == jnp.float64, "dense: the CPU oracle is not float64")
        uc, vc = np.asarray(uc), np.asarray(vc)
    check("dense", "parity 448x640 GPU(f32)-vs-CPU(f64) mean EPE px", epe(ug, vg, uc, vc), 0.1)


def video_frames(n=48, H=720, W=1280):
    """Seeded BGR clip: a smooth texture drifting 2 px per frame and a
    moving bright blob."""
    rng = np.random.RandomState(SEED + 2)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    waves = [(*rng.uniform(-0.08, 0.08, 2), rng.uniform(0, 2 * np.pi), rng.randint(3))
             for _ in range(24)]
    frames = np.empty((n, H, W, 3), np.uint8)
    for t in range(n):
        img = np.full((H, W, 3), 110.0, np.float32)
        for kx, ky, p, c in waves:
            img[..., c] += 12.0 * np.sin(kx * (x - 2 * t) + ky * y + p)
        blob = np.exp(-(((x - 300 - 6 * t) ** 2 + (y - 360 + 2 * t) ** 2) / (2 * 60.0 ** 2)))
        frames[t] = np.clip(img + blob[..., None] * 120, 0, 255)
    return frames


def phase_video(env, frames):
    """The fast-preset chain, GPU against CPU. Preprocessing is compared
    directly; the flow by its bulk: LK's 3x3 solve divides by near-zero
    determinants in the flat regions of the thresholded diff features,
    where float32 roundoff in another summation order moves the result
    arbitrarily (|flow| reaches ~1e6 px there on either device), so the
    check bounds the median EPE and the share of pixels off by over 1 px,
    and the gesture votes those pixels can tip."""
    import jax
    import jax.numpy as jnp

    from optical_flow_tpu import VideoConfig
    from optical_flow_tpu.pipeline.preprocess import diff_features, preprocess_frame
    from optical_flow_tpu.pipeline.video import VideoPipeline

    cfg = VideoConfig.fast()
    pre = jax.jit(lambda f: preprocess_frame(f, cfg.preprocess))
    dif = jax.jit(lambda g: diff_features(g[1:], g[:-1], cfg.preprocess))

    def run():
        grays = pre(jnp.asarray(frames[:17]))
        diffs = np.asarray(dif(grays))
        pipe = VideoPipeline(cfg)
        res = list(pipe.run_chunked(iter(frames), chunk_size=16))
        u = np.concatenate([np.asarray(r.u) for r in res])
        v = np.concatenate([np.asarray(r.v) for r in res])
        votes = np.concatenate([np.asarray(r.gesture.votes).ravel() for r in res])
        return np.asarray(grays), diffs, u, v, votes

    t0 = time.perf_counter()
    gg, dg, ug, vg, votes_g = run()
    say("video", f"48 frames 720p -> 1080^2 on the GPU: {time.perf_counter() - t0:.3f} s incl. compile")
    with env.on_cpu():
        gc, dc, uc, vc, votes_c = run()
    require(ug.shape == (46, 1080, 1080), f"video: flow shape {ug.shape}")
    check("video", "preprocessed gray GPU-vs-CPU max |d| (0-255 scale)", maxdiff(gg, gc), 1e-3)
    check("video", "diff features GPU-vs-CPU max |d|", maxdiff(dg, dc), 1e-2)
    check_flow_bulk("video", "flow GPU-vs-CPU(f32)", ug, vg, uc, vc)
    check_votes("video", "GPU-vs-CPU", votes_g, votes_c)
    return ug, vg


def phase_served(env, frames, ug, vg):
    from optical_flow_tpu.pipeline.serve import FlowClient, FlowServer

    srv = FlowServer(port=0)
    srv.start_background()
    try:
        with FlowClient(srv.address) as c:
            hello = c.start_stream(720, 1280, preset="fast", proc_size=(1080, 1080), return_flow=True)
            require(hello["ok"], f"served: handshake refused: {hello}")
            replies = [c.push(f) for f in frames[:10]]
            c.end_stream()
    finally:
        srv.shutdown()
    require(all(r.get("warmup") for r in replies[:2]), f"served: no warm-up: {replies[:2]}")
    us = np.stack([r["u"] for r in replies[2:]])
    vs = np.stack([r["v"] for r in replies[2:]])
    check_flow_bulk("served", "served-vs-pipeline flow (8 frames)", us, vs, ug[:8], vg[:8])


def phase_sparse(env):
    import jax.numpy as jnp

    from optical_flow_tpu.track import good_features_to_track, track_features

    a, b = textured_pair(480, 640, 2.3, -1.2, seed=SEED + 3)
    a, b = a.astype(np.float32), b.astype(np.float32)

    def run():
        pts, valid = good_features_to_track(jnp.asarray(a), 500, 0.01, 10)
        new, status, err = track_features(a, b, pts)
        return np.asarray(pts), np.asarray(valid), np.asarray(new), np.asarray(status)

    pg, okg, ng, sg = run()
    with env.on_cpu():
        pc, okc, nc, sc = run()
    check("sparse", "corner positions max |GPU-CPU| px", maxdiff(pg[okg], pc[okc]) if okg.sum() == okc.sum() else np.inf, 1e-3)
    both = sg & sc & okg
    check("sparse", "status disagreements", float((sg != sc)[okg].sum()), 2.0)
    check("sparse", "tracked endpoints max |GPU-CPU| px", maxdiff(ng[both], nc[both]), 0.05)
    err_true = np.abs(ng[both] - pg[both] - np.asarray([2.3, -1.2])).mean()
    check("sparse", f"GPU mean |error| vs true motion px ({int(both.sum())} tracks)", float(err_true), 0.1)


def phase_solver(env):
    import jax

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_vi_ba import _make_scene, _problem, _scale_of

    from optical_flow_tpu.slam.vi_ba import vi_bundle_adjust

    sc = _make_scene()
    rng = np.random.RandomState(7)
    states = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert = states.copy()
    pert[1:, :3] += rng.randn(len(states) - 1, 3) * 0.01
    pert[1:, 3:6] += rng.randn(len(states) - 1, 3) * 0.02
    pert[:, 6:9] += rng.randn(len(states), 3) * 0.05
    prob = _problem(sc, states=pert, points=sc["X"] + rng.randn(*sc["X"].shape) * 0.02)
    t0 = time.perf_counter()
    out, _ = vi_bundle_adjust(prob, iters=12, lam=1e-4)
    jax.block_until_ready(out.states)
    require(out.states.devices() == {env.gpu} and out.states.dtype == np.float32,
            "solver: not an f32 GPU solve")
    scale, est = _scale_of(np.asarray(out.states), sc)
    say("solver", f"f32 VI-BA on the GPU: {time.perf_counter() - t0:.3f} s incl. compile")
    check("solver", "f32 VI-BA |metric scale - 1|", abs(scale - 1.0), 0.02)
    check("solver", "f32 VI-BA mean center error m",
          float(np.linalg.norm(est - sc["centers"], axis=1).mean()), 0.01)


def phase_four_cards(env):
    """Frames-DP and spatial tiling over four GPUs against one GPU: the
    fast preset's flow and batched video, and the default (faithful)
    streaming loop tiled as the README's spatial tiling sets it up."""
    import jax
    import jax.numpy as jnp

    from optical_flow_tpu import FlowConfig, VideoConfig, coarse_to_fine
    from optical_flow_tpu.parallel import flow_mesh, sharded_coarse_to_fine
    from optical_flow_tpu.pipeline.video import VideoPipeline

    n = len(jax.devices())
    require(n >= 4, f"--four-cards needs 4 GPUs, JAX found {n}")
    cfg = VideoConfig.fast().flow
    pairs = [textured_pair(1080, 1080, 1.0 + 0.3 * i, -0.5, seed=SEED + 10 + i) for i in range(4)]
    a = np.stack([p[0] for p in pairs]).astype(np.float32)
    b = np.stack([p[1] for p in pairs]).astype(np.float32)
    one = jax.jit(lambda x, y: coarse_to_fine(x, y, config=cfg))
    u1, v1 = one(jax.device_put(a, env.gpu), jax.device_put(b, env.gpu))
    for shape in ((4, 1, 1), (1, 2, 2)):
        mesh = flow_mesh(*shape)
        x, y = (a, b) if shape[0] == 4 else (a[0], b[0])
        t0 = time.perf_counter()
        us, vs = jax.jit(lambda p, q: sharded_coarse_to_fine(p, q, mesh, config=cfg))(
            jnp.asarray(x), jnp.asarray(y)
        )
        jax.block_until_ready(us)
        ref_u, ref_v = (u1, v1) if shape[0] == 4 else (u1[0], v1[0])
        say("four", f"mesh {shape}: {time.perf_counter() - t0:.3f} s incl. compile")
        check("four", f"mesh {shape} vs one card: mean EPE px", epe(us, vs, ref_u, ref_v), 1e-3)
        check("four", f"mesh {shape} vs one card: max |du|,|dv| px",
              max(maxdiff(us, ref_u), maxdiff(vs, ref_v)), 1.0)
    frames = video_frames(n=10)
    single = VideoPipeline(VideoConfig.fast()).run_batched(frames)
    dp = VideoPipeline(VideoConfig.fast(), mesh=flow_mesh(frames=4)).run_batched(frames)
    check_flow_bulk("four", "run_batched frames-DP vs one card", dp.u, dp.v,
                    np.asarray(single.u), np.asarray(single.v))
    check_votes("four", "run_batched frames-DP vs one card", dp.gesture.votes, single.gesture.votes)

    faithful = VideoConfig(flow=FlowConfig(warp_clamp=8.0))
    streams = {}
    for label, mesh in (("one card", None), ("mesh (1, 2, 2)", flow_mesh(1, 2, 2))):
        t0 = time.perf_counter()
        res = list(VideoPipeline(faithful, mesh=mesh).run(frames, prefetch=0))
        say("four", f"faithful streaming on {label}: {len(res)} results in "
            f"{time.perf_counter() - t0:.3f} s incl. compile")
        streams[label] = (
            np.stack([np.asarray(r.u) for r in res]),
            np.stack([np.asarray(r.v) for r in res]),
            np.asarray([int(r.gesture.votes) for r in res]),
        )
    ut, vt, votes_t = streams["mesh (1, 2, 2)"]
    ur, vr, votes_r = streams["one card"]
    check_flow_bulk("four", "faithful streaming (1,2,2) vs one card", ut, vt, ur, vr)
    check_votes("four", "faithful streaming (1,2,2) vs one card", votes_t, votes_r)


PHASES = {
    "dense": phase_dense,
    "video": phase_video,
    "served": phase_served,
    "sparse": phase_sparse,
    "solver": phase_solver,
}


def selected_phases(argv):
    """The phase names a command line runs, in order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU phase and its comparison")
    args = ap.parse_args(argv)
    return ["four"] if args.four_cards else list(PHASES)


def main(argv=None) -> int:
    phases = selected_phases(argv)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: {dev.platform})", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    env = Env(jax)
    say("device", f"{dev.platform} {dev.device_kind} x{len(jax.devices())}, jax {jax.__version__}")
    t_all = time.perf_counter()
    if phases == ["four"]:
        phase_four_cards(env)
    else:
        frames = video_frames()
        for name in phases:
            t0 = time.perf_counter()
            if name == "video":
                ug, vg = phase_video(env, frames)
            elif name == "served":
                phase_served(env, frames, ug, vg)
            else:
                PHASES[name](env)
            say(name, f"phase done in {time.perf_counter() - t0:.3f} s")
    say("done", f"all phases in {time.perf_counter() - t_all:.3f} s")
    for line in card_lines():
        print(f"card: {line}", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
