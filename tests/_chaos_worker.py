"""Crash-chaos worker for checkpoint/resume (tests/test_chaos.py).

Runs the streaming video pipeline over a deterministic synthetic clip,
checkpointing after every processed frame and dumping each flow result
atomically. The parent test SIGKILLs this process mid-stream, relaunches
it with --resume, and bit-compares the stitched results against an
uninterrupted run — the recovery contract the reference never had
(SURVEY.md section 5: checkpoint/resume "none").

Usage: python _chaos_worker.py <workdir> [--resume] [--kill-after N]
--kill-after N makes the worker print READY_TO_DIE after frame N and
spin (so the parent's SIGKILL lands at a deterministic point).
"""

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

N_FRAMES = 9


def make_frames():
    r = np.random.RandomState(31)
    base = (r.rand(96, 128, 3) * 255).astype(np.uint8)
    return [np.roll(base, 3 * i, axis=1) for i in range(N_FRAMES)]


def save_result(workdir, idx, result):
    path = os.path.join(workdir, f"flow_{idx:03d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # np.savez(str) would append another .npz
        np.savez(f, u=np.asarray(result.u), v=np.asarray(result.v))
    os.replace(tmp, path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-after", type=int, default=None)
    args = ap.parse_args()

    from optical_flow_tpu.config import FlowConfig, PreprocessConfig, VideoConfig
    from optical_flow_tpu.pipeline import VideoPipeline
    from optical_flow_tpu.utils.checkpoint import load_state, save_state

    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(64, 64)), flow=FlowConfig()
    )
    pipe = VideoPipeline(cfg)
    ckpt = os.path.join(args.workdir, "state.npz")
    start = 0
    if args.resume:
        if os.path.exists(ckpt):
            pipe.restore(load_state(ckpt))
            start = pipe.state()["frame_idx"]
        print(f"RESUMED_AT {start}", flush=True)

    frames = make_frames()
    done = 0
    for i in range(start, len(frames)):
        result = pipe.push(frames[i])
        if result is not None:
            # flow for the pair ending at pushed frame i -> result index i
            save_result(args.workdir, i, result)
            done += 1
        save_state(ckpt, pipe.state())
        print(f"FRAME {i}", flush=True)
        if args.kill_after is not None and i == args.kill_after:
            print("READY_TO_DIE", flush=True)
            time.sleep(120)  # parent SIGKILLs us here
            sys.exit(7)  # must never be reached
    print("STREAM_DONE", flush=True)


if __name__ == "__main__":
    main()
