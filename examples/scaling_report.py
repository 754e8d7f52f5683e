#!/usr/bin/env python
"""Scaling-efficiency report: frame-DP batch amortization on the local
device(s), plus the sharded-pyramid compile check over a virtual mesh.

On several GPUs this reports real frames/s per device at 1..N devices; on
one it reports the batch-amortization curve (the dominant production
effect) and validates the multi-device program compiles.

  python examples/scaling_report.py [--size 540] [--iters 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=540)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if getattr(args, 'cpu', False):
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax
    import jax.numpy as jnp

    from optical_flow_tpu import FlowConfig, coarse_to_fine
    from optical_flow_tpu.ops.pyramid import max_pyramid_levels

    n_dev = len(jax.devices())
    H = W = args.size
    levels = max_pyramid_levels((H, W))
    cfg = FlowConfig(levels=levels)

    def run(batch):
        def mk(seed):
            r = np.random.RandomState(seed)
            shape = (batch, H, W) if batch > 1 else (H, W)
            a = (r.rand(*shape)).astype(np.float32)
            return jnp.asarray(a), jnp.asarray(np.roll(a, 2, axis=-1))

        ps = [mk(s) for s in range(2 + args.iters)]
        jax.block_until_ready(ps)
        fn = jax.jit(lambda a, b: coarse_to_fine(a, b, levels, config=cfg))
        jax.block_until_ready([fn(*p) for p in ps[:2]])
        t0 = time.perf_counter()
        jax.block_until_ready([fn(*p) for p in ps[2:]])
        return args.iters * batch / (time.perf_counter() - t0)

    print(f"devices: {n_dev} x {jax.devices()[0].device_kind}; {H}x{W}, {levels} levels")
    base = run(1)
    print(f"batch  fps        speedup  efficiency")
    print(f"{1:5d} {base:10.1f} {1.0:8.2f} {'100%':>10}")
    for batch in (2, 4, 8, 16):
        fps = run(batch)
        print(f"{batch:5d} {fps:10.1f} {fps/base:8.2f} {fps/base/batch:9.0%}")

    if n_dev >= 2:
        from optical_flow_tpu.parallel import flow_mesh, mesh_factorization, sharded_coarse_to_fine

        f, r, c = mesh_factorization(n_dev)
        mesh = flow_mesh(frames=f, rows=r, cols=c)
        rng = np.random.RandomState(0)
        a = rng.rand(H, W).astype(np.float32)
        u, v = sharded_coarse_to_fine(a, np.roll(a, 2, axis=-1), mesh, levels)
        jax.block_until_ready((u, v))
        print(f"sharded pyramid over mesh (frames={f}, rows={r}, cols={c}): OK")


if __name__ == "__main__":
    main()
