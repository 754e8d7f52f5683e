#!/usr/bin/env python
"""Still-image golden regression — serialOrig / SerialPyr on this engine.

Loads the reference's table1/table2 pair (cropped to 640x448, /255 —
serialOrig.cpp:538-545), runs single-level and 7-level pyramidal dense LK,
writes the flow fields in saveMat format, and compares against the golden
files at the reference's own 1e-6 threshold (serialOrig.cpp:588).

  python examples/still_regression.py [--reference /root/reference] [--out /tmp]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default=None)
    ap.add_argument("--out", default=None, help="write U2/V2/UPyr/VPyr .txt dumps here")
    ap.add_argument("--f32", action="store_true", help="run in float32 (the device dtype) and report EPE instead")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend instead of the GPU")
    args = ap.parse_args()
    if getattr(args, 'cpu', False):
        import jax
        jax.config.update('jax_platforms', 'cpu')

    if args.reference:
        os.environ["OPTICAL_FLOW_REFERENCE_DIR"] = args.reference

    import jax

    if not args.f32:
        jax.config.update("jax_platforms", "cpu")  # f64 oracle runs on CPU
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from optical_flow_tpu import coarse_to_fine, lucas_kanade
    from optical_flow_tpu.utils import goldens

    ref = goldens.reference_dir()
    if ref is None:
        sys.exit("reference checkout not found (set --reference)")
    img1, img2 = goldens.load_table_pair()
    dtype = np.float32 if args.f32 else np.float64
    a = jnp.asarray(img1.astype(dtype))
    b = jnp.asarray(img2.astype(dtype))

    u2, v2 = jax.jit(lucas_kanade)(a, b)
    up, vp = jax.jit(coarse_to_fine)(a, b)

    checks = [
        ("U2Test.txt", u2), ("V2Test.txt", v2),
        ("UPyrTest.txt", up), ("VPyrTest.txt", vp),
    ]
    failed = False
    for name, got in checks:
        want = goldens.load_mat(ref / name)
        err = np.abs(np.asarray(got, np.float64) - want)
        if args.f32:
            print(f"{name}: mean EPE {err.mean():.6f} px, max {err.max():.6f} px "
                  f"({'OK' if err.mean() <= 0.1 else 'FAIL'} vs 0.1 px budget)")
            failed |= err.mean() > 0.1
        else:
            ok = err.max() <= 1e-6
            print(f"{name}: max abs err {err.max():.2e} ({'OK' if ok else 'FAIL'} vs 1e-6)")
            failed |= not ok
        if args.out:
            goldens.save_mat(np.asarray(got, np.float64), os.path.join(args.out, name))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
