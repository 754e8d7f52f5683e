"""Coarse-to-fine pyramidal flow controller (reference C9).

Reference loop (LKof.cpp:191-228, SerialPyr.cpp:157-194), for level
i = levels-1 .. 0:
  (a) dense LK at level i -> (tmpu, tmpv);
  (b) if not coarsest: tmpu += upu, tmpv += upv (upsampled coarser flow);
  (c) if i == 0: emit (tmpu, tmpv) and stop;
  (d) upu = pyrUp(tmpu) — flow values are deliberately NOT doubled
      (a quirk of the reference carried into every variant);
  (e) warp both level i-1 images along (upu, upv) and replace them in the
      pyramid (the reference's map construction drives the frames APART —
      see FlowConfig.mode for the displacement-true 'corrected' variant).

The reference mutates the pyramids in place, and pyramid level 0 aliases the
caller's images (getGaussianPyramid pushes the input Mat header,
LKof.cpp:182), so the caller's images end up warped. Here the controller is
functional; `coarse_to_fine_with_images` additionally returns the warped
finest-level images for callers that rely on that aliasing (the video loop
keeps the warped diff as the next prevDiff, ParallelVideoPyr.cpp:841).

The level loop itself lives in flow/pyramid_loop.py, shared with the
mesh-sharded controller. Shapes are static per level, so under `jax.jit`
the loop unrolls into one fused program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from optical_flow_tpu.config import FlowConfig
from optical_flow_tpu.flow.lk import lucas_kanade
from optical_flow_tpu.flow.pyramid_loop import run_pyramid
from optical_flow_tpu.ops.pyramid import gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu.ops.warp import symmetric_warp


def resolve_warp_impl(config: FlowConfig):
    """(impl, max_disp) for symmetric_warp from a FlowConfig — the one
    place a warp form is chosen, the same on every backend.

    'auto' is the separable shift warp when the flow is clamped (on one
    H100 it beat the gather warp in the fast preset at 1080^2, see
    scripts/path_timings.py) and the exact gather otherwise. shift_sep
    reaches half the clamped flow; flow-space quantization keeps
    |d| <= clamp/2 exactly, so no rounding slack is needed
    (ops/warp.py quantize_disp).
    """
    impl = config.warp_impl
    if impl == "auto":
        impl = "shift_sep" if config.warp_clamp is not None else "gather"
    if impl == "shift_sep":
        if config.warp_clamp is None:
            raise ValueError(f"warp_impl={impl!r} requires warp_clamp (bounded reach)")
        return impl, int(-(-config.warp_clamp // 2))
    if impl != "gather":
        raise ValueError(
            f"warp_impl must be 'gather', 'shift_sep' or 'auto', got {impl!r}"
        )
    return "gather", 0


def _validate_levels(levels: Optional[int], shape, config: FlowConfig) -> int:
    if levels is None:
        levels = config.levels or max_pyramid_levels(shape)
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    max_levels = max_pyramid_levels(shape)
    if levels > max_levels:
        # pyr_up(ceil(n/2)) only matches n when n is even, so depth is
        # bounded by the 2-adic valuation (the reference's getMaxLayer).
        raise ValueError(
            f"levels={levels} too deep for {shape[-2]}x{shape[-1]} "
            f"(max {max_levels}, LKof.cpp:230-249 getMaxLayer)"
        )
    return levels


def coarse_to_fine_pyramids(
    pyr1,
    pyr2,
    *,
    config: FlowConfig = FlowConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pyramidal LK over PREBUILT Gaussian pyramids (lists/tuples, level 0
    finest). Streaming video reuses each frame's pyramid for two
    consecutive pairs (pipeline/video.py), and batched mode solves N-2
    pairs from N single pyramids — `coarse_to_fine` is this plus
    `gaussian_pyramid` on both images.
    """
    if len(pyr1) != len(pyr2):
        raise ValueError(f"pyramid depths differ: {len(pyr1)} vs {len(pyr2)}")

    def solve(_i, a, b):
        return lucas_kanade(a, b)

    warp_impl, max_disp = resolve_warp_impl(config)

    def warp(_i, a, b, u, v):
        return symmetric_warp(
            a, b, u, v, quantize=config.quantize_warp, impl=warp_impl, max_disp=max_disp
        )

    return run_pyramid(list(pyr1), list(pyr2), solve, warp, config)


def coarse_to_fine_with_images(
    img1,
    img2,
    levels: Optional[int] = None,
    *,
    config: FlowConfig = FlowConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pyramidal LK; returns (u, v, warped_img1, warped_img2).

    warped_img1/2 are the finest-level images after the last LEVEL warp —
    what the reference leaves in the caller's Mats via in-place pyramid
    mutation. Caveat (round-5 review): with `level_iters > 1` the extra
    refinement passes re-warp the ORIGINAL frames and discard the
    results, so the returned images reflect the first finest-level warp
    only (and with levels == 1 no warp at all). The reference has no
    level_iters, so the in-place contract is defined by the single-pass
    semantics; consumers of the warped frames (faithful_prev_diff) use
    reference mode, which rejects level_iters > 1.
    """
    levels = _validate_levels(levels, img1.shape, config)
    pyr1 = gaussian_pyramid(img1, levels)
    pyr2 = gaussian_pyramid(img2, levels)
    return coarse_to_fine_pyramids(pyr1, pyr2, config=config)


def coarse_to_fine(
    img1,
    img2,
    levels: Optional[int] = None,
    *,
    config: FlowConfig = FlowConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pyramidal dense LK flow; returns (u, v)."""
    u, v, _, _ = coarse_to_fine_with_images(img1, img2, levels, config=config)
    return u, v
