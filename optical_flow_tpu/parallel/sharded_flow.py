"""Sharded coarse-to-fine pyramidal flow.

Parallel decomposition (the multi-device answer to the reference's OpenMP
pyramid, ParallelBasicPyr.cpp:587-703 / SURVEY.md P1-P3):

- frame axis: batches of frame pairs are pure data parallelism,
- fine pyramid levels: the LK solve (the dominant cost, 5 window sums +
  solve per pixel) runs spatially tiled via `sharded_lucas_kanade` with
  exact 2-px halo exchange,
- fine-level warps: when `config.warp_clamp` bounds the flow, the remap
  runs spatially tiled too (`sharded_symmetric_warp` — zero-border halo of
  width ceil(clamp/2)+1, global-coordinate quantization for bit-exactness),
- coarse levels and the remaining glue (pyrDown/pyrUp, unclamped warps):
  run as global XLA ops. Under `jit` over the mesh, XLA lays them out from
  the operand shardings and inserts the needed collectives; the coarse
  levels are tiny (a 1080^2 frame's level-3 is 135^2) so replication there
  is the right call, not a compromise.

A level is tiled when its size divides the spatial mesh and tiles stay
>= MIN_TILE; otherwise it runs globally. Results are bit-identical to the
unsharded controller (tests/test_parallel.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
from jax.sharding import Mesh

from optical_flow_tpu.config import FlowConfig
from optical_flow_tpu.flow.lk import lucas_kanade
from optical_flow_tpu.ops.pyramid import gaussian_pyramid
from optical_flow_tpu.ops.warp import symmetric_warp
from optical_flow_tpu.parallel.mesh import AXIS_COLS, AXIS_ROWS
from optical_flow_tpu.parallel.sharded_lk import sharded_lucas_kanade

MIN_TILE = 32  # don't spatially tile levels smaller than this per device


def _tileable(shape, rows_n: int, cols_n: int, min_tile: int) -> bool:
    H, W = shape[-2], shape[-1]
    return (
        H % rows_n == 0
        and W % cols_n == 0
        and H // rows_n >= min_tile
        and W // cols_n >= min_tile
    )


def sharded_coarse_to_fine(
    img1,
    img2,
    mesh: Mesh,
    levels: Optional[int] = None,
    *,
    config: FlowConfig = FlowConfig(),
    min_tile: int = MIN_TILE,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pyramidal dense LK with fine-level solves tiled over the mesh.

    img1/img2: (H, W) or (B, H, W) with B sharded over 'frames'.
    Semantics identical to flow.coarse_to_fine (same reference quirks:
    flow not doubled on pyrUp, symmetric half-flow warps).
    """
    u, v, _, _ = sharded_coarse_to_fine_with_images(
        img1, img2, mesh, levels, config=config, min_tile=min_tile
    )
    return u, v


def sharded_coarse_to_fine_with_images(
    img1,
    img2,
    mesh: Mesh,
    levels: Optional[int] = None,
    *,
    config: FlowConfig = FlowConfig(),
    min_tile: int = MIN_TILE,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Like flow.coarse_to_fine_with_images but mesh-sharded: returns
    (u, v, warped_img1, warped_img2), the finest-level images after the
    last warp — the reference's in-place-mutation contract
    (LKof.cpp:193-226), needed by the video loop's faithful_prev_diff
    feedback (ParallelVideoPyr.cpp:841)."""
    from optical_flow_tpu.flow.coarse_to_fine import _validate_levels

    levels = _validate_levels(levels, img1.shape, config)
    # the pyramid build runs as global XLA ops laid out from the operand
    # shardings — the same pyr_down as the single-device controller
    pyr1 = gaussian_pyramid(img1, levels)
    pyr2 = gaussian_pyramid(img2, levels)
    return sharded_coarse_to_fine_pyramids(
        pyr1, pyr2, mesh, config=config, min_tile=min_tile
    )


def sharded_coarse_to_fine_pyramids(
    pyr1,
    pyr2,
    mesh: Mesh,
    *,
    config: FlowConfig = FlowConfig(),
    min_tile: int = MIN_TILE,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Mesh-sharded pyramidal LK over PREBUILT pyramids (level 0 finest) —
    the streaming-video entry point: each frame's pyramid is built once
    and serves both its flow pairs (pipeline/video.py reuse), now on the
    mesh path too."""
    if len(pyr1) != len(pyr2):
        raise ValueError(f"pyramid depths differ: {len(pyr1)} vs {len(pyr2)}")
    rows_n = mesh.shape[AXIS_ROWS]
    cols_n = mesh.shape[AXIS_COLS]
    from optical_flow_tpu.flow.coarse_to_fine import resolve_warp_impl
    from optical_flow_tpu.flow.pyramid_loop import run_pyramid

    pyr1 = list(pyr1)
    pyr2 = list(pyr2)

    # One warp-impl decision for the whole pyramid, shared with the
    # unsharded controller so sharded == unsharded for any config.
    warp_impl, warp_max_disp = resolve_warp_impl(config)
    halo_k = (
        None if config.warp_clamp is None else int(-(-config.warp_clamp // 2)) + 1
    )

    def solve(i, a, b):
        if _tileable(a.shape, rows_n, cols_n, min_tile):
            return sharded_lucas_kanade(a, b, mesh)
        return lucas_kanade(a, b)

    def warp(i, a, b, u, v):
        if (
            halo_k is not None
            and _tileable(a.shape, rows_n, cols_n, min_tile)
            # the warp halo must fit within one neighbour tile
            and halo_k <= min(a.shape[-2] // rows_n, a.shape[-1] // cols_n)
        ):
            from optical_flow_tpu.parallel.sharded_warp import sharded_symmetric_warp

            return sharded_symmetric_warp(
                a,
                b,
                u,
                v,
                mesh,
                config.warp_clamp,
                quantize=config.quantize_warp,
                impl=warp_impl,
            )
        return symmetric_warp(
            a,
            b,
            u,
            v,
            quantize=config.quantize_warp,
            impl=warp_impl,
            max_disp=warp_max_disp,
        )

    return run_pyramid(pyr1, pyr2, solve, warp, config)
