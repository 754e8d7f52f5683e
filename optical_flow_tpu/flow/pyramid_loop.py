"""The shared coarse-to-fine level loop.

Both controllers — single-device (flow/coarse_to_fine.py) and
mesh-sharded (parallel/sharded_flow.py) — run exactly this loop; they
differ only in HOW a level is solved and warped, injected as callables.
Keeping one copy keeps the two modes ('reference' parity vs 'corrected'
displacement-true) and level_iters semantics from drifting apart.

solve(level_index, img1, img2) -> (u, v)
warp(level_index, img1, img2, u, v) -> (w1, w2)   # symmetric half-flow
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import jax.numpy as jnp

from optical_flow_tpu.config import FlowConfig
from optical_flow_tpu.ops.pyramid import pyr_up, pyr_up_cols_first


def run_pyramid(
    pyr1: List[jnp.ndarray],
    pyr2: List[jnp.ndarray],
    solve: Callable,
    warp: Callable,
    config: FlowConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (u, v, finest_img1, finest_img2) per the reference's
    in-place-mutation contract (LKof.cpp:191-228)."""
    if config.mode not in ("reference", "corrected"):
        raise ValueError(
            f"mode must be 'reference' or 'corrected', got {config.mode!r}"
        )
    corrected = config.mode == "corrected"
    if config.level_iters > 1 and not corrected:
        # In reference mode the accumulated flow is not displacement (and
        # the reference warp diverges frames), so re-warping by it makes
        # every extra pass WORSE (verified: 5x EPE on a 1.3 px translation).
        raise ValueError(
            "level_iters > 1 requires mode='corrected' (reference-mode flow "
            "is not displacement; re-warping by it diverges)"
        )
    levels = len(pyr1)
    orig1 = list(pyr1)
    orig2 = list(pyr2)

    def _clamped(u, v):
        if config.warp_clamp is None:
            return u, v
        c = config.warp_clamp
        return jnp.clip(u, -c, c), jnp.clip(v, -c, c)

    for i in range(levels - 1, -1, -1):
        if i == levels - 1:
            u, v = solve(i, pyr1[i], pyr2[i])
        else:
            if corrected:
                # standard pyramidal LK: coordinates double between levels,
                # and the warp must bring the frames TOGETHER (the
                # reference's symmetric warp — img1 sampled at x + u/2,
                # img2 at x - u/2 — INCREASES their separation for positive
                # flow; a faithful quirk in 'reference' mode, negated here)
                upu = 2.0 * pyr_up_cols_first(u)
                upv = 2.0 * pyr_up_cols_first(v)
                wu, wv = _clamped(upu, upv)
                wu, wv = -wu, -wv
            else:
                upu = pyr_up(u)  # flow NOT doubled: faithful to the reference
                upv = pyr_up(v)
                wu, wv = _clamped(upu, upv)
            pyr1[i], pyr2[i] = warp(i, pyr1[i], pyr2[i], wu, wv)
            du, dv = solve(i, pyr1[i], pyr2[i])
            # accumulation stays UNCLAMPED (round-5 review candidate,
            # measured and REJECTED): the coarse estimate is the best
            # information available beyond the warp clamp — accumulating
            # clip(upu) + du instead was measured WORSE on the
            # translation ladder (EPE 1.59 -> 2.69 at (10, 8) px motion,
            # clamp 8), because when the coarse level has already caught
            # the full motion, clamping the accumulation discards real
            # flow that du (small-motion LK) cannot re-measure. The
            # level_iters loop below is the place the inconsistency
            # genuinely compounds, and is fixed there.
            u = du + upu
            v = dv + upv
        # optional extra warp-and-solve passes at this level (level_iters=1
        # is the reference's single pass and the golden-parity mode)
        for _ in range(config.level_iters - 1):
            wu, wv = _clamped(u, v)
            if corrected:
                wu, wv = -wu, -wv  # convergent warp (see mode note above)
            w1, w2 = warp(i, orig1[i], orig2[i], wu, wv)
            du, dv = solve(i, w1, w2)
            # accumulation intentionally UNCLAMPED here too (round-5
            # review candidate, measured and rejected in BOTH positions:
            # clip(u) + du gave translation-ladder EPE 2.37/2.53 at
            # (10, 8) px motion for level_iters 2/3 vs 1.45/1.84 for
            # u + du, clamp 8 — the clamped form discards established
            # beyond-clamp flow that small-motion LK cannot re-measure)
            u = u + du
            v = v + dv
        if i == 0:
            return u, v, pyr1[0], pyr2[0]
    raise AssertionError("unreachable")
