"""Single-level dense Lucas–Kanade flow (reference C7).

Reference pipeline (LKof.cpp:152-178): fx/fy/ft -> five elementwise products
-> five 3x3 interior window sums -> per-pixel 2x2 Cramer solve with
divide-by-zero -> 0. The reference parallelises this with OpenMP task teams
(3 threads for gradients, 5 for products, 2 for divides —
ParallelVideoPyr.cpp:327-542); here the whole level is one
elementwise+stencil chain that XLA fuses.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from optical_flow_tpu.ops.gradients import spatio_temporal_gradients
from optical_flow_tpu.ops.solve import solve_lk_2x2
from optical_flow_tpu.ops.window import sum3x3_interior


def lucas_kanade(img1, img2) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense optical flow between two same-shaped grayscale images.

    img1/img2: (..., H, W) float arrays. Returns (u, v) with the same shape.
    """
    fx, fy, ft = spatio_temporal_gradients(img1, img2)
    prods = jnp.stack([fx * fx, fy * fy, fx * fy, fx * ft, fy * ft], axis=0)
    sums = sum3x3_interior(prods)
    return solve_lk_2x2(sums[0], sums[1], sums[2], sums[3], sums[4])
