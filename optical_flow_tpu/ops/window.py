"""3x3 window sums (reference C5/C6, `get_Sum9_Mat`).

The reference computes, for every *interior* pixel (i in [1, H-2],
j in [1, W-2]), the sum of the 3x3 neighbourhood, and leaves the one-pixel
border ring at exactly 0 (LKof.cpp:129-137: the result Mat is zero-initialised
and the loops skip the border). The `tmp == 9 else m*9` fallback inside
`get_Sum9` (LKof.cpp:83-127) can never fire for interior pixels, so the
border-ring-zero rule is the complete semantics.

Implemented as a separable shift-add (2 adds per axis instead of 8) with a
static border mask — fuses into the surrounding elementwise chain.
"""

from __future__ import annotations

import jax.numpy as jnp

from optical_flow_tpu.ops.pad import pad_last2


def _box3_rows(x):
    p = pad_last2(x, 1, 1, 0, 0, mode="constant")
    return p[..., :-2, :] + p[..., 1:-1, :] + p[..., 2:, :]


def _box3_cols(x):
    p = pad_last2(x, 0, 0, 1, 1, mode="constant")
    return p[..., :, :-2] + p[..., :, 1:-1] + p[..., :, 2:]


def sum3x3_interior(x):
    """3x3 box sum on the interior; the 1-px border ring is zero.

    The reference calls get_Sum9_Mat five times per LK solve
    (LKof.cpp:164-168); lucas_kanade stacks the five product planes on
    a leading axis so one call vectorises all the shifts.
    """
    s = _box3_cols(_box3_rows(x))
    out = jnp.zeros_like(x)
    return out.at[..., 1:-1, 1:-1].set(s[..., 1:-1, 1:-1])
