"""Padding helpers for the last two (spatial) axes.

OpenCV's default border for filtering is BORDER_REFLECT_101
(``gfedcb|abcdefgh|gfedcba`` — the edge pixel is not repeated), which is
numpy/jnp ``mode='reflect'``. All ops here operate on arrays shaped
``(..., H, W)``; leading axes are batch.
"""

from __future__ import annotations

import jax.numpy as jnp

# Reversing an axis (what jnp.pad mode='reflect' lowers to) is a separate
# reverse op in the HLO.
# For the small pad widths used everywhere here (<= _SMALL), the flip of k
# border lines is written as k single-line slices concatenated in reversed
# order instead: same bytes, no `rev` in the HLO.
_SMALL = 4


def _reflect_small(x, top, bottom, left, right):
    H, W = x.shape[-2], x.shape[-1]
    parts = [x[..., i : i + 1, :] for i in range(top, 0, -1)]
    parts.append(x)
    parts += [x[..., H - 2 - i : H - 1 - i, :] for i in range(bottom)]
    if top or bottom:
        x = jnp.concatenate(parts, axis=-2)
    parts = [x[..., :, j : j + 1] for j in range(left, 0, -1)]
    parts.append(x)
    parts += [x[..., :, W - 2 - j : W - 1 - j] for j in range(right)]
    if left or right:
        x = jnp.concatenate(parts, axis=-1)
    return x


def pad_last2(x, top: int, bottom: int, left: int, right: int, mode: str = "reflect"):
    """Pad the trailing two axes only."""
    if (
        mode == "reflect"
        and max(top, bottom, left, right) <= _SMALL
        and x.shape[-2] > max(top, bottom)
        and x.shape[-1] > max(left, right)
    ):
        return _reflect_small(x, top, bottom, left, right)
    widths = [(0, 0)] * (x.ndim - 2) + [(top, bottom), (left, right)]
    return jnp.pad(x, widths, mode=mode)
