"""Spatio-temporal gradients fx, fy, ft (reference C1-C3).

The reference computes them as OpenCV ``filter2D`` correlations with 2x2
kernels, default anchor (1,1) and BORDER_REFLECT_101, applied to *both*
frames and summed (LKof.cpp:34-74; identical in all ten variants):

    fx = [[-1,1],[-1,1]] (*) img1 + [[-1,1],[-1,1]] (*) img2
    fy = [[-1,-1],[1,1]] (*) img1 + [[-1,-1],[1,1]] (*) img2
    ft = [[-1,-1],[-1,-1]] (*) img1 + [[1,1],[1,1]] (*) img2

With anchor (1,1) a 2x2 correlation at output pixel (y, x) reads source
pixels (y-1..y, x-1..x); out-of-range reads reflect without repeating the
edge (index -1 -> 1). NOTE: there is no 0.25 normalisation factor (the
Matlab derivation in the reference docs uses one; the C++ does not).

These are shift-and-add chains which XLA fuses with the downstream
products and window sums of the LK level.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from optical_flow_tpu.ops.pad import pad_last2


def _shifted4(img):
    """Return the four 2x2-stencil reads (y-1,x-1), (y-1,x), (y,x-1), (y,x)
    for every output pixel, with REFLECT_101 at the top/left border."""
    p = pad_last2(img, 1, 0, 1, 0, mode="reflect")
    a = p[..., :-1, :-1]  # (y-1, x-1)
    b = p[..., :-1, 1:]   # (y-1, x)
    c = p[..., 1:, :-1]   # (y,   x-1)
    d = p[..., 1:, 1:]    # (y,   x)
    return a, b, c, d


def grad_x(img1, img2):
    """fx: kernel [[-1,1],[-1,1]], both-frame sum (LKof.cpp:34-46)."""
    a1, b1, c1, d1 = _shifted4(img1)
    a2, b2, c2, d2 = _shifted4(img2)
    return (b1 - a1 + d1 - c1) + (b2 - a2 + d2 - c2)


def grad_y(img1, img2):
    """fy: kernel [[-1,-1],[1,1]], both-frame sum (LKof.cpp:48-60)."""
    a1, b1, c1, d1 = _shifted4(img1)
    a2, b2, c2, d2 = _shifted4(img2)
    return (c1 + d1 - a1 - b1) + (c2 + d2 - a2 - b2)


def grad_t(img1, img2):
    """ft: all -1 kernel on img1 plus all +1 kernel on img2 (LKof.cpp:62-74)."""
    a1, b1, c1, d1 = _shifted4(img1)
    a2, b2, c2, d2 = _shifted4(img2)
    return (a2 + b2 + c2 + d2) - (a1 + b1 + c1 + d1)


def spatio_temporal_gradients(img1, img2) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compute (fx, fy, ft) sharing the eight stencil reads.

    Equivalent to grad_x/grad_y/grad_t but with the shifted views computed
    once — the form the fused kernel uses.
    """
    a1, b1, c1, d1 = _shifted4(img1)
    a2, b2, c2, d2 = _shifted4(img2)
    fx = (b1 - a1 + d1 - c1) + (b2 - a2 + d2 - c2)
    fy = (c1 + d1 - a1 - b1) + (c2 + d2 - a2 - b2)
    ft = (a2 + b2 + c2 + d2) - (a1 + b1 + c1 + d1)
    return fx, fy, ft
