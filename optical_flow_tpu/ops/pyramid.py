"""Gaussian pyramid ops (reference C8/C10 and OpenCV pyrDown/pyrUp).

pyr_down: separable 5-tap [1,4,6,4,1]/16 filter, BORDER_REFLECT_101, then
take every even row/column — output size is ceil(n/2) (OpenCV semantics).

pyr_up: zero-stuffed 2x upsample convolved with the same kernel scaled by 2
per axis. OpenCV's border handling here is asymmetric (verified numerically
against cv2.pyrUp): out-of-range index -1 reflects to 1 (REFLECT_101) but
index n reflects to n-1 (edge-inclusive). Output is exactly (2H, 2W).

Reference quirk preserved at the call site (flow/coarse_to_fine.py): flow
values are NOT doubled when upsampled between pyramid levels
(LKof.cpp:210-211 pyrUp's the flow with no *2).

max_pyramid_levels: the reference's getMaxLayer (LKof.cpp:230-249) is the
2-adic valuation + 1, min over both dims: 640x448 -> min(8,7) = 7 levels;
1080x1080 -> 4.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp

from optical_flow_tpu.ops.pad import pad_last2

# OpenCV's 5-tap Gaussian, exact binary fractions: [1,4,6,4,1]/16.
_K5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)


def _parity_planes(p, axis):
    """Split `p` into (even, odd) index planes along `axis` via a
    reshape-split; pads one junk row/column when the extent is odd."""
    n = p.shape[axis]
    if n % 2:
        cfg = [(0, 0)] * p.ndim
        cfg[axis] = (0, 1)
        p = jnp.pad(p, cfg)
        n += 1
    if axis == p.ndim - 2:
        s = p.reshape(p.shape[:-2] + (n // 2, 2, p.shape[-1]))
        return s[..., 0, :], s[..., 1, :]
    s = p.reshape(p.shape[:-1] + (n // 2, 2))
    return s[..., 0], s[..., 1]


def _row_pass_poly(x):
    """Polyphase row pass of pyr_down: 5-tap blur evaluated only at the
    kept (even) output rows, via parity planes (no strided slice)."""
    H = x.shape[-2]
    Hc = -(-H // 2)
    p = pad_last2(x, 2, 2, 0, 0, mode="reflect")
    E, O = _parity_planes(p, p.ndim - 2)
    return (
        _K5[0] * E[..., 0:Hc, :]
        + _K5[1] * O[..., 0:Hc, :]
        + _K5[2] * E[..., 1 : Hc + 1, :]
        + _K5[3] * O[..., 1 : Hc + 1, :]
        + _K5[4] * E[..., 2 : Hc + 2, :]
    )


def pyr_down(x):
    """One pyramid level down: 5-tap blur + 2x decimation (cv::pyrDown).

    POLYPHASE: the filter is evaluated ONLY at the kept (even) output
    positions, reading the reflect-padded input through its even/odd
    parity planes —
    out[r] = k0*E[r] + k1*O[r] + k2*E[r+1] + k3*O[r+1] + k4*E[r+2]
    (same tap order as the plain filter, so the result is BIT-identical),
    with no filtering at positions that are then thrown away. Integer
    inputs promote to float32.
    """
    if jnp.issubdtype(jnp.asarray(x).dtype, jnp.integer):
        x = jnp.asarray(x, jnp.float32)
    W = x.shape[-1]
    Wc = -(-W // 2)
    r = _row_pass_poly(x)
    pc = pad_last2(r, 0, 0, 2, 2, mode="reflect")
    Ec, Oc = _parity_planes(pc, pc.ndim - 1)
    return (
        _K5[0] * Ec[..., :, 0:Wc]
        + _K5[1] * Oc[..., :, 0:Wc]
        + _K5[2] * Ec[..., :, 1 : Wc + 1]
        + _K5[3] * Oc[..., :, 1 : Wc + 1]
        + _K5[4] * Ec[..., :, 2 : Wc + 2]
    )


def _pad_pyrup(x):
    """Pad by 1 with OpenCV pyrUp's asymmetric border (-1 -> 1, n -> n-1)."""
    H, W = x.shape[-2], x.shape[-1]
    top = x[..., 1:2, :] if H > 1 else x[..., 0:1, :]
    bot = x[..., H - 1 : H, :]
    x = jnp.concatenate([top, x, bot], axis=-2)
    left = x[..., :, 1:2] if W > 1 else x[..., :, 0:1]
    right = x[..., :, W - 1 : W]
    return jnp.concatenate([left, x, right], axis=-1)


def _pyr_up_stack(x):
    """pyr_up via stack+reshape parity interleaves (CPU-friendly form)."""
    H, W = x.shape[-2], x.shape[-1]
    p = _pad_pyrup(x)  # (..., H+2, W+2), offset 1
    k = tuple(2.0 * v for v in _K5)
    # Rows: even output row 2y reads source rows y-1, y, y+1 with the even
    # kernel taps; odd output row 2y+1 reads rows y, y+1 with the odd taps.
    ev = k[0] * p[..., :-2, :] + k[2] * p[..., 1:-1, :] + k[4] * p[..., 2:, :]
    od = k[1] * p[..., 1:-1, :] + k[3] * p[..., 2:, :]
    rows = jnp.stack([ev, od], axis=-2).reshape(x.shape[:-2] + (2 * H, W + 2))
    evc = k[0] * rows[..., :, :-2] + k[2] * rows[..., :, 1:-1] + k[4] * rows[..., :, 2:]
    odc = k[1] * rows[..., :, 1:-1] + k[3] * rows[..., :, 2:]
    return jnp.stack([evc, odc], axis=-1).reshape(x.shape[:-2] + (2 * H, 2 * W))


def _pyr_up_stuffed(x):
    """pyr_up via zero-stuffing (lax.pad interior) + one 5-tap pass per axis.

    Same taps in the same order as `_pyr_up_stack` (the stuffed zeros add
    exact +0.0 terms), so results are bit-identical up to the sign of zero,
    with no stack/reshape interleave in the HLO.
    """
    from jax import lax

    H, W = x.shape[-2], x.shape[-1]
    p = _pad_pyrup(x)  # (..., H+2, W+2), offset 1
    k = tuple(2.0 * v for v in _K5)
    nd = p.ndim
    zero = jnp.zeros((), x.dtype)
    # Rows: s[2i] = p[i], s covers output positions -2 .. 2H+1 (size 2H+4);
    # output row r sums taps j=0..4 at s[r+j].
    cfg = [(0, 0, 0)] * (nd - 2) + [(0, 1, 1), (0, 0, 0)]
    s = lax.pad(p, zero, cfg)
    rows = sum(kk * s[..., j : j + 2 * H, :] for j, kk in enumerate(k))
    cfg = [(0, 0, 0)] * (nd - 2) + [(0, 0, 0), (0, 1, 1)]
    s = lax.pad(rows, zero, cfg)
    return sum(kk * s[..., :, j : j + 2 * W] for j, kk in enumerate(k))


def _pyr_up_stack_cols_first(x):
    """pyr_up with the COLUMN pass first — same taps, so it matches cv2 at
    f64 roundoff like `_pyr_up_stack`; the column interleave runs at the
    COARSE height (H+2 rows) instead of the doubled height (2H). The
    corrected-mode loop upsamples with it; the rows-first form stays the
    default for the bit-pinned parity path."""
    H, W = x.shape[-2], x.shape[-1]
    p = _pad_pyrup(x)  # (..., H+2, W+2), offset 1
    k = tuple(2.0 * v for v in _K5)
    evc = k[0] * p[..., :, :-2] + k[2] * p[..., :, 1:-1] + k[4] * p[..., :, 2:]
    odc = k[1] * p[..., :, 1:-1] + k[3] * p[..., :, 2:]
    cols = jnp.stack([evc, odc], axis=-1).reshape(x.shape[:-2] + (H + 2, 2 * W))
    ev = k[0] * cols[..., :-2, :] + k[2] * cols[..., 1:-1, :] + k[4] * cols[..., 2:, :]
    od = k[1] * cols[..., 1:-1, :] + k[3] * cols[..., 2:, :]
    return jnp.stack([ev, od], axis=-2).reshape(x.shape[:-2] + (2 * H, 2 * W))


def pyr_up(x):
    """One pyramid level up to exactly (2H, 2W) (cv::pyrUp)."""
    return _pyr_up_stack(x)


def pyr_up_cols_first(x):
    """`pyr_up` with the column pass first (see _pyr_up_stack_cols_first) —
    the corrected-mode production upsample; use `pyr_up` where parity with
    the pinned rows-first float rounding matters."""
    return _pyr_up_stack_cols_first(x)


def gaussian_pyramid(img, levels: int) -> List[jnp.ndarray]:
    """n-level pyramid; level 0 is the input itself (LKof.cpp:180-189)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def max_pyramid_levels(shape: Tuple[int, int]) -> int:
    """Reference getMaxLayer: min over dims of (2-adic valuation + 1)."""

    def v2_plus1(n: int) -> int:
        p = 1
        while n % (1 << p) == 0:
            p += 1
        return p

    h, w = int(shape[-2]), int(shape[-1])
    if h <= 0 or w <= 0:
        raise ValueError(f"image dimensions must be positive, got {h}x{w}")
    return min(v2_plus1(w), v2_plus1(h))
