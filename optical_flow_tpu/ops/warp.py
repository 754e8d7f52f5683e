"""Bilinear image warping (OpenCV ``remap`` semantics; reference C9 warps).

The reference builds float32 warp maps ``map1 = (x + u/2, y + v/2)``,
``map2 = (x - u/2, y - v/2)`` and remaps *both* frames symmetrically toward
each other with INTER_LINEAR and the default constant-0 border
(LKof.cpp:213-226).

Two parity details:
  - Reference-era OpenCV (and therefore the golden flow fields) quantizes
    float map coordinates to fixed point with 5 fractional bits:
    ``s = round_half_even(coord * 32)``, integer part ``s >> 5``, fraction
    ``(s & 31)/32`` — our default ``quantize=True``. Modern OpenCV (cv2 5.0
    verified) interpolates float images at full float precision instead:
    ``quantize=False`` matches it to ~1e-5. Golden parity requires True.
  - Any of the four bilinear taps falling outside the image contributes 0
    (BORDER_CONSTANT with value 0), it is not clamped.

Implemented as four gathers on flattened indices (XLA lowers these to
one fused gather); `symmetric_warp_shift_sep` is the gather-free separable
form for bounded displacements.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

_INTER_BITS = 5
_INTER_TAB_SIZE = 1 << _INTER_BITS  # 32


def _gather2d(src, yy, xx):
    """src[..., yy, xx] with out-of-range -> 0.

    src: (..., H, W); yy/xx: int32 (..., H2, W2). Batch dims broadcast.
    """
    H, W = src.shape[-2], src.shape[-1]
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    yc = jnp.clip(yy, 0, H - 1)
    xc = jnp.clip(xx, 0, W - 1)
    idx = yc * W + xc
    batch = jnp.broadcast_shapes(src.shape[:-2], idx.shape[:-2])
    out_sp = idx.shape[-2:]
    flat = jnp.broadcast_to(src.reshape(src.shape[:-2] + (H * W,)), batch + (H * W,))
    idxf = jnp.broadcast_to(idx, batch + out_sp).reshape(batch + (out_sp[0] * out_sp[1],))
    vals = jnp.take_along_axis(flat, idxf, axis=-1).reshape(batch + out_sp)
    return jnp.where(ok, vals, jnp.zeros((), src.dtype))


def remap_bilinear(src, map_x, map_y, *, quantize: bool = True, index_offset=(0, 0)):
    """cv2.remap(src, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT 0).

    src: (..., H, W); map_x/map_y: (H2, W2) float (float32 for exact OpenCV
    parity). Returns (..., H2, W2) in src.dtype (integer sources are
    interpolated in float32 and rounded/saturated back, like cv2).

    index_offset (dy, dx) is added to the integer tap indices AFTER
    coordinate quantization — for tiled gathers where the maps are in
    global coordinates but src is a halo-extended local tile. Shifting
    post-quantization keeps fractions bit-identical to a global remap
    (shifting the float maps instead would round differently).
    """
    out_dtype = src.dtype
    is_int = jnp.issubdtype(out_dtype, jnp.integer)
    if is_int:
        src = src.astype(jnp.float32)  # avoid wraparound in tap differences
    compute_dtype = src.dtype
    if quantize:
        sx = jnp.rint(map_x.astype(jnp.float32) * _INTER_TAB_SIZE).astype(jnp.int32)
        sy = jnp.rint(map_y.astype(jnp.float32) * _INTER_TAB_SIZE).astype(jnp.int32)
        ix = sx >> _INTER_BITS
        iy = sy >> _INTER_BITS
        fx = (sx & (_INTER_TAB_SIZE - 1)).astype(compute_dtype) / _INTER_TAB_SIZE
        fy = (sy & (_INTER_TAB_SIZE - 1)).astype(compute_dtype) / _INTER_TAB_SIZE
    else:
        ix = jnp.floor(map_x).astype(jnp.int32)
        iy = jnp.floor(map_y).astype(jnp.int32)
        fx = (map_x - ix).astype(compute_dtype)
        fy = (map_y - iy).astype(compute_dtype)

    dy, dx = index_offset
    iy = iy + jnp.asarray(dy, jnp.int32)
    ix = ix + jnp.asarray(dx, jnp.int32)

    v00 = _gather2d(src, iy, ix)
    v01 = _gather2d(src, iy, ix + 1)
    v10 = _gather2d(src, iy + 1, ix)
    v11 = _gather2d(src, iy + 1, ix + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    out = top + fy * (bot - top)
    if is_int:
        info = jnp.iinfo(out_dtype)
        out = jnp.clip(jnp.rint(out), info.min, info.max).astype(out_dtype)
    return out


def symmetric_warp(
    img1,
    img2,
    u,
    v,
    *,
    quantize: bool = True,
    impl: str = "gather",
    max_disp: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Warp both frames half-way toward each other along flow (u, v).

    img1 samples at (x + u/2, y + v/2); img2 at (x - u/2, y - v/2) —
    LKof.cpp:215-224. Maps are built in float32 like the reference's
    Point2f maps.

    impl='gather' is the exact unbounded path; impl='shift_sep' is the
    gather-free separable O(max_disp) form for a clamped flow
    (|u|,|v| <= 2*max_disp) with flow-space quantization and weights
    shared across the pair (symmetric_warp_shift_sep).
    """
    if impl == "shift_sep" and max_disp <= 0:
        # silent identity otherwise: the shift decomposition clamps
        # displacement to [-2*max_disp, 2*max_disp], so max_disp=0
        # returned both frames UNWARPED with no error (round-5 review)
        raise ValueError(
            f"impl={impl!r} needs max_disp > 0 (the shift "
            "decomposition's displacement bound); got "
            f"{max_disp}"
        )
    if jnp.issubdtype(img1.dtype, jnp.integer):
        # ONE dtype contract across impls (meta-review): integer inputs
        # promote to float32 everywhere — the shift path's fixed-point
        # offsets WRAP in unsigned dtypes, and leaving gather integer
        # made the output dtype depend on backend-driven auto-selection
        img1 = img1.astype(jnp.float32)
        img2 = img2.astype(jnp.float32)
    fu = u.astype(jnp.float32)
    fv = v.astype(jnp.float32)
    hx = fu / jnp.float32(2)
    hy = fv / jnp.float32(2)
    if impl == "shift_sep":
        return symmetric_warp_shift_sep(
            img1, img2, hx, hy, max_disp, quantize=quantize
        )
    if impl != "gather":
        raise ValueError(f"warp impl must be 'gather' or 'shift_sep', got {impl!r}")
    H, W = img1.shape[-2], img1.shape[-1]
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    w1 = remap_bilinear(img1, xs + hx, ys + hy, quantize=quantize)
    w2 = remap_bilinear(img2, xs - hx, ys - hy, quantize=quantize)
    return w1, w2


def quantize_disp(d, max_disp, *, quantize: bool = True):
    """Clamp a displacement field to [-max_disp, max_disp] and optionally
    quantize it in FLOW space: d -> rint(d * 32) / 32.

    Unlike the coordinate-space fixed point of cv2.remap (remap_bilinear
    quantizes x + d), this is position-independent: a tiled warp computes
    identical displacements with no global-coordinate plumbing, and a
    symmetric pair (+d, -d) quantizes to exact negatives, letting both
    warps share one set of hat weights (symmetric_warp_shift_sep). After
    the clip |d| <= max_disp holds EXACTLY (rint(C*32)/32 == C), so hat
    taps k in [-max_disp, max_disp] suffice. Differs from coordinate-space
    quantization by at most 1/32 px at pixels where the f32 rounding of
    (x + d) * 32 lands on the other side of a half-integer — irrelevant
    for the approximation path this serves (the exactness/parity path is
    impl='gather').
    """
    C = float(max_disp)
    d = jnp.clip(d, -C, C)
    if quantize:
        d = jnp.rint(d * _INTER_TAB_SIZE) / _INTER_TAB_SIZE
    return d


def _shift_sep_core(planes, signs, dx_ext, dy, max_disp: int):
    """Separable shift-warp passes over one or more pre-padded planes that
    SHARE the hat weights: plane i samples at signs[i] * d. hat() is even,
    so hat(-d - k) == hat(d - (-k)): the sign flips the tap offset, not
    the weight — each weight plane is computed once per tap.

    planes: sources with margin M = max_disp on both spatial axes.
    dx_ext: x-displacement on the extended rows (H + 2M, W), for sign +1.
    dy:     y-displacement per output pixel (H, W), for sign +1.
    """
    C = int(max_disp)
    M = C
    H, W = dy.shape[-2], dy.shape[-1]
    one = jnp.asarray(1.0, planes[0].dtype)
    batch = jnp.broadcast_shapes(
        *(p.shape[:-2] for p in planes), dx_ext.shape[:-2]
    )
    tmps = [jnp.zeros(batch + (H + 2 * M, W), p.dtype) for p in planes]
    for k in range(-C, C + 1):
        w = jnp.maximum(0.0, one - jnp.abs(dx_ext - k))
        tmps = [
            t + w * p[..., :, M + s * k : M + s * k + W]
            for t, p, s in zip(tmps, planes, signs)
        ]
    outs = [jnp.zeros(batch + (H, W), p.dtype) for p in planes]
    for k in range(-C, C + 1):
        w = jnp.maximum(0.0, one - jnp.abs(dy - k))
        outs = [
            o + w * t[..., M + s * k : M + s * k + H, :]
            for o, t, s in zip(outs, tmps, signs)
        ]
    return outs


def symmetric_shift_sep_sum(p1, p2, dx_ext, dy, max_disp: int):
    """Both symmetric separable shift warps in one pass with shared hat
    weights — the core of the separable shift warp, used by the global
    wrapper (symmetric_warp_shift_sep) and the mesh-tiled warp
    (parallel/sharded_warp.py); one copy so the two stay bit-identical.

    p1/p2: the frames padded (zero, globally) or halo-extended (tiled)
    with margin M = max_disp on both spatial axes. dx_ext/dy: the
    quantize_disp'd half-flow of IMAGE1 (+d); image2 samples at -d via
    reversed tap offsets. Out-of-image rows of dx_ext must be 0 (their
    source rows are zero anyway, so any finite value gives tmp == 0).
    """
    o1, o2 = _shift_sep_core((p1, p2), (1, -1), dx_ext, dy, max_disp)
    return o1, o2


def symmetric_warp_shift_sep(
    img1, img2, hx, hy, max_disp: int, *, quantize: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The separable shift symmetric warp: both frames warped half-way
    toward each other by the separable shift decomposition, sharing hat
    weights (img1 samples at +d, img2 at -d; see symmetric_shift_sep_sum).

    The bilinear warp is a sum over STATIC integer shifts with hat
    weights hat(t) = max(0, 1 - |t|); out-of-image shifts contribute 0
    (remap's BORDER_CONSTANT). The x-pass interpolates each row with the
    OUTPUT pixel's dx and the y-pass then mixes rows whose x-pass used
    THEIR dx, so the form is exact only where dx is constant along y.
    Flow fields here are window-averaged (smooth) and the pyramid's
    residual solves absorb the rest. Measured bounds against the gather
    warp (tests/test_ops.py::TestShiftSepWarp, CPU f32, unit-scale
    random-noise image — worst-case content):
      dx constant along y:                exact to f32 roundoff
      9x9-box-smoothed random flow:       max |err| ~0.21, mean ~0.007
      adversarial dx alternating sign
      every row with fractional dy:       max |err| ~0.48, mean ~0.12

    hx/hy: the HALF-flow (u/2, v/2); |hx|,|hy| beyond max_disp are
    clamped. Tap reach is exactly max_disp, so callers can size it as
    ceil(clamp/2) with no rounding slack (flow-space quantization cannot
    push |d| past the clamp, unlike coordinate-space fixed point).
    """
    C = int(max_disp)
    dx = quantize_disp(hx.astype(jnp.float32), C, quantize=quantize)
    dy = quantize_disp(hy.astype(jnp.float32), C, quantize=quantize)
    pads = [(0, 0)] * (img1.ndim - 2) + [(C, C), (C, C)]
    p1 = jnp.pad(img1, pads)
    p2 = jnp.pad(img2, pads)
    dx_ext = jnp.pad(dx, [(0, 0)] * (dx.ndim - 2) + [(C, C), (0, 0)])
    return symmetric_shift_sep_sum(p1, p2, dx_ext, dy, C)
