"""Frame preprocessing ops (reference C11, ParallelVideoPyr.cpp:780-820).

Reference chain per frame (all OpenCV, mostly uint8):

    resize(frame, 1080x1080, INTER_CUBIC)
    GaussianBlur(9x9, sigma 1.5)            [uint8 BGR]
    cvtColor(BGR2GRAY)                      [uint8]
    diff = cur - LEARNING_RATE * prevGray   [uint8 saturating, round-half-even]
    threshold(diff, DIFF_THRESH, 255, THRESH_TOZERO)
    Sobel(diff, CV_64F, dx) + Sobel(diff, CV_64F, dy)   [ksize 3, REFLECT_101]
    dilate(3x3 rect, 2 iters); erode(3x3 rect, 2 iters)

Design notes:
- resize is expressed as two dense matmuls (row matrix @ image @ col matrix)
  built from the exact OpenCV bicubic (A = -0.75) tap weights — matmul work, no
  gathers; pinned to HIGHEST precision so no TF32 rounding enters.
- blur/Sobel are separable shift-add chains that XLA fuses; in fast mode
  the blur precomposes onto the resize matrices outright.
- morphology is separable shifted-slice max/min chains with +-inf border
  — exactly OpenCV's border-ignoring default
  (morphologyDefaultBorderValue), and XLA fuses the chains where a
  `reduce_window` would round-trip HBM per pass.
- `faithful_uint8=True` reproduces OpenCV's uint8 saturating round-half-even
  arithmetic between stages (parity tests vs cv2); False keeps everything in
  float32 — the fast path, visually identical.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from optical_flow_tpu.config import PreprocessConfig
from optical_flow_tpu.ops.pad import pad_last2

_CUBIC_A = -0.75  # OpenCV's bicubic parameter


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """OpenCV interpolateCubic tap weights for fraction t in [0,1): taps at
    floor(x)-1 .. floor(x)+2."""
    A = _CUBIC_A
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    s = 1 - t
    w2 = ((A + 2) * s - (A + 3)) * s * s + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) dense bicubic resampling matrix, OpenCV coordinate
    mapping fx = (i+0.5)*n_in/n_out - 0.5 with source-index clamping."""
    scale = n_in / n_out
    fx = (np.arange(n_out) + 0.5) * scale - 0.5
    ix = np.floor(fx).astype(np.int64)
    t = fx - ix
    w = _cubic_weights(t)  # (n_out, 4)
    M = np.zeros((n_out, n_in), dtype=np.float32)
    for tap in range(4):
        src = np.clip(ix - 1 + tap, 0, n_in - 1)
        np.add.at(M, (np.arange(n_out), src), w[:, tap].astype(np.float32))
    return M


def _saturate_u8(x):
    """OpenCV saturate_cast<uchar> with cvRound (round half to even)."""
    return jnp.clip(jnp.rint(x), 0, 255).astype(jnp.uint8)


def resize_cubic(img, size: Tuple[int, int], *, as_uint8: Optional[bool] = None):
    """cv2.resize(img, (W,H), INTER_CUBIC) for (..., H, W) or (H, W, C).

    size is (height, width). Channel-last 3-D inputs are handled like
    OpenCV color frames. Output dtype matches input (uint8 saturates).
    """
    chan_last = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    x = jnp.moveaxis(img, -1, 0) if chan_last else img
    h_out, w_out = size
    Mr = jnp.asarray(_resize_matrix(x.shape[-2], h_out))
    Mc = jnp.asarray(_resize_matrix(x.shape[-1], w_out))
    xf = x.astype(jnp.float32)
    y = jnp.einsum("oh,...hw,pw->...op", Mr, xf, Mc, precision=lax.Precision.HIGHEST)
    if as_uint8 or (as_uint8 is None and img.dtype == jnp.uint8):
        y = _saturate_u8(y)
    elif jnp.issubdtype(img.dtype, jnp.integer):
        # non-saturating request on ANY integer input: the caller wants
        # the raw float samples — a bare astype would WRAP bicubic
        # overshoot (-3 -> 253 for uint8, 65533 for uint16) with
        # backend-defined results (round-5 review + meta-review)
        y = y.astype(jnp.float32)
    else:
        y = y.astype(img.dtype)
    return jnp.moveaxis(y, 0, -1) if chan_last else y


# OpenCV getGaussianKernel: sigma <= 0 with odd ksize <= 7 selects fixed
# binomial taps (small_gaussian_tab), NOT the sigma-from-ksize formula.
_SMALL_GAUSSIAN_TAB = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


@lru_cache(maxsize=16)
def _gauss_taps(ksize: int, sigma: float) -> Tuple[float, ...]:
    """cv2.getGaussianKernel taps (float64, normalized)."""
    if sigma <= 0:
        if ksize % 2 == 1 and ksize in _SMALL_GAUSSIAN_TAB:
            return _SMALL_GAUSSIAN_TAB[ksize]
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return tuple((k / k.sum()).tolist())


def gaussian_blur(img, ksize: int = 9, sigma: float = 1.5, *, faithful_uint8: bool = True):
    """cv2.GaussianBlur(ksize x ksize, sigma), BORDER_REFLECT_101.

    Accepts (..., H, W) or channel-last (H, W, C). uint8 inputs saturate-round
    on output when faithful_uint8.
    """
    chan_last = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    x = jnp.moveaxis(img, -1, 0) if chan_last else img
    is_u8 = img.dtype == jnp.uint8
    xf = x.astype(jnp.float32)
    taps = _gauss_taps(ksize, sigma)
    r = ksize // 2
    H, W = xf.shape[-2], xf.shape[-1]
    p = pad_last2(xf, r, r, 0, 0, mode="reflect")
    xf = sum(t * p[..., i : i + H, :] for i, t in enumerate(taps))
    p = pad_last2(xf, 0, 0, r, r, mode="reflect")
    xf = sum(t * p[..., :, j : j + W] for j, t in enumerate(taps))
    if is_u8 and faithful_uint8:
        y = _saturate_u8(xf)
    elif jnp.issubdtype(img.dtype, jnp.integer):
        y = xf  # float samples: never wrap-cast overshoot back to ints
    else:
        y = xf.astype(img.dtype)
    return jnp.moveaxis(y, 0, -1) if chan_last else y


def bgr_to_gray(img):
    """cvtColor(CV_BGR2GRAY) on (..., 3).

    uint8: fixed-point BT.601 with 15-bit coefficients (R 9798, G 19235,
    B 3735, +2^14 >> 15) — verified exact against cv2 5.0.
    float: plain BT.601 weights, like OpenCV's float path.
    """
    if img.dtype == jnp.uint8:
        b = img[..., 0].astype(jnp.int32)
        g = img[..., 1].astype(jnp.int32)
        r = img[..., 2].astype(jnp.int32)
        return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(
            jnp.uint8
        )
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b).astype(img.dtype)


def temporal_diff(cur, prev, learning_rate: float = 0.3, *, faithful_uint8: bool = True):
    """diff = cur - learning_rate * prev (ParallelVideoPyr.cpp:803).

    On uint8 OpenCV evaluates the Mat expression in double and
    saturate_casts back to uint8 (round half to even).
    """
    d = cur.astype(jnp.float32) - jnp.float32(learning_rate) * prev.astype(jnp.float32)
    if faithful_uint8 and cur.dtype == jnp.uint8:
        return _saturate_u8(d)
    return d


def threshold_tozero(x, thresh: float):
    """cv2.threshold(..., THRESH_TOZERO): keep x where x > thresh else 0."""
    return jnp.where(x > jnp.asarray(thresh, x.dtype), x, jnp.zeros((), x.dtype))


def sobel3(img, dx: int, dy: int, out_dtype=jnp.float32):
    """cv2.Sobel(img, ddepth, dx, dy, ksize=3), BORDER_REFLECT_101.

    Separable: d/dx = smooth[1,2,1] rows x diff[-1,0,1] cols (and transposed
    for d/dy). Reference calls with (1,0) and (0,1) into CV_64F
    (ParallelVideoPyr.cpp:809-810); f32 is the device default here.
    """
    x = img.astype(out_dtype)
    H, W = x.shape[-2], x.shape[-1]

    def rows(v, taps):
        p = pad_last2(v, 1, 1, 0, 0, mode="reflect")
        return sum(t * p[..., i : i + H, :] for i, t in enumerate(taps) if t)

    def cols(v, taps):
        p = pad_last2(v, 0, 0, 1, 1, mode="reflect")
        return sum(t * p[..., :, j : j + W] for j, t in enumerate(taps) if t)

    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    if (dx, dy) == (1, 0):
        return cols(rows(x, smooth), diff)
    if (dx, dy) == (0, 1):
        return rows(cols(x, smooth), diff)
    raise ValueError(f"unsupported (dx, dy) = {(dx, dy)}")


def _morph3x3(x, mode: str, iterations: int):
    if iterations <= 0:
        return x
    if jnp.issubdtype(x.dtype, jnp.integer):
        info = jnp.iinfo(x.dtype)
        init = info.min if mode == "max" else info.max
    else:
        init = -jnp.inf if mode == "max" else jnp.inf
    op = jnp.maximum if mode == "max" else jnp.minimum
    nb = x.ndim - 2
    # n iterated 3x3 dilations/erosions == ONE (2n+1)-square pass (max/min
    # are associative and the identity padding never wins), and that pass
    # runs as SEPARABLE SHIFTED-SLICE max/min chains rather than
    # lax.reduce_window: XLA fuses elementwise op chains into one loop
    # fusion but keeps each reduce_window a separate HBM round-trip
    # (bit-identical)
    k = 2 * iterations + 1
    r = iterations
    H, W = x.shape[-2], x.shape[-1]
    pad_rows = [(0, 0)] * nb + [(r, r), (0, 0)]
    pad_cols = [(0, 0)] * nb + [(0, 0), (r, r)]
    p = jnp.pad(x, pad_rows, constant_values=init)
    y = p[..., 0:H, :]
    for i in range(1, k):
        y = op(y, p[..., i : i + H, :])
    p = jnp.pad(y, pad_cols, constant_values=init)
    y = p[..., :, 0:W]
    for i in range(1, k):
        y = op(y, p[..., :, i : i + W])
    return y


def dilate3x3(x, iterations: int = 1):
    """cv2.dilate with default 3x3 rect kernel; border ignored (max over
    in-bounds pixels), matching morphologyDefaultBorderValue."""
    return _morph3x3(x, "max", iterations)


def erode3x3(x, iterations: int = 1):
    """cv2.erode with default 3x3 rect kernel (min over in-bounds)."""
    return _morph3x3(x, "min", iterations)


@lru_cache(maxsize=64)
def _resize_blur_matrix(n_in: int, n_out: int, ksize: int, sigma: float) -> np.ndarray:
    """(n_out, n_in) one-axis operator for blur(resize(x)): the 1-D
    Gaussian (BORDER_REFLECT_101) composed onto the bicubic resampling
    matrix. Row ops and column ops commute, so
    B_r (M_r x M_c^T) B_c^T = (B_r M_r) x (B_c M_c)^T — the separable
    9-tap blur disappears into the resize matmuls for free."""
    M = _resize_matrix(n_in, n_out).astype(np.float64)
    taps = np.asarray(_gauss_taps(ksize, sigma), np.float64)
    r = ksize // 2
    B = np.zeros((n_out, n_out), np.float64)
    idx = np.arange(n_out)
    for j, w in enumerate(taps):
        src = np.abs(idx + j - r)  # REFLECT_101: -k -> k
        src = np.where(src >= n_out, 2 * (n_out - 1) - src, src)
        np.add.at(B, (idx, src), w)
    return (B @ M).astype(np.float32)


@lru_cache(maxsize=64)
def _banded_factors(n_in: int, n_out: int, ksize: int, sigma: float, tile: int):
    """Block-banded split of the (n_out, n_in) fused resize+blur operator.

    The operator is ~13-banded (bicubic tap spread of 4 composed with the
    (ksize)-tap blur), so the dense matmul wastes ~60x the FLOPs; tiling
    the OUTPUT axis by `tile` and slicing the input slab each tile
    actually reads keeps matmul-friendly shapes while cutting compiled
    FLOPs ~5-6x; the banded and dense forms agree with the f64 oracle to
    the same f32 roundoff.

    Returns ((nt, tile, width) per-tile weights, per-tile input starts)."""
    M = _resize_blur_matrix(n_in, n_out, ksize, sigma)
    nt = -(-n_out // tile)
    starts, width = [], 0
    for t in range(nt):
        rows = M[t * tile : (t + 1) * tile]
        nz = np.nonzero(np.abs(rows).sum(0) > 0)[0]
        starts.append(int(nz.min()))
        width = max(width, int(nz.max() - nz.min() + 1))
    width = min(-(-width // 64) * 64, n_in)
    starts = [min(s, n_in - width) for s in starts]
    W = np.zeros((nt, tile, width), np.float32)
    for t in range(nt):
        rows = M[t * tile : (t + 1) * tile]
        W[t, : rows.shape[0]] = rows[:, starts[t] : starts[t] + width]
    return W, tuple(starts)


def _resize_blur_f32(x, size: Tuple[int, int], ksize: int, sigma: float,
                     tile: int = 128):
    """Fused resize_cubic + gaussian_blur for channel-free float input
    (fast-mode gray planes, (..., H, W)) — block-banded on both axes
    (_banded_factors). The faithful uint8 path keeps the dense
    resize_cubic: its per-stage rounding is pinned bit-level and must not
    see a different f32 accumulation order."""
    h_out, w_out = size
    x = x.astype(jnp.float32)
    Wr, sr = _banded_factors(x.shape[-2], h_out, ksize, sigma, tile)
    Wrj = jnp.asarray(Wr)
    rows = jnp.concatenate(
        [
            jnp.einsum(
                "ij,...jw->...iw", Wrj[t], x[..., s : s + Wr.shape[2], :],
                precision=lax.Precision.HIGHEST,
            )
            for t, s in enumerate(sr)
        ],
        axis=-2,
    )[..., :h_out, :]
    Wc, sc = _banded_factors(x.shape[-1], w_out, ksize, sigma, tile)
    Wcj = jnp.asarray(Wc)
    return jnp.concatenate(
        [
            jnp.einsum(
                "ij,...hj->...hi", Wcj[t], rows[..., s : s + Wc.shape[2]],
                precision=lax.Precision.HIGHEST,
            )
            for t, s in enumerate(sc)
        ],
        axis=-1,
    )[..., :w_out]


def preprocess_frame(frame_bgr, config: PreprocessConfig = PreprocessConfig()):
    """resize -> blur -> gray: the per-frame head of the reference chain
    (ParallelVideoPyr.cpp:782-793). Returns uint8 (or f32) grayscale.

    In float mode resize (cubic), blur, and BT.601 gray are all LINEAR, so
    the whole head commutes and contracts: gray runs FIRST (one channel of
    work instead of three) and the separable blur folds into the resize
    matmuls (_resize_blur_matrix) — zero marginal cost;
    f32-roundoff-level difference, pinned in tests. The faithful uint8
    path keeps the reference's order: its per-stage rounding/saturation
    is nonlinear and order-sensitive.
    """
    x = frame_bgr
    if not config.faithful_uint8:
        if x.dtype == jnp.uint8:
            # fast mode's contract is "do everything in float32"; without
            # this cast a uint8 frame would re-saturate after the resize
            x = x.astype(jnp.float32)
        if x.ndim >= 3 and x.shape[-1] in (3, 4):
            # BGRA: cvtColor(BGR2GRAY) ignores alpha; drop it before gray
            # (ADVICE r3: a 4-channel frame previously fell through and
            # was silently resampled as a (W, 4) image). A last dim not in
            # (1, 3, 4) is a batched-grayscale width, not channels — same
            # heuristic as resize_cubic/gaussian_blur.
            x = bgr_to_gray(x[..., :3])
        elif x.ndim >= 3 and x.shape[-1] == 1:
            x = x[..., 0]
        return _resize_blur_f32(
            x, config.size, config.blur_ksize, config.blur_sigma
        )
    x = resize_cubic(x, config.size)
    x = gaussian_blur(
        x, config.blur_ksize, config.blur_sigma, faithful_uint8=config.faithful_uint8
    )
    if x.ndim >= 3 and x.shape[-1] in (1, 3, 4):
        x = bgr_to_gray(x)
    return x


def diff_features(cur_gray, prev_gray, config: PreprocessConfig = PreprocessConfig()):
    """gray pair -> flow-ready feature map: temporal diff, threshold,
    Sobel x+y, dilate^2, erode^2 (ParallelVideoPyr.cpp:803-814).
    Output is float32 (reference: CV_64F)."""
    d = temporal_diff(
        cur_gray, prev_gray, config.learning_rate, faithful_uint8=config.faithful_uint8
    )
    d = threshold_tozero(d, config.diff_thresh)
    d = sobel3(d, 1, 0) + sobel3(d, 0, 1)
    d = dilate3x3(d, config.morph_iterations)
    d = erode3x3(d, config.morph_iterations)
    return d
