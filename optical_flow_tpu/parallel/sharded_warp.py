"""Spatially-sharded symmetric warp (the pyramid's remap step, tiled).

The warp gather's reach is unbounded in principle (SURVEY.md section 7
'hard parts'), so tiling requires bounding it: flow used for warping is
clamped to `max_disp` (FlowConfig.warp_clamp — applied identically in the
unsharded controller, so the tiled warp reproduces the single-device warp
bit for bit for any clamp value). The halo width is then

    k = ceil(max_disp / 2) + 1      (half-flow warp + bilinear tap;
                                     shift_sep: no +1 — flow-space
                                     quantization adds no rounding slack)

Global borders are zero-filled (cv2.remap BORDER_CONSTANT 0 — any tap off
the image contributes 0, see ops/warp.py), and tile-local coordinates are
offset by k, which shifts the fixed-point tap indices by an exact integer
and leaves fractions untouched — gather taps and arithmetic are identical
to the unsharded remap (verified bit-exact in tests/test_parallel.py).

This is the image-domain analogue of ring attention's neighbour exchange
(SURVEY.md section 5): per level, each device exchanges only an
O(max_disp) strip with its mesh neighbours instead of all-gathering frames.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from optical_flow_tpu.ops.warp import (
    quantize_disp,
    remap_bilinear,
    symmetric_shift_sep_sum,
)
from optical_flow_tpu.parallel.halo import exchange_halo, exchange_halo_rows
from optical_flow_tpu.parallel.mesh import AXIS_COLS, AXIS_FRAMES, AXIS_ROWS

shard_map = jax.shard_map


def _warp_tile(img1, img2, u, v, *, k, rows_n, cols_n, quantize, impl):
    e1 = exchange_halo(img1, k, rows_n=rows_n, cols_n=cols_n, border="zero")
    e2 = exchange_halo(img2, k, rows_n=rows_n, cols_n=cols_n, border="zero")
    h, w = img1.shape[-2], img1.shape[-1]
    hx = u.astype(jnp.float32) / jnp.float32(2)
    hy = v.astype(jnp.float32) / jnp.float32(2)
    if impl == "shift_sep":
        # Separable shift tile warp: flow-space quantization
        # (ops/warp.py quantize_disp) is position-independent, so the tile
        # computes the same displacements as the global warp with NO
        # global-coordinate plumbing; the halo width equals the tap reach
        # (margin M = k), and the separable x-pass runs over the halo rows
        # too, so it needs the NEIGHBOUR rows' displacement field (zero at
        # global borders, where the source rows are zero anyway). Weights,
        # taps and sum order are `symmetric_warp_shift_sep`'s bit for bit.
        dx = quantize_disp(hx, k, quantize=quantize)
        dy = quantize_disp(hy, k, quantize=quantize)
        dx_ext = exchange_halo_rows(dx, k, rows_n=rows_n, border="zero")
        return symmetric_shift_sep_sum(e1, e2, dx_ext, dy, k)

    if impl != "gather":
        raise ValueError(f"unknown tiled warp impl {impl!r}")
    # Maps are built in GLOBAL coordinates (same f32 arithmetic as the
    # unsharded warp — adding the tile offset before quantization would
    # round differently); tap indices shift to tile-local + halo AFTER
    # quantization, an exact integer op.
    row0 = jax.lax.axis_index(AXIS_ROWS) * h
    col0 = jax.lax.axis_index(AXIS_COLS) * w
    xs = col0.astype(jnp.float32) + jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = row0.astype(jnp.float32) + jnp.arange(h, dtype=jnp.float32)[:, None]
    off = (k - row0, k - col0)
    w1 = remap_bilinear(e1, xs + hx, ys + hy, quantize=quantize, index_offset=off)
    w2 = remap_bilinear(e2, xs - hx, ys - hy, quantize=quantize, index_offset=off)
    return w1, w2


def sharded_symmetric_warp(
    img1,
    img2,
    u,
    v,
    mesh: Mesh,
    max_disp: float,
    *,
    quantize: bool = True,
    impl: str = "gather",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Warp both frames half-way toward each other, tiled over the mesh.

    u/v MUST already be clamped to [-max_disp, max_disp] (the controller
    does this); the halo covers exactly that reach.

    impl: 'gather' (exact remap on the halo tile) or 'shift_sep' (the
    separable static-shift form); each is bit-identical to the unsharded
    warp of the same impl.
    """
    rows_n = mesh.shape[AXIS_ROWS]
    cols_n = mesh.shape[AXIS_COLS]
    # halo = the warp's reach: half the clamped flow, +1 for coordinate
    # fixed-point rounding slack (gather); the flow-space-quantized
    # shift_sep needs no slack (ops/warp.py quantize_disp)
    k = int(math.ceil(max_disp / 2.0)) + (0 if impl == "shift_sep" else 1)
    tile_h = img1.shape[-2] // rows_n
    tile_w = img1.shape[-1] // cols_n
    if k > min(tile_h, tile_w):
        # exchange_halo can only ship up to one whole neighbour tile; a
        # larger reach would silently misalign the taps.
        raise ValueError(
            f"warp halo {k} (max_disp={max_disp}) exceeds tile "
            f"{tile_h}x{tile_w}; lower warp_clamp or the spatial mesh"
        )
    spec = P(*([AXIS_FRAMES] if img1.ndim == 3 else []), AXIS_ROWS, AXIS_COLS)
    fn = shard_map(
        partial(
            _warp_tile, k=k, rows_n=rows_n, cols_n=cols_n, quantize=quantize, impl=impl
        ),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec),
    )
    return fn(img1, img2, u, v)
