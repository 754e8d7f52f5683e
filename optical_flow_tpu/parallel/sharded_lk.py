"""Spatially-sharded dense Lucas–Kanade over a device mesh.

Replaces the reference's row-parallel OpenMP loops (ParallelVideoPyr.cpp:182,
SURVEY.md P2) with 2-D image tiling across devices. Each device holds an
(H/rows, W/cols) tile; a 2-pixel halo exchange supplies the full
dependency window of one LK level:

    u(i,j) depends on image pixels [i-2 .. i+1] x [j-2 .. j+1]
    (2x2 gradient stencil reading (y-1..y, x-1..x), then a 3x3 window sum)

so k=2 halos make the tile computation *exact*: run the same single-device
LK on the extended (h+4, w+4) tile and slice out the centre. The 1-pixel
reflect the unsharded op applies at the image border is reproduced by the
halo fill; the only correction needed is the global border ring, where
`sum3x3_interior` leaves sums at 0 => det 0 => u=v=0 — re-imposed here by a
global-coordinate mask. Sharded output is bit-identical to the single-device
path (tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from optical_flow_tpu.flow.lk import lucas_kanade
from optical_flow_tpu.parallel.mesh import AXIS_COLS, AXIS_FRAMES, AXIS_ROWS

_HALO = 2  # gradient stencil (1 back) + 3x3 window (1 each way)


def _border_ring_mask(shape, row0, col0, H: int, W: int, dtype):
    """1 on pixels interior to the *global* image, 0 on its border ring."""
    h, w = shape[-2], shape[-1]
    gr = row0 + lax.broadcasted_iota(jnp.int32, (h, w), 0)
    gc = col0 + lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ok = (gr > 0) & (gr < H - 1) & (gc > 0) & (gc < W - 1)
    return ok.astype(dtype)


def _lk_tile(img1, img2, *, H, W, rows_n, cols_n):
    from optical_flow_tpu.parallel.halo import exchange_halo

    e1 = exchange_halo(img1, _HALO, rows_n=rows_n, cols_n=cols_n)
    e2 = exchange_halo(img2, _HALO, rows_n=rows_n, cols_n=cols_n)
    u, v = lucas_kanade(e1, e2)
    u = u[..., _HALO:-_HALO, _HALO:-_HALO]
    v = v[..., _HALO:-_HALO, _HALO:-_HALO]
    h, w = img1.shape[-2], img1.shape[-1]
    row0 = lax.axis_index(AXIS_ROWS) * h
    col0 = lax.axis_index(AXIS_COLS) * w
    mask = _border_ring_mask(img1.shape, row0, col0, H, W, u.dtype)
    return u * mask, v * mask


def sharded_lucas_kanade(
    img1,
    img2,
    mesh: Mesh,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense LK with images tiled over mesh axes ('rows', 'cols').

    img1/img2: (H, W) or (B, H, W); a leading batch dim is sharded over
    'frames'. H (W) must divide evenly by the rows (cols) axis size, and
    tiles must be at least (3, 3) for the reflect fill.
    """
    rows_n = mesh.shape[AXIS_ROWS]
    cols_n = mesh.shape[AXIS_COLS]
    H, W = img1.shape[-2], img1.shape[-1]
    if H % rows_n or W % cols_n:
        raise ValueError(f"image {H}x{W} not divisible by mesh {rows_n}x{cols_n}")
    if H // rows_n < 3 or W // cols_n < 3:
        raise ValueError("tiles must be at least 3x3")

    spec = P(*([AXIS_FRAMES] if img1.ndim == 3 else []), AXIS_ROWS, AXIS_COLS)
    fn = shard_map(
        partial(_lk_tile, H=H, W=W, rows_n=rows_n, cols_n=cols_n),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec),
    )
    return fn(img1, img2)
