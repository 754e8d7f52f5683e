"""Stencil halo exchange over a device mesh via `jax.lax.ppermute`.

The reference never needs this: its OpenMP threads share one address space,
so a 3x3 stencil's neighbour reads are free (SURVEY.md P3). Across chips the
neighbour rows/cols must be exchanged explicitly: `ppermute` with a
shift-by-one permutation sends each strip to the neighbouring device only.

Exchange order matters for corners: extending columns first and *then*
exchanging rows of the already-extended array propagates corner data from
diagonal neighbours in two hops, so a single rows+cols exchange provides the
full (2k+1)^2 dependency window.

Global image borders (tiles with no neighbour on a side) are filled with
BORDER_REFLECT_101 of the tile's own data — identical to what the unsharded
ops see from `jnp.pad(mode='reflect')`, so sharded results are bit-identical
to single-device results (verified in tests/test_parallel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _take(x, axis: int, lo: int, hi: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, hi) if hi != 0 else slice(lo, None)
    return x[tuple(idx)]


def _exchange_1d(x, k: int, axis_name: str, axis: int, n: int, border: str):
    """Extend `x` by k along `axis` on both sides.

    Interior sides come from the mesh neighbours along `axis_name`;
    global-border sides are REFLECT_101 fills (stencil ops) or zeros
    (warp gathers — OpenCV remap's BORDER_CONSTANT 0).
    """
    if k <= 0:
        return x
    if border == "reflect":
        # Halo received from the neighbour *before* me (its trailing k slab).
        lo_fill = jnp.flip(_take(x, axis, 1, k + 1), axis=axis)  # reflect -i -> i
        hi_fill = jnp.flip(_take(x, axis, -k - 1, -1), axis=axis)  # n-1+i -> n-1-i
    elif border == "zero":
        lo_fill = jnp.zeros_like(_take(x, axis, 0, k))
        hi_fill = lo_fill
    else:
        raise ValueError(f"unknown border {border!r}")
    if n > 1:
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]
        recv_lo = lax.ppermute(_take(x, axis, -k, 0), axis_name, fwd)
        recv_hi = lax.ppermute(_take(x, axis, 0, k), axis_name, bwd)
        idx = lax.axis_index(axis_name)
        lo = jnp.where(idx == 0, lo_fill, recv_lo)
        hi = jnp.where(idx == n - 1, hi_fill, recv_hi)
    else:
        lo, hi = lo_fill, hi_fill
    return jnp.concatenate([lo, x, hi], axis=axis)


def exchange_halo_rows(
    x,
    k: int,
    *,
    rows_axis: str = "rows",
    rows_n: int = 1,
    border: str = "reflect",
):
    """Extend a (..., h, w) tile to (..., h+2k, w) with row-neighbour halo
    only — used by the tiled separable shift warp, whose x-pass needs the
    neighbour rows' displacement field but never their columns."""
    return _exchange_1d(x, k, rows_axis, -2, rows_n, border)


def exchange_halo(
    x,
    k: int,
    *,
    rows_axis: str = "rows",
    cols_axis: str = "cols",
    rows_n: int = 1,
    cols_n: int = 1,
    border: str = "reflect",
):
    """Extend a (..., h, w) tile to (..., h+2k, w+2k) with halo data.

    Must be called inside `shard_map` over a mesh containing `rows_axis` /
    `cols_axis` (axis sizes passed statically as rows_n / cols_n). Columns
    are extended first so the row exchange carries corner data.
    """
    x = _exchange_1d(x, k, cols_axis, -1, cols_n, border)
    x = _exchange_1d(x, k, rows_axis, -2, rows_n, border)
    return x
