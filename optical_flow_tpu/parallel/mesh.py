"""Device-mesh construction for the flow engine.

Mesh axes (see config.MeshConfig):
  frames — data parallelism over frame pairs (batch),
  rows / cols — 2-D spatial tiling of each image across chips.

`jax.make_mesh` lays the devices out; on one host of NVLink-joined GPUs
every pair of devices is one hop apart, so any layout serves the halo
exchange equally.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax

AXIS_FRAMES = "frames"
AXIS_ROWS = "rows"
AXIS_COLS = "cols"


def mesh_factorization(n: int) -> Tuple[int, int, int]:
    """Pick a (frames, rows, cols) factorization of n devices.

    Heuristic: prefer a square-ish spatial grid (rows x cols) with frames
    soaking up the leftover factor — spatial tiling is the scaling story for
    one large frame; frames scale throughput.
    """
    if n <= 0:
        raise ValueError(f"need >= 1 device, got {n}")
    # largest power-of-two spatial grid <= n that is square-ish
    best = (n, 1, 1)
    for rows in range(1, n + 1):
        if n % rows:
            continue
        rest = n // rows
        for cols in range(1, rest + 1):
            if rest % cols:
                continue
            frames = rest // cols
            # score: prefer rows*cols big, rows ~ cols
            spatial = rows * cols
            score = (spatial, -abs(rows - cols))
            if score > (best[1] * best[2], -abs(best[1] - best[2])):
                best = (frames, rows, cols)
    return best


def flow_mesh(
    frames: int = 1,
    rows: int = 1,
    cols: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> jax.sharding.Mesh:
    """Build a (frames, rows, cols) mesh over the given (or all) devices."""
    n = frames * rows * cols
    # Auto axis types: shard_map/jit manage the sharding; no explicit-mode
    # avals leak into eager ops (jax >= 0.8 defaults to Explicit).
    auto = (jax.sharding.AxisType.Auto,) * 3
    if devices is None:
        try:
            return jax.make_mesh(
                (frames, rows, cols),
                (AXIS_FRAMES, AXIS_ROWS, AXIS_COLS),
                axis_types=auto,
            )
        except (ValueError, RuntimeError):
            devices = jax.devices()
    import numpy as np

    if len(devices) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(frames, rows, cols)
    return jax.sharding.Mesh(
        dev, (AXIS_FRAMES, AXIS_ROWS, AXIS_COLS), axis_types=auto
    )
