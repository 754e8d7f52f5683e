"""The fast preset on the mesh-sharded controller == one device, bit for
bit, on the 8-device virtual CPU mesh: frames-DP, spatial tiling, and
both together (the layouts `chip_smoke.py --four-cards` runs on GPUs)."""

import jax
import numpy as np
import pytest

from optical_flow_tpu.config import VideoConfig
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine
from optical_flow_tpu.parallel import flow_mesh
from optical_flow_tpu.parallel.sharded_flow import sharded_coarse_to_fine

MESHES = [(4, 1, 1), (1, 2, 2), (2, 2, 1)]


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_sharded_fast_preset_matches_one_device(shape):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    frames, rows, cols = shape
    mesh = flow_mesh(frames=frames, rows=rows, cols=cols)
    rng = np.random.RandomState(sum(shape))
    a = (rng.rand(max(frames, 2), 128, 128) * 255).astype(np.float32)
    b = np.roll(a, (1, -2), axis=(1, 2))
    cfg = VideoConfig.fast(size=(128, 128)).flow
    u0, v0 = jax.jit(lambda x, y: coarse_to_fine(x, y, 3, config=cfg))(a, b)
    u1, v1 = jax.jit(
        lambda x, y: sharded_coarse_to_fine(x, y, mesh, 3, config=cfg, min_tile=16)
    )(a, b)
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
