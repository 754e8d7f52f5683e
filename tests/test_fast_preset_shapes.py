"""The fast preset through the plain XLA path, one case per frame-shape
class, held to its own float64 run.

The shape classes cover widths that are multiples of 128 and widths below
it, odd sides, heights with few factors of two, tall and wide strips, the
golden still pair and the 1080^2 production ladder. Each case runs
`coarse_to_fine` with `VideoConfig.fast().flow` in float32 (the device
dtype) and in float64, and bounds the float32 run's mean endpoint error
against the float64 one by the golden contract's 0.1 px.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from optical_flow_tpu.config import VideoConfig
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine

SHAPES = [
    (64, 128), (64, 256), (448, 640), (56, 64), (50, 40), (61, 37),
    (122, 40), (128, 130), (1024, 40), (200, 200), (400, 400),
    (1080, 1080), (540, 540), (270, 270), (16, 1280),
]


def _textured_pair(H, W, dx=1.4, dy=-0.6, seed=0):
    """A smooth seeded texture and its exact sub-pixel translation."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)

    def tex(xx, yy):
        out = np.full(xx.shape, 128.0)
        for _ in range(40):
            kx, ky = rng.uniform(-0.6, 0.6, 2)
            out += 6.0 * np.sin(kx * xx + ky * yy + rng.uniform(0, 2 * np.pi))
        return out

    state = rng.get_state()
    a = tex(x, y)
    rng.set_state(state)
    b = tex(x - dx, y - dy)
    return a, b


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_fast_preset_f32_matches_f64(shape):
    H, W = shape
    a, b = _textured_pair(H, W)
    cfg = VideoConfig.fast(size=shape).flow
    flow = jax.jit(lambda x, y: coarse_to_fine(x, y, config=cfg))
    u32, v32 = flow(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    u64, v64 = flow(jnp.asarray(a), jnp.asarray(b))
    assert u32.dtype == jnp.float32 and u64.dtype == jnp.float64
    assert u32.shape == (H, W)
    u32, v32 = np.asarray(u32, np.float64), np.asarray(v32, np.float64)
    assert np.isfinite(u32).all() and np.isfinite(v32).all()
    epe = np.hypot(u32 - np.asarray(u64), v32 - np.asarray(v64)).mean()
    assert epe <= 0.1, epe
