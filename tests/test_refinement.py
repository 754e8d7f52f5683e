"""Iterative per-level refinement (FlowConfig.level_iters).

level_iters=1 must remain bit-identical to the reference-faithful path
(golden parity already pins it); >1 must measurably improve accuracy on
known motion.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from optical_flow_tpu.config import FlowConfig
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine

cv2 = pytest.importorskip("cv2")


def _scene(shift, h=128, w=128, seed=0):
    r = np.random.RandomState(seed)
    img = r.rand(h // 8, w // 8).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    M = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    img2 = cv2.warpAffine(
        img, M, (w, h), flags=cv2.INTER_CUBIC, borderMode=cv2.BORDER_REFLECT_101
    )
    return img, img2


def _epe(u, v, dx, dy, m=24):
    ui = np.asarray(u)[m:-m, m:-m]
    vi = np.asarray(v)[m:-m, m:-m]
    return float(np.mean(np.hypot(ui - dx, vi - dy)))


def test_level_iters_one_unchanged():
    img1, img2 = _scene((1.3, -0.6))
    u0, v0 = coarse_to_fine(jnp.asarray(img1), jnp.asarray(img2), 3, config=FlowConfig())
    u1, v1 = coarse_to_fine(
        jnp.asarray(img1), jnp.asarray(img2), 3, config=FlowConfig(level_iters=1)
    )
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


def test_corrected_mode_recovers_displacement():
    """'corrected' outputs true pixel displacement; 'reference' outputs the
    goldens' quirky quantity (non-doubled pyrUp + divergent warps) and is
    hugely off in displacement units."""
    dx, dy = 2.4, -1.7
    img1, img2 = _scene((dx, dy), seed=2)
    u, v = coarse_to_fine(
        jnp.asarray(img1), jnp.asarray(img2), 3,
        config=FlowConfig(mode="corrected"),
    )
    assert _epe(u, v, dx, dy) < 0.15
    u_r, v_r = coarse_to_fine(
        jnp.asarray(img1), jnp.asarray(img2), 3, config=FlowConfig()
    )
    assert _epe(u_r, v_r, dx, dy) > 1.0  # reference mode: not displacement


def test_level_iters_improves_large_motion():
    dx, dy = 6.5, -4.2
    img1, img2 = _scene((dx, dy), seed=4)
    errs = {}
    for iters in (1, 3):
        u, v = coarse_to_fine(
            jnp.asarray(img1), jnp.asarray(img2), 3,
            config=FlowConfig(mode="corrected", level_iters=iters),
        )
        errs[iters] = _epe(u, v, dx, dy)
    assert errs[3] < errs[1], errs


def test_invalid_mode_rejected():
    img = jnp.ones((16, 16))
    with pytest.raises(ValueError, match="mode"):
        coarse_to_fine(img, img, 2, config=FlowConfig(mode="fancy"))


def test_level_iters_requires_corrected_mode():
    img1, img2 = _scene((1.0, 0.0))
    with pytest.raises(ValueError, match="corrected"):
        coarse_to_fine(
            jnp.asarray(img1), jnp.asarray(img2), 2,
            config=FlowConfig(level_iters=2),  # mode='reference'
        )
