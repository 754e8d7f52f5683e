"""Multi-device tests on an 8-way virtual CPU mesh (conftest sets
XLA_FLAGS=--xla_force_host_platform_device_count=8).

The claim under test is strong: spatially-tiled flow over the mesh is
BIT-IDENTICAL to the single-device computation (the halo exchange supplies
exactly the same operand values in the same expression order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optical_flow_tpu.config import FlowConfig
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine
from optical_flow_tpu.flow.lk import lucas_kanade
from optical_flow_tpu.parallel import (
    flow_mesh,
    mesh_factorization,
    sharded_coarse_to_fine,
    sharded_lucas_kanade,
)


@pytest.fixture(scope="module")
def mesh222():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return flow_mesh(frames=2, rows=2, cols=2)


@pytest.fixture(scope="module")
def mesh_spatial():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return flow_mesh(frames=1, rows=2, cols=4)


def _pair(rng, shape, dtype=np.float64):
    a = rng.rand(*shape).astype(dtype)
    b = rng.rand(*shape).astype(dtype)
    return a, b


def test_mesh_factorization():
    assert mesh_factorization(1) == (1, 1, 1)
    f, r, c = mesh_factorization(8)
    assert f * r * c == 8 and r * c >= 4
    f, r, c = mesh_factorization(6)
    assert f * r * c == 6


def test_sharded_lk_bit_identical(rng, mesh222):
    img1, img2 = _pair(rng, (64, 128))
    u0, v0 = lucas_kanade(jnp.asarray(img1), jnp.asarray(img2))
    u1, v1 = sharded_lucas_kanade(img1, img2, mesh222)
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


def test_sharded_lk_batched_frames(rng, mesh222):
    b1, b2 = _pair(rng, (4, 32, 64))
    u0, v0 = lucas_kanade(jnp.asarray(b1), jnp.asarray(b2))
    u1, v1 = sharded_lucas_kanade(b1, b2, mesh222)
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


def test_sharded_lk_wide_spatial(rng, mesh_spatial):
    img1, img2 = _pair(rng, (64, 256))
    u0, v0 = lucas_kanade(jnp.asarray(img1), jnp.asarray(img2))
    u1, v1 = sharded_lucas_kanade(img1, img2, mesh_spatial)
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


def test_sharded_coarse_to_fine_matches(rng, mesh222):
    img1, img2 = _pair(rng, (128, 128))
    cfg = FlowConfig()
    u0, v0 = coarse_to_fine(jnp.asarray(img1), jnp.asarray(img2), 3, config=cfg)
    u1, v1 = sharded_coarse_to_fine(img1, img2, mesh222, 3, config=cfg)
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


def test_sharded_lk_under_jit(rng, mesh222):
    """The sharded solve must compile inside an outer jit (driver dryrun path)."""
    img1, img2 = _pair(rng, (64, 128), dtype=np.float32)

    @jax.jit
    def step(a, b):
        return sharded_lucas_kanade(a, b, mesh222)

    u1, v1 = step(img1, img2)
    u0, v0 = lucas_kanade(jnp.asarray(img1), jnp.asarray(img2))
    np.testing.assert_allclose(np.asarray(u0), np.asarray(u1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=1e-5)


def test_rejects_bad_tiling(rng, mesh222):
    img1, img2 = _pair(rng, (31, 64))  # 31 rows not divisible by 2
    with pytest.raises(ValueError):
        sharded_lucas_kanade(img1, img2, mesh222)


def test_sharded_warp_bit_identical(rng, mesh222):
    from optical_flow_tpu.ops.warp import symmetric_warp
    from optical_flow_tpu.parallel import sharded_symmetric_warp

    img1, img2 = _pair(rng, (64, 128))
    C = 6.0
    u = jnp.asarray(np.clip(rng.randn(64, 128) * 3, -C, C))
    v = jnp.asarray(np.clip(rng.randn(64, 128) * 3, -C, C))
    w1_0, w2_0 = symmetric_warp(jnp.asarray(img1), jnp.asarray(img2), u, v)
    w1_1, w2_1 = sharded_symmetric_warp(img1, img2, u, v, mesh222, C)
    np.testing.assert_array_equal(np.asarray(w1_0), np.asarray(w1_1))
    np.testing.assert_array_equal(np.asarray(w2_0), np.asarray(w2_1))


def test_sharded_pyramid_with_tiled_warp(rng, mesh222):
    """Full sharded coarse-to-fine with clamped tiled warps == unsharded."""
    img1, img2 = _pair(rng, (128, 128))
    cfg = FlowConfig(warp_clamp=8.0)
    u0, v0 = coarse_to_fine(jnp.asarray(img1), jnp.asarray(img2), 3, config=cfg)
    from optical_flow_tpu.parallel.sharded_flow import sharded_coarse_to_fine as scf

    u1, v1 = scf(img1, img2, mesh222, 3, config=cfg, min_tile=16)
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


@pytest.mark.parametrize("impl", ["shift_sep"])
def test_sharded_shift_warp_bit_identical(rng, mesh222, impl):
    """The gather-free tile warp (shift_sep) is bit-identical to the
    unsharded warp of the same form: flow-space quantization is
    position-independent, taps come from the halo, and weights/sum order
    from the shared symmetric_shift_sep_sum."""
    from optical_flow_tpu.ops.warp import symmetric_warp
    from optical_flow_tpu.parallel import sharded_symmetric_warp

    img1, img2 = _pair(rng, (64, 128))
    clamp = 6.0
    max_disp = int(-(-clamp // 2))  # resolve_warp_impl's bound
    u = jnp.asarray(np.clip(rng.randn(64, 128) * 3, -clamp, clamp))
    v = jnp.asarray(np.clip(rng.randn(64, 128) * 3, -clamp, clamp))
    w1_0, w2_0 = symmetric_warp(
        jnp.asarray(img1), jnp.asarray(img2), u, v, impl=impl, max_disp=max_disp
    )
    w1_1, w2_1 = sharded_symmetric_warp(img1, img2, u, v, mesh222, clamp, impl=impl)
    np.testing.assert_array_equal(np.asarray(w1_0), np.asarray(w1_1))
    np.testing.assert_array_equal(np.asarray(w2_0), np.asarray(w2_1))


@pytest.mark.parametrize("impl", ["shift_sep"])
def test_sharded_pyramid_with_shift_warp(rng, mesh222, impl):
    """Full sharded coarse-to-fine with the gather-free tiled warp ==
    unsharded controller with the same warp impl, bit for bit — including
    the corrected production mode. The bit-identity property is
    clamp-independent, so the clamp is kept small.
    """
    img1, img2 = _pair(rng, (128, 128))
    levels = 3
    for mode in ("reference", "corrected"):
        cfg = FlowConfig(warp_clamp=4.0, warp_impl=impl, mode=mode)
        u0, v0 = coarse_to_fine(
            jnp.asarray(img1), jnp.asarray(img2), levels, config=cfg
        )
        from optical_flow_tpu.parallel.sharded_flow import sharded_coarse_to_fine as scf

        u1, v1 = scf(img1, img2, mesh222, levels, config=cfg, min_tile=16)
        np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
        np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


def test_sharded_warp_rejects_oversized_halo(rng, mesh222):
    from optical_flow_tpu.parallel import sharded_symmetric_warp

    img1, img2 = _pair(rng, (32, 32))  # 16x16 tiles on the 2x2 spatial grid
    u = jnp.zeros((32, 32))
    v = jnp.zeros((32, 32))
    with pytest.raises(ValueError, match="halo"):
        sharded_symmetric_warp(img1, img2, u, v, mesh222, max_disp=40.0)


def test_sharded_pyramid_falls_back_on_wide_clamp(rng, mesh222):
    """A warp clamp whose halo exceeds the tile must not corrupt results —
    the controller falls back to the global warp."""
    img1, img2 = _pair(rng, (64, 64))  # 32x32 tiles; clamp 40 -> k=21 > 16 at level 1
    cfg = FlowConfig(warp_clamp=40.0)
    u0, v0 = coarse_to_fine(jnp.asarray(img1), jnp.asarray(img2), 2, config=cfg)
    from optical_flow_tpu.parallel.sharded_flow import sharded_coarse_to_fine as scf

    u1, v1 = scf(img1, img2, mesh222, 2, config=cfg, min_tile=8)
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))


def test_levels_validation():
    img = jnp.asarray(np.random.RandomState(0).rand(70, 70))
    with pytest.raises(ValueError, match="too deep"):
        coarse_to_fine(img, img, 3)
    u, v = coarse_to_fine(img, img, 2)  # 70 -> 35 is fine
    assert u.shape == (70, 70)
