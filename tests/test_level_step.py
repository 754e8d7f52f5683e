"""The corrected-mode level step of the plain path — upsample, double,
clamp, negate, symmetric warp, LK, accumulate (flow/pyramid_loop.py) —
pinned by the properties the removed fused kernels were held to.

Each case runs `run_pyramid` on a two-level pyramid whose coarsest solve
is replaced by a chosen coarse flow, so the fine level's step is tested
alone."""

import numpy as np
import pytest

import jax.numpy as jnp

from optical_flow_tpu.config import FlowConfig
from optical_flow_tpu.flow.coarse_to_fine import resolve_warp_impl
from optical_flow_tpu.flow.lk import lucas_kanade
from optical_flow_tpu.flow.pyramid_loop import run_pyramid
from optical_flow_tpu.ops.pyramid import pyr_up_cols_first
from optical_flow_tpu.ops.warp import symmetric_warp

WARPS = ["gather", "shift_sep"]
H, W = 48, 64
CLAMP = 8.0


def _frames(seed=0, shift=(1, 2)):
    rng = np.random.RandomState(seed)
    a = rng.rand(H, W).astype(np.float32) * 255.0
    return jnp.asarray(a), jnp.asarray(np.roll(a, shift, axis=(0, 1)))


def _step(a, b, uc, vc, warp_impl):
    """The fine level's (u, v) for coarse flow (uc, vc)."""
    cfg = FlowConfig(mode="corrected", warp_clamp=CLAMP, warp_impl=warp_impl)
    impl, max_disp = resolve_warp_impl(cfg)

    def solve(i, x, y):
        return (uc, vc) if i == 1 else lucas_kanade(x, y)

    def warp(_i, x, y, u, v):
        return symmetric_warp(x, y, u, v, impl=impl, max_disp=max_disp)

    coarse = jnp.zeros((H // 2, W // 2), jnp.float32)
    u, v, _, _ = run_pyramid([a, coarse], [b, coarse], solve, warp, cfg)
    return np.asarray(u), np.asarray(v)


def _const(c):
    return jnp.full((H // 2, W // 2), c, jnp.float32)


@pytest.mark.parametrize("warp_impl", WARPS)
def test_flow_beyond_clamp_is_clipped(warp_impl):
    """A coarse flow far past the clamp warps exactly like one at the
    clamp; only the (unclamped) accumulation differs."""
    a, b = _frames()
    u_far, v_far = _step(a, b, _const(50.0), _const(-50.0), warp_impl)
    u_at, v_at = _step(a, b, _const(CLAMP / 2), _const(-CLAMP / 2), warp_impl)
    np.testing.assert_allclose(u_far - 100.0, u_at - CLAMP, atol=1e-4)
    np.testing.assert_allclose(v_far + 100.0, v_at + CLAMP, atol=1e-4)


@pytest.mark.parametrize("warp_impl", WARPS)
def test_zero_flow_warp_equals_plain_lk(warp_impl):
    """Warping by zero flow is the identity, so warp + LK is plain LK."""
    a, b = _frames(1)
    impl, max_disp = resolve_warp_impl(
        FlowConfig(mode="corrected", warp_clamp=CLAMP, warp_impl=warp_impl)
    )
    z = jnp.zeros((H, W), jnp.float32)
    w1, w2 = symmetric_warp(a, b, z, z, impl=impl, max_disp=max_disp)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(a))
    np.testing.assert_array_equal(np.asarray(w2), np.asarray(b))
    u, v = lucas_kanade(w1, w2)
    u0, v0 = lucas_kanade(a, b)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u0))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v0))


@pytest.mark.parametrize("warp_impl", WARPS)
def test_zero_coarse_flow_reduces_to_plain_lk(warp_impl):
    a, b = _frames(2)
    u, v = _step(a, b, _const(0.0), _const(0.0), warp_impl)
    u0, v0 = lucas_kanade(a, b)
    np.testing.assert_array_equal(u, np.asarray(u0))
    np.testing.assert_array_equal(v, np.asarray(v0))


@pytest.mark.parametrize("warp_impl", WARPS)
def test_large_flow_matches_written_out_step(warp_impl):
    """A smooth coarse flow reaching past the clamp: the loop's step is
    the composition upsample x2 -> clamp -> negate -> warp -> LK -> add,
    written out here."""
    a, b = _frames(3, shift=(3, -5))
    rng = np.random.RandomState(4)
    uc = jnp.asarray(np.cumsum(rng.randn(H // 2, W // 2), 1).astype(np.float32))
    vc = jnp.asarray(np.cumsum(rng.randn(H // 2, W // 2), 0).astype(np.float32))
    u, v = _step(a, b, uc, vc, warp_impl)

    impl, max_disp = resolve_warp_impl(
        FlowConfig(mode="corrected", warp_clamp=CLAMP, warp_impl=warp_impl)
    )
    upu = 2.0 * pyr_up_cols_first(uc)
    upv = 2.0 * pyr_up_cols_first(vc)
    assert float(jnp.abs(upu).max()) > CLAMP  # the case reaches past the clamp
    wu = -jnp.clip(upu, -CLAMP, CLAMP)
    wv = -jnp.clip(upv, -CLAMP, CLAMP)
    w1, w2 = symmetric_warp(a, b, wu, wv, impl=impl, max_disp=max_disp)
    du, dv = lucas_kanade(w1, w2)
    np.testing.assert_array_equal(u, np.asarray(du + upu))
    np.testing.assert_array_equal(v, np.asarray(dv + upv))
    assert np.isfinite(u).all() and np.isfinite(v).all()


def test_degenerate_level_returns_zeros():
    """Levels too small for an interior 3x3 window solve to zero flow."""
    for shape in ((2, 2), (1, 5), (2, 9)):
        x = jnp.asarray(np.random.RandomState(5).rand(*shape).astype(np.float32))
        u, v = lucas_kanade(x, x[::-1])
        assert u.shape == shape
        assert not np.asarray(u).any() and not np.asarray(v).any()
