"""Unit tests for L0/L1 ops against OpenCV oracles and reference semantics.

The reference has no unit tests (SURVEY.md section 4); these pin every
OpenCV-semantic detail (borders, anchors, quantization) the golden parity
depends on, each against a live cv2 oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from optical_flow_tpu.ops.gradients import grad_x, grad_y, grad_t, spatio_temporal_gradients
from optical_flow_tpu.ops.pyramid import pyr_down, pyr_up, gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu.ops.solve import safe_divide, solve_lk_2x2
from optical_flow_tpu.ops.warp import remap_bilinear, symmetric_warp
from optical_flow_tpu.ops.window import sum3x3_interior

from conftest import require_cv2


def _rand(rng, h, w):
    return rng.rand(h, w)


class TestGradients:
    def test_vs_filter2d(self, rng):
        cv2 = require_cv2()
        a = _rand(rng, 13, 17)
        b = _rand(rng, 13, 17)
        kx = np.array([[-1.0, 1.0], [-1.0, 1.0]])
        ky = np.array([[-1.0, -1.0], [1.0, 1.0]])
        fx_ref = cv2.filter2D(a, -1, kx) + cv2.filter2D(b, -1, kx)
        fy_ref = cv2.filter2D(a, -1, ky) + cv2.filter2D(b, -1, ky)
        ft_ref = cv2.filter2D(a, -1, -np.ones((2, 2))) + cv2.filter2D(b, -1, np.ones((2, 2)))
        np.testing.assert_allclose(grad_x(a, b), fx_ref, atol=1e-12)
        np.testing.assert_allclose(grad_y(a, b), fy_ref, atol=1e-12)
        np.testing.assert_allclose(grad_t(a, b), ft_ref, atol=1e-12)

    def test_fused_matches_individual(self, rng):
        a = _rand(rng, 9, 11)
        b = _rand(rng, 9, 11)
        fx, fy, ft = spatio_temporal_gradients(a, b)
        np.testing.assert_allclose(fx, grad_x(a, b), atol=1e-12)
        np.testing.assert_allclose(fy, grad_y(a, b), atol=1e-12)
        np.testing.assert_allclose(ft, grad_t(a, b), atol=1e-12)

    def test_batched(self, rng):
        a = rng.rand(3, 9, 11)
        b = rng.rand(3, 9, 11)
        fx, _, _ = spatio_temporal_gradients(a, b)
        fx0, _, _ = spatio_temporal_gradients(a[0], b[0])
        np.testing.assert_allclose(fx[0], fx0, atol=1e-12)


class TestSum3x3:
    def test_interior_and_zero_ring(self, rng):
        m = _rand(rng, 8, 9)
        out = np.asarray(sum3x3_interior(m))
        # border ring must be exactly zero (LKof.cpp:129-137)
        assert (out[0, :] == 0).all() and (out[-1, :] == 0).all()
        assert (out[:, 0] == 0).all() and (out[:, -1] == 0).all()
        for i in range(1, 7):
            for j in range(1, 8):
                assert out[i, j] == pytest.approx(m[i - 1 : i + 2, j - 1 : j + 2].sum(), abs=1e-12)


class TestSolve:
    def test_divide_by_zero_is_zero(self):
        num = jnp.array([1.0, -2.0, 0.0])
        den = jnp.array([0.0, 4.0, 0.0])
        np.testing.assert_array_equal(safe_divide(num, den), [0.0, -0.5, 0.0])

    def test_cramer(self, rng):
        s = [jnp.asarray(_rand(rng, 4, 5)) for _ in range(5)]
        u, v = solve_lk_2x2(*s)
        det = s[0] * s[1] - s[2] * s[2]
        np.testing.assert_allclose(u, (s[2] * s[4] - s[1] * s[3]) / det, rtol=1e-12)
        np.testing.assert_allclose(v, (s[3] * s[2] - s[0] * s[4]) / det, rtol=1e-12)


class TestPyramid:
    @pytest.mark.parametrize("shape", [(8, 12), (9, 13), (7, 10), (448, 640)])
    def test_pyr_down_vs_cv2(self, rng, shape):
        cv2 = require_cv2()
        m = _rand(rng, *shape)
        np.testing.assert_allclose(pyr_down(m), cv2.pyrDown(m), atol=1e-12)

    @pytest.mark.parametrize("shape", [(5, 6), (7, 10), (14, 20)])
    def test_pyr_up_vs_cv2(self, rng, shape):
        cv2 = require_cv2()
        m = _rand(rng, *shape)
        np.testing.assert_allclose(pyr_up(m), cv2.pyrUp(m), atol=1e-12)

    def test_pyramid_levels_and_shapes(self, rng):
        img = _rand(rng, 448, 640)
        pyr = gaussian_pyramid(img, 7)
        shapes = [p.shape for p in pyr]
        assert shapes == [(448, 640), (224, 320), (112, 160), (56, 80), (28, 40), (14, 20), (7, 10)]

    def test_max_pyramid_levels(self):
        assert max_pyramid_levels((448, 640)) == 7  # SerialPyr run
        assert max_pyramid_levels((1080, 1080)) == 4  # video run
        assert max_pyramid_levels((7, 10)) == 1
        assert max_pyramid_levels((512, 512)) == 10

    @pytest.mark.parametrize("shape", [(5, 6), (7, 10), (14, 20), (3, 9, 13)])
    def test_pyr_up_stuffed_bit_identical(self, rng, shape):
        # the interleave-free (zero-stuffed) form must match the stack form exactly
        from optical_flow_tpu.ops.pyramid import _pyr_up_stack, _pyr_up_stuffed

        m = np.asarray(rng.rand(*shape) * 2 - 1, dtype=np.float32)
        a = np.asarray(_pyr_up_stack(m))
        b = np.asarray(_pyr_up_stuffed(m))
        assert a.shape == b.shape
        assert (a == b).all()

    @pytest.mark.parametrize("pads", [(2, 2, 2, 2), (0, 0, 2, 2), (1, 0, 0, 3), (4, 4, 4, 4)])
    def test_pad_last2_reflect_small_matches_numpy(self, rng, pads):
        from optical_flow_tpu.ops.pad import pad_last2

        t, b, l, r = pads
        for shape in [(7, 9), (2, 6, 8)]:
            m = np.asarray(rng.rand(*shape), dtype=np.float32)
            widths = [(0, 0)] * (m.ndim - 2) + [(t, b), (l, r)]
            want = np.pad(m, widths, mode="reflect")
            got = np.asarray(pad_last2(m, t, b, l, r))
            assert got.shape == want.shape
            assert (got == want).all()


class TestWarp:
    def test_remap_vs_cv2(self, rng):
        cv2 = require_cv2()
        src = _rand(rng, 12, 15)
        mx = (rng.rand(12, 15) * 17 - 1).astype(np.float32)
        my = (rng.rand(12, 15) * 14 - 1).astype(np.float32)
        ref = cv2.remap(src, mx, my, cv2.INTER_LINEAR)
        np.testing.assert_allclose(remap_bilinear(src, mx, my), ref, atol=1e-12)

    def test_remap_unquantized_close(self, rng):
        src = _rand(rng, 12, 15)
        mx = (rng.rand(12, 15) * 14).astype(np.float32)
        my = (rng.rand(12, 15) * 11).astype(np.float32)
        a = np.asarray(remap_bilinear(src, mx, my, quantize=True))
        b = np.asarray(remap_bilinear(src, mx, my, quantize=False))
        assert np.abs(a - b).max() < 0.05

    def test_symmetric_warp_vs_cv2(self, rng):
        cv2 = require_cv2()
        img1 = _rand(rng, 10, 12)
        img2 = _rand(rng, 10, 12)
        u = rng.randn(10, 12) * 2
        v = rng.randn(10, 12) * 2
        w1, w2 = symmetric_warp(img1, img2, u, v)
        xs, ys = np.meshgrid(np.arange(12, dtype=np.float32), np.arange(10, dtype=np.float32))
        fu = u.astype(np.float32)
        fv = v.astype(np.float32)
        r1 = cv2.remap(img1, xs + fu / 2, ys + fv / 2, cv2.INTER_LINEAR)
        r2 = cv2.remap(img2, xs - fu / 2, ys - fv / 2, cv2.INTER_LINEAR)
        np.testing.assert_allclose(w1, r1, atol=1e-12)
        np.testing.assert_allclose(w2, r2, atol=1e-12)

    def test_remap_batched(self, rng):
        src = rng.rand(2, 9, 11)
        mx = (rng.rand(9, 11) * 10).astype(np.float32)
        my = (rng.rand(9, 11) * 8).astype(np.float32)
        out = np.asarray(remap_bilinear(src, mx, my))
        out0 = np.asarray(remap_bilinear(src[0], mx, my))
        out1 = np.asarray(remap_bilinear(src[1], mx, my))
        np.testing.assert_allclose(out[0], out0, atol=1e-12)
        np.testing.assert_allclose(out[1], out1, atol=1e-12)


class TestReviewRegressions:
    def test_remap_uint8_no_wraparound(self):
        """Integer sources must interpolate in float (uint8 tap differences
        previously wrapped modulo 256) and round/saturate back."""
        cv2 = pytest.importorskip("cv2")
        rng = np.random.RandomState(11)
        src = (rng.rand(40, 60) * 255).astype(np.uint8)
        mx = (rng.rand(40, 60) * 59).astype(np.float32)
        my = (rng.rand(40, 60) * 39).astype(np.float32)
        # quantize=False matches modern cv2 (5.0 interpolates floats at full
        # precision); quantize=True matches reference-era OpenCV / goldens.
        ours = np.asarray(
            remap_bilinear(jnp.asarray(src), jnp.asarray(mx), jnp.asarray(my), quantize=False)
        )
        ref = cv2.remap(src, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
        assert ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
        # quantized path: still close (1/32-px coordinate grid)
        ours_q = np.asarray(
            remap_bilinear(jnp.asarray(src), jnp.asarray(mx), jnp.asarray(my))
        )
        assert np.abs(ours_q.astype(int) - ref.astype(int)).max() <= 8

    def test_max_pyramid_levels_rejects_empty(self):
        with pytest.raises(ValueError):
            max_pyramid_levels((0, 640))

    def test_invalid_impl_rejected(self):
        """LK has one implementation: asking for another is an error."""
        from optical_flow_tpu.flow.lk import lucas_kanade

        img = jnp.ones((8, 8))
        with pytest.raises(TypeError, match="impl"):
            lucas_kanade(img, img, impl="xla")


class TestShiftWarp:
    def test_shift_requires_clamp(self):
        from optical_flow_tpu.config import FlowConfig
        from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine

        a = jnp.ones((16, 16))
        with pytest.raises(ValueError, match="warp_clamp"):
            coarse_to_fine(a, a, 2, config=FlowConfig(warp_impl="shift_sep"))

    def test_retired_forms_refused(self):
        """Only the gather and separable shift warps exist: the exact
        non-separable 'shift' form lost on the card and was removed."""
        from optical_flow_tpu.config import FlowConfig
        from optical_flow_tpu.flow.coarse_to_fine import resolve_warp_impl
        from optical_flow_tpu.ops.warp import symmetric_warp

        with pytest.raises(ValueError, match="warp_impl"):
            resolve_warp_impl(FlowConfig(warp_clamp=8.0, warp_impl="shift"))
        a = jnp.ones((16, 16))
        with pytest.raises(ValueError, match="impl"):
            symmetric_warp(a, a, a, a, impl="shift", max_disp=4)


class TestShiftSepWarp:
    """Pins the separable shift warp (warp_impl='shift_sep', the clamped
    warp_impl='auto' form). The separable form is an approximation
    (exact only where dx is constant along y, ops/warp.py); these tests
    measure and bound its error vs the gather oracle and pin its
    end-to-end accuracy."""

    def _maps(self, H, W, dx, dy):
        xs = np.arange(W, dtype=np.float32)[None, :]
        ys = np.arange(H, dtype=np.float32)[:, None]
        return jnp.asarray(xs + dx), jnp.asarray(ys + dy)

    @staticmethod
    def _shift_sep(src, dx, dy, max_disp):
        """src warped by (dx, dy) through the symmetric shift_sep warp
        (its first frame samples at +u/2)."""
        from optical_flow_tpu.ops.warp import symmetric_warp

        u = jnp.asarray(2 * dx)
        v = jnp.asarray(2 * dy)
        return np.asarray(
            symmetric_warp(src, src, u, v, impl="shift_sep", max_disp=max_disp)[0]
        )

    def test_exact_where_dx_constant_along_y(self):
        from optical_flow_tpu.ops.warp import remap_bilinear

        rng = np.random.RandomState(11)
        H, W = 64, 96
        src = jnp.asarray(rng.rand(H, W).astype(np.float32))
        # dx varies along x only (constant along y), dy fully varying:
        # the separable decomposition is exact here by construction
        dx = np.tile(np.clip(rng.randn(1, W) * 2, -4, 4), (H, 1)).astype(np.float32)
        dy = np.clip(rng.randn(H, W) * 2, -4, 4).astype(np.float32)
        mx, my = self._maps(H, W, dx, dy)
        a = np.asarray(remap_bilinear(src, mx, my))
        b = self._shift_sep(src, dx, dy, 5)
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_error_bound_smooth_flow(self):
        """Window-averaged (LK-like) flow on a worst-case noise image:
        the measured bound documented in ops/warp.py."""
        from optical_flow_tpu.ops.warp import remap_bilinear

        rng = np.random.RandomState(7)
        H, W = 96, 128
        src = jnp.asarray(rng.rand(H, W).astype(np.float32))

        def box_smooth(f, k=9):
            c = np.cumsum(np.pad(f, ((k, 0), (0, 0))), axis=0)
            f = (c[k:] - c[:-k]) / k
            c = np.cumsum(np.pad(f, ((0, 0), (k, 0))), axis=1)
            return (c[:, k:] - c[:, :-k]) / k

        dx = box_smooth(np.clip(rng.randn(H, W) * 3, -4, 4)).astype(np.float32)
        dy = box_smooth(np.clip(rng.randn(H, W) * 3, -4, 4)).astype(np.float32)
        mx, my = self._maps(H, W, dx, dy)
        a = np.asarray(remap_bilinear(src, mx, my))
        b = self._shift_sep(src, dx, dy, 5)
        err = np.abs(a - b)
        assert err.max() < 0.30, err.max()  # measured 0.21
        assert err.mean() < 0.02, err.mean()  # measured 0.007

    def test_error_bound_adversarial(self):
        """dx alternates sign every row + fractional dy — the construction
        that maximally violates the separability assumption. The error is
        bounded (intensity units, [0,1] noise image) and documented; the
        pyramid's residual solves absorb it (see the end-to-end test)."""
        from optical_flow_tpu.ops.warp import remap_bilinear

        rng = np.random.RandomState(9)
        H, W = 96, 128
        src = jnp.asarray(rng.rand(H, W).astype(np.float32))
        dx = (np.where(np.arange(H)[:, None] % 2 == 0, 3.5, -3.5) * np.ones((H, W))).astype(np.float32)
        dy = np.full((H, W), 0.5, np.float32)
        mx, my = self._maps(H, W, dx, dy)
        a = np.asarray(remap_bilinear(src, mx, my))
        b = self._shift_sep(src, dx, dy, 5)
        err = np.abs(a - b)
        assert err.max() < 0.8, err.max()  # measured 0.47
        assert err.mean() < 0.2, err.mean()  # measured 0.12

    def test_pyramid_shift_sep_matches_gather(self):
        """Corrected-mode pyramid (the production config) with the
        separable warp agrees with the exact gather warp end to end."""
        from optical_flow_tpu.config import FlowConfig
        from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine

        rng = np.random.RandomState(13)
        base = rng.rand(96, 128).astype(np.float32)
        a = jnp.asarray(base)
        b = jnp.asarray(np.roll(base, (1, 2), axis=(0, 1)))
        kw = dict(mode="corrected", warp_clamp=8.0, level_iters=2)
        ue, ve = coarse_to_fine(a, b, 3, config=FlowConfig(warp_impl="gather", **kw))
        us, vs = coarse_to_fine(a, b, 3, config=FlowConfig(warp_impl="shift_sep", **kw))
        # interior only: borders carry the zero-fill warp transients
        # (random-noise images are worst-case content; measured ~0.012 px)
        sl = np.s_[16:-16, 16:-16]
        du = np.abs(np.asarray(ue)[sl] - np.asarray(us)[sl])
        dv = np.abs(np.asarray(ve)[sl] - np.asarray(vs)[sl])
        assert np.median(du) < 0.05 and np.median(dv) < 0.05, (np.median(du), np.median(dv))

    def test_pyramid_shift_sep_translation_epe(self):
        """The production config's accuracy claim (README): a global
        (3, 2) px translation of the real table image is recovered by the
        corrected pyramid with warp_impl='shift_sep'."""
        from optical_flow_tpu.config import FlowConfig
        from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine
        from optical_flow_tpu.utils.goldens import load_table_pair, reference_dir

        if reference_dir() is None:
            pytest.skip("reference checkout not available")
        img1, _ = load_table_pair()
        a = jnp.asarray(img1.astype(np.float32))
        b = jnp.asarray(np.roll(np.asarray(a), (2, 3), axis=(0, 1)))
        kw = dict(mode="corrected", warp_clamp=8.0, level_iters=2)
        sl = np.s_[32:-32, 32:-32]

        def epe(warp_impl):
            u, v = coarse_to_fine(
                a, b, 4, config=FlowConfig(warp_impl=warp_impl, **kw)
            )
            return np.hypot(np.asarray(u)[sl] - 3.0, np.asarray(v)[sl] - 2.0)

        e_sep = epe("shift_sep")
        e_ref = epe("gather")
        # equal-EPE claim (README): the separable warp costs < 3% accuracy
        # vs the exact gather oracle (measured 0.216 vs 0.212 mean here —
        # texture-poor regions dominate both; median 0.079 vs 0.077)
        assert e_sep.mean() <= e_ref.mean() * 1.1, (e_sep.mean(), e_ref.mean())
        assert np.median(e_sep) < 0.1, np.median(e_sep)


class TestPyrUpColsFirst:
    """The corrected-mode production upsample: same taps as pyr_up with
    the column pass first."""

    def test_matches_cv2(self, rng):
        import cv2
        from optical_flow_tpu.ops.pyramid import pyr_up_cols_first

        for shape in [(32, 48), (21, 17), (64, 64)]:
            x = rng.rand(*shape)
            ours = np.asarray(pyr_up_cols_first(jnp.asarray(x)))
            ref = cv2.pyrUp(x)
            np.testing.assert_allclose(ours, ref, atol=1e-12)

    def test_matches_rows_first_closely(self, rng):
        from optical_flow_tpu.ops.pyramid import pyr_up, pyr_up_cols_first

        x = jnp.asarray(rng.rand(40, 56).astype(np.float32) * 8 - 4)
        a = np.asarray(pyr_up(x))
        b = np.asarray(pyr_up_cols_first(x))
        # identical taps, different float association only
        np.testing.assert_allclose(a, b, atol=1e-5)


class TestWarpFuzz:
    def test_fuzz_shift_matches_gather_random_geometry(self):
        """Property fuzz over random shapes (odd/even, tiny), clamps and
        quantize modes: where the separable shift warp is exact (dx
        constant along y, displacements on the 1/32 px grid so flow- and
        coordinate-space quantization agree) it must match the gather
        remap within float noise everywhere — the equivalence the
        gather-free and tiled warps rest on."""
        from optical_flow_tpu.ops.warp import remap_bilinear, symmetric_warp

        for seed in range(12):
            rng = np.random.RandomState(100 + seed)
            H = int(rng.randint(9, 70))
            W = int(rng.randint(9, 70))
            clamp = float(rng.choice([2.0, 3.0, 4.0, 6.0, 8.0]))
            C = int(np.ceil(clamp))
            q = bool(rng.randint(2))
            src = jnp.asarray(rng.rand(H, W).astype(np.float32) * 255)
            xs = np.arange(W, dtype=np.float32)[None, :]
            ys = np.arange(H, dtype=np.float32)[:, None]
            dx = np.tile(np.clip(rng.randn(1, W) * clamp, -clamp, clamp), (H, 1))
            dy = np.clip(rng.randn(H, W) * clamp, -clamp, clamp)
            dx = (np.rint(dx * 32) / 32).astype(np.float32)
            dy = (np.rint(dy * 32) / 32).astype(np.float32)
            mx, my = jnp.asarray(xs + dx), jnp.asarray(ys + dy)
            a = np.asarray(remap_bilinear(src, mx, my, quantize=q))
            b = np.asarray(symmetric_warp(
                src, src, jnp.asarray(2 * dx), jnp.asarray(2 * dy),
                quantize=q, impl="shift_sep", max_disp=C,
            )[0])
            np.testing.assert_allclose(
                a, b, atol=2e-4, err_msg=f"seed={seed} {H}x{W} clamp={clamp} q={q}"
            )


class TestPyrDownImpl:
    def test_bad_impl_rejected(self):
        """pyr_down has one form (polyphase): asking for another is an
        error."""
        from optical_flow_tpu.ops.pyramid import pyr_down

        with pytest.raises(TypeError, match="impl"):
            pyr_down(jnp.ones((8, 8)), impl="mxu")
