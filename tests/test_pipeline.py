"""Preprocessing / gesture / video-pipeline tests.

Preprocessing ops are parity-checked against cv2 (the exact library the
reference linked, Makefile:8-10). uint8 stages allow +-1 quantization slack
(OpenCV uses fixed-point filter coefficients for 8u); index-exact stages
(gray conversion, threshold, morphology, Sobel on small ints) must match
exactly.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from optical_flow_tpu.config import GestureConfig, PreprocessConfig, VideoConfig, FlowConfig
from optical_flow_tpu.pipeline import (
    VideoPipeline,
    detect_gesture,
    dilate3x3,
    erode3x3,
    gaussian_blur,
    resize_cubic,
    sobel3,
    temporal_diff,
    threshold_tozero,
)
from optical_flow_tpu.pipeline.preprocess import bgr_to_gray, diff_features

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def frame(rng=None):
    r = np.random.RandomState(7)
    return (r.rand(120, 160, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def gray_pair():
    r = np.random.RandomState(8)
    a = (r.rand(96, 128) * 255).astype(np.uint8)
    b = (r.rand(96, 128) * 255).astype(np.uint8)
    return a, b


def test_resize_cubic_uint8(frame):
    ours = np.asarray(resize_cubic(jnp.asarray(frame), (64, 96)))
    ref = cv2.resize(frame, (96, 64), interpolation=cv2.INTER_CUBIC)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_resize_cubic_float(frame):
    f = frame[..., 0].astype(np.float32)
    ours = np.asarray(resize_cubic(jnp.asarray(f), (64, 96)))
    ref = cv2.resize(f, (96, 64), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(ours, ref, atol=1e-2)


def test_resize_cubic_upscale(frame):
    ours = np.asarray(resize_cubic(jnp.asarray(frame), (240, 320)))
    ref = cv2.resize(frame, (320, 240), interpolation=cv2.INTER_CUBIC)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_gaussian_blur_uint8(frame):
    ours = np.asarray(gaussian_blur(jnp.asarray(frame), 9, 1.5))
    ref = cv2.GaussianBlur(frame, (9, 9), 1.5, sigmaY=1.5)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_bgr_to_gray_exact(frame):
    ours = np.asarray(bgr_to_gray(jnp.asarray(frame)))
    ref = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(ours, ref)


def test_temporal_diff(gray_pair):
    cur, prev = gray_pair
    ours = np.asarray(temporal_diff(jnp.asarray(cur), jnp.asarray(prev), 0.3))
    ref = cv2.addWeighted(cur, 1.0, prev, -0.3, 0.0)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_threshold_tozero(gray_pair):
    x, _ = gray_pair
    ours = np.asarray(threshold_tozero(jnp.asarray(x), 10))
    _, ref = cv2.threshold(x, 10, 255, cv2.THRESH_TOZERO)
    np.testing.assert_array_equal(ours, ref)


def test_sobel_exact(gray_pair):
    x, _ = gray_pair
    for dxy in [(1, 0), (0, 1)]:
        ours = np.asarray(sobel3(jnp.asarray(x), *dxy))
        ref = cv2.Sobel(x, cv2.CV_64F, *dxy)
        np.testing.assert_array_equal(ours.astype(np.float64), ref)


def test_morphology_exact(gray_pair):
    x, _ = gray_pair
    xf = x.astype(np.float32)
    ours_d = np.asarray(dilate3x3(jnp.asarray(xf), 2))
    ref_d = cv2.dilate(xf, None, iterations=2)
    np.testing.assert_array_equal(ours_d, ref_d)
    ours_e = np.asarray(erode3x3(jnp.asarray(xf), 2))
    ref_e = cv2.erode(xf, None, iterations=2)
    np.testing.assert_array_equal(ours_e, ref_e)


def test_diff_features_chain(gray_pair):
    """Full C11 tail vs a cv2 composition (diff -> thresh -> sobel -> morph)."""
    cur, prev = gray_pair
    cfg = PreprocessConfig()
    ours = np.asarray(diff_features(jnp.asarray(cur), jnp.asarray(prev), cfg))
    d = cv2.addWeighted(cur, 1.0, prev, -0.3, 0.0)
    _, d = cv2.threshold(d, 10, 255, cv2.THRESH_TOZERO)
    d = cv2.Sobel(d, cv2.CV_64F, 1, 0) + cv2.Sobel(d, cv2.CV_64F, 0, 1)
    d = cv2.dilate(d, None, iterations=2)
    d = cv2.erode(d, None, iterations=2)
    # +-1 on the uint8 diff propagates through sobel (|taps|=8) and morph
    assert np.abs(ours.astype(np.float64) - d).max() <= 8.0


def test_gesture_detection_synthetic():
    u = np.zeros((64, 64), np.float32)
    v = np.zeros((64, 64), np.float32)
    u[20:52, 10:42] = 30.0  # 32*32 = 1024 voting pixels > 500
    res = detect_gesture(jnp.asarray(u), jnp.asarray(v), GestureConfig())
    assert bool(res.detected)
    assert int(res.votes) == 32 * 32
    np.testing.assert_allclose(float(res.cx), (10 + 41) / 2, atol=1e-4)
    np.testing.assert_allclose(float(res.cy), (20 + 51) / 2, atol=1e-4)
    # below-threshold flow: no detection
    res2 = detect_gesture(jnp.asarray(u * 0.1), jnp.asarray(v), GestureConfig())
    assert not bool(res2.detected)


def _small_video_config():
    return VideoConfig(
        preprocess=PreprocessConfig(size=(96, 96)),
        flow=FlowConfig(),
    )


def _synthetic_frames(n, h=120, w=160):
    r = np.random.RandomState(3)
    base = (r.rand(h, w, 3) * 255).astype(np.uint8)
    frames = []
    for i in range(n):
        f = np.roll(base, shift=2 * i, axis=1)  # horizontal motion
        frames.append(f)
    return frames


def test_video_pipeline_streaming():
    pipe = VideoPipeline(_small_video_config())
    results = list(pipe.run(_synthetic_frames(5)))
    assert len(results) == 3  # two warm-up frames
    for res in results:
        assert res.u.shape == (96, 96)
        assert np.isfinite(np.asarray(res.u)).all()
        assert np.isfinite(np.asarray(res.v)).all()
        assert res.gesture.votes.dtype == np.int32


def test_video_pipeline_batched_matches_streaming():
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(96, 96)),
        flow=FlowConfig(),
        faithful_prev_diff=False,
    )
    frames = _synthetic_frames(6)
    stream = list(VideoPipeline(cfg).run(frames))
    batch = VideoPipeline(cfg).run_batched(np.stack(frames))
    assert batch.u.shape == (4, 96, 96)
    for i, res in enumerate(stream):
        np.testing.assert_allclose(
            np.asarray(res.u), np.asarray(batch.u[i]), atol=1e-5
        )


def test_pacman_video_smoke():
    """End-to-end on the reference's bundled video asset."""
    from optical_flow_tpu.utils.goldens import reference_dir
    from optical_flow_tpu.io.video_reader import read_frames

    ref = reference_dir()
    if ref is None or not (ref / "pacman.mp4").exists():
        pytest.skip("pacman.mp4 not available")
    pipe = VideoPipeline(_small_video_config())
    results = list(pipe.run(read_frames(ref / "pacman.mp4", max_frames=5)))
    assert len(results) == 3
    assert all(np.isfinite(np.asarray(r.u)).all() for r in results)


def test_batched_pipeline_with_mesh():
    """Frame-DP + spatial tiling through the full batched video pipeline."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from optical_flow_tpu.parallel import flow_mesh

    mesh = flow_mesh(frames=2, rows=2, cols=2)
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(96, 96)),
        flow=FlowConfig(warp_clamp=8.0),
        faithful_prev_diff=False,
    )
    frames = np.stack(
        [np.roll((np.random.RandomState(5).rand(120, 160, 3) * 255).astype(np.uint8),
                 3 * i, axis=1) for i in range(6)]
    )
    unsharded = VideoPipeline(cfg).run_batched(frames)
    sharded = VideoPipeline(cfg, mesh=mesh).run_batched(frames)
    np.testing.assert_allclose(
        np.asarray(unsharded.u), np.asarray(sharded.u), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(unsharded.v), np.asarray(sharded.v), atol=1e-5
    )


def test_streaming_faithful_prev_diff_with_mesh_matches_unsharded():
    """faithful_prev_diff=True under a mesh used to silently return the
    UNWARPED diff as the next prevDiff (VERDICT r1 weak #4); the sharded
    controller now carries warped finest images, so streaming results must
    match the unsharded pipeline across several frames (the feedback
    compounds, so any divergence grows visibly)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from optical_flow_tpu.parallel import flow_mesh

    mesh = flow_mesh(frames=1, rows=2, cols=2)
    # the default warp_impl='auto': what the README's spatial tiling gives
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(96, 96)),
        flow=FlowConfig(warp_clamp=8.0),
        faithful_prev_diff=True,
    )
    r = np.random.RandomState(7)
    frames = [
        np.roll((r.rand(120, 160, 3) * 255).astype(np.uint8), 2 * i, axis=1)
        for i in range(6)
    ]
    unsharded = list(VideoPipeline(cfg).run(frames, prefetch=0))
    sharded = list(VideoPipeline(cfg, mesh=mesh).run(frames, prefetch=0))
    assert len(unsharded) == len(sharded) == 4
    for a, b in zip(unsharded, sharded):
        np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=1e-5)
        np.testing.assert_allclose(np.asarray(a.v), np.asarray(b.v), atol=1e-5)


def test_fast_preset_runs():
    cfg = VideoConfig.fast(size=(64, 64))
    assert cfg.flow.mode == "corrected" and cfg.flow.warp_clamp == 8.0
    pipe = VideoPipeline(cfg)
    results = list(pipe.run(_synthetic_frames(5)))
    assert len(results) == 3
    assert all(np.isfinite(np.asarray(r.u)).all() for r in results)


def test_fast_mode_gray_first_commutes():
    """Fast-mode preprocess runs BT.601 gray BEFORE resize+blur (one
    channel of work instead of three); all three ops are linear,
    so the output must match the reference order at f32 roundoff."""
    from optical_flow_tpu.pipeline.preprocess import preprocess_frame

    rng = np.random.RandomState(4)
    frame = (rng.rand(72, 96, 3) * 255).astype(np.uint8)
    cfg = PreprocessConfig(size=(64, 64), faithful_uint8=False)
    got = np.asarray(preprocess_frame(jnp.asarray(frame), cfg))
    assert got.ndim == 2 and got.dtype == np.float32
    x = jnp.asarray(frame, jnp.float32)
    x = resize_cubic(x, (64, 64))
    x = gaussian_blur(x, cfg.blur_ksize, cfg.blur_sigma, faithful_uint8=False)
    want = np.asarray(bgr_to_gray(x))
    np.testing.assert_allclose(got, want, atol=5e-3)
    # and the faithful path keeps the reference order (uint8 per-stage
    # rounding is order-sensitive): output stays uint8, pinned vs cv2
    # stage-by-stage in test_fuzz_preprocess.py
    cfgf = PreprocessConfig(size=(64, 64), faithful_uint8=True)
    gotf = np.asarray(preprocess_frame(jnp.asarray(frame), cfgf))
    assert gotf.dtype == np.uint8 and gotf.shape == (64, 64)


def test_streaming_pyramid_reuse_matches_unreused():
    """The cached-pyramid streaming path (reuse active when
    faithful_prev_diff=False, no mesh) must be bit-identical to solving
    each pair from scratch via the un-cached step."""
    r = np.random.RandomState(21)
    frames = (r.rand(6, 64, 64, 3) * 255).astype(np.uint8)
    cfg = VideoConfig(preprocess=PreprocessConfig(size=(48, 48)), faithful_prev_diff=False)
    pipe = VideoPipeline(cfg)
    assert pipe._reuse_pyramids
    reused = list(pipe.run(frames, prefetch=0))
    pipe2 = VideoPipeline(cfg)
    pipe2._reuse_pyramids = False  # force the legacy step
    legacy = list(pipe2.run(frames, prefetch=0))
    assert len(reused) == len(legacy) == len(frames) - 2
    for a, b in zip(reused, legacy):
        np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))
        np.testing.assert_array_equal(np.asarray(a.v), np.asarray(b.v))


def test_streaming_mesh_reuses_pyramids_and_matches_unsharded():
    """The mesh streaming path now reuses each frame's pyramid
    (sharded_coarse_to_fine_pyramids) like the single-device path, and
    its results match the unsharded streaming pipeline (allclose under
    jit: XLA fuses the tiled and plain programs with different FMA
    contraction, same as the existing mesh pipeline tests; EAGER
    bit-identity is pinned in test_parallel.py)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from optical_flow_tpu.parallel import flow_mesh
    from optical_flow_tpu.pipeline.video import VideoConfig, VideoPipeline

    mesh = flow_mesh(frames=2, rows=2, cols=2)
    rng = np.random.RandomState(3)
    frames = [
        (rng.rand(72, 96, 3) * 255).astype(np.uint8) for _ in range(6)
    ]
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(64, 64), faithful_uint8=False),
        flow=FlowConfig(levels=3, warp_clamp=4.0),
        faithful_prev_diff=False,
    )
    plain = VideoPipeline(cfg)
    sharded = VideoPipeline(cfg, mesh=mesh)
    assert sharded._reuse_pyramids  # the mesh path reuses now
    r0 = [r for f in frames if (r := plain.push(f)) is not None]
    r1 = [r for f in frames if (r := sharded.push(f)) is not None]
    assert len(r0) == len(r1) > 0
    for a, b in zip(r0, r1):
        np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=1e-4)
        np.testing.assert_allclose(np.asarray(a.v), np.asarray(b.v), atol=1e-4)


def test_run_chunked_matches_streaming():
    """run_chunked (one dispatch per chunk, carry across chunk boundaries)
    must produce the same pair sequence as the per-frame run() loop,
    including across a chunk boundary and a short per-frame tail."""
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(96, 96)),
        flow=FlowConfig(),
        faithful_prev_diff=False,
    )
    frames = _synthetic_frames(13)  # 2 full chunks of 5 + a 3-frame tail
    stream = list(VideoPipeline(cfg).run(frames, prefetch=0))
    chunked = list(VideoPipeline(cfg).run_chunked(frames, chunk_size=5, prefetch=1))
    # flatten chunk results (leading batch axis) + per-frame tail results
    flat_u, flat_v, flat_votes = [], [], []
    for res in chunked:
        u = np.asarray(res.u)
        if u.ndim == 3:
            for i in range(u.shape[0]):
                flat_u.append(u[i])
                flat_v.append(np.asarray(res.v)[i])
                flat_votes.append(int(np.asarray(res.gesture.votes)[i]))
        else:
            flat_u.append(u)
            flat_v.append(np.asarray(res.v))
            flat_votes.append(int(res.gesture.votes))
    assert len(flat_u) == len(stream) == len(frames) - 2
    for i, res in enumerate(stream):
        np.testing.assert_allclose(np.asarray(res.u), flat_u[i], atol=1e-5)
        np.testing.assert_allclose(np.asarray(res.v), flat_v[i], atol=1e-5)
        assert int(res.gesture.votes) == flat_votes[i]


def test_run_chunked_exact_multiple_and_short_input():
    """No-tail (frame count a multiple of chunk_size) and shorter-than-one-
    chunk inputs both produce the full expected result count."""
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(64, 64)),
        flow=FlowConfig(),
        faithful_prev_diff=False,
    )
    frames = _synthetic_frames(8, h=80, w=100)
    chunked = list(VideoPipeline(cfg).run_chunked(frames, chunk_size=4))
    n = sum(r.u.shape[0] if r.u.ndim == 3 else 1 for r in chunked)
    assert n == 6
    short = list(VideoPipeline(cfg).run_chunked(frames[:3], chunk_size=8))
    n_short = sum(r.u.shape[0] if r.u.ndim == 3 else 1 for r in short)
    assert n_short == 1


def test_run_chunked_requires_batchable_state():
    pipe = VideoPipeline(_small_video_config())  # faithful_prev_diff=True
    with pytest.raises(ValueError):
        list(pipe.run_chunked(_synthetic_frames(6), chunk_size=4))


def test_fast_mode_bgra_drops_alpha():
    """4-channel (BGRA) frames in fast mode must gray the BGR channels and
    ignore alpha (ADVICE r3: previously BGRA fell through to the resize
    core and was silently resampled as a (W, 4) image)."""
    from optical_flow_tpu.pipeline.preprocess import preprocess_frame

    rng = np.random.RandomState(9)
    bgr = (rng.rand(72, 96, 3) * 255).astype(np.uint8)
    alpha = (rng.rand(72, 96, 1) * 255).astype(np.uint8)
    bgra = np.concatenate([bgr, alpha], axis=-1)
    cfg = PreprocessConfig(size=(64, 64), faithful_uint8=False)
    got3 = np.asarray(preprocess_frame(jnp.asarray(bgr), cfg))
    got4 = np.asarray(preprocess_frame(jnp.asarray(bgra), cfg))
    assert got4.shape == (64, 64)
    np.testing.assert_array_equal(got3, got4)


def test_cli_video_gray_decode(capsys):
    """`video --gray-decode` (round 5): decode-time GRAY8 luma rides the
    whole fast pipeline — a third of the H2D bytes, the measured
    host-loop bottleneck — and produces per-frame results equivalent to
    the BGR path up to uint8 luma rounding."""
    import sys

    from optical_flow_tpu.utils.goldens import reference_dir

    ref = reference_dir()
    if ref is None or not (ref / "pacman.mp4").exists():
        pytest.skip("pacman.mp4 not available")
    import optical_flow_tpu.__main__ as cli

    argv = sys.argv
    try:
        sys.argv = [
            "x", "video", "--input", str(ref / "pacman.mp4"),
            "--frames", "5", "--size", "96", "--fast", "--gray-decode",
        ]
        cli.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("frame ")]
    assert len(lines) == 3  # 5 frames - 2 warmup
    assert all("votes=" in l for l in lines)


def test_cli_video_gray_decode_rejects_annotate(tmp_path):
    import sys

    import optical_flow_tpu.__main__ as cli

    argv = sys.argv
    try:
        sys.argv = [
            "x", "video", "--input", "whatever.mp4", "--frames", "2",
            "--gray-decode", "--annotate", str(tmp_path / "out"),
        ]
        with pytest.raises(SystemExit):
            cli.main()
    finally:
        sys.argv = argv


def test_prefetch_chunk_timings_tap():
    """The instrumented prefetcher (round 5): per-chunk producer spans
    (decode pull, device_put-to-ready) land in the caller's list — the
    co-measured legs bench.py's host-loop reconciliation is built on —
    and the staged chunks are unchanged."""
    from optical_flow_tpu.io.prefetch import prefetch_chunks_to_device

    frames = [np.full((8, 10), i, np.uint8) for i in range(10)]
    timings = []
    chunks = list(
        prefetch_chunks_to_device(iter(frames), chunk_size=4, timings=timings)
    )
    assert [c.shape for c in chunks] == [(4, 8, 10), (4, 8, 10), (2, 8, 10)]
    np.testing.assert_array_equal(np.asarray(chunks[1])[0], frames[4])
    assert len(timings) == 3
    for t in timings:
        assert set(t) == {"decode_s", "put_s"}
        assert t["decode_s"] >= 0 and t["put_s"] >= 0
    # untimed path unchanged
    chunks2 = list(prefetch_chunks_to_device(iter(frames), chunk_size=4))
    np.testing.assert_array_equal(np.asarray(chunks2[0]), np.asarray(chunks[0]))


def test_prefetch_forwards_upstream_errors():
    """A decode failure inside the prefetch worker must re-raise in the
    consumer, never read as a clean truncated end-of-stream (round 5:
    replay of a corrupt/missing video previously returned [] with
    success)."""
    from optical_flow_tpu.io.prefetch import (
        prefetch_chunks_to_device,
        prefetch_to_device,
    )

    def bad_frames():
        yield np.zeros((8, 10), np.uint8)
        raise IOError("decoder exploded mid-stream")

    got = []
    with pytest.raises(IOError, match="decoder exploded"):
        for f in prefetch_to_device(bad_frames()):
            got.append(f)
    assert len(got) == 1  # the good frame still arrived first

    with pytest.raises(IOError, match="decoder exploded"):
        list(prefetch_chunks_to_device(bad_frames(), chunk_size=4))

    def instant_fail():
        raise FileNotFoundError("no such video")
        yield  # pragma: no cover

    with pytest.raises(FileNotFoundError):
        list(prefetch_to_device(instant_fail()))


def test_prefetch_early_consumer_exit_unblocks_worker():
    """Breaking out of the consumer loop must let the worker thread exit
    (previously it blocked forever on q.put, pinning staged device
    buffers and the open decoder)."""
    import threading
    import time

    from optical_flow_tpu.io.prefetch import prefetch_to_device

    released = threading.Event()

    def frames():
        try:
            for i in range(100):
                yield np.full((8, 10), i, np.uint8)
        finally:
            released.set()  # generator closed => worker exited its loop

    it = prefetch_to_device(frames(), depth=2)
    next(it)
    it.close()  # early exit (what a consumer `break` does)
    assert released.wait(5.0), "prefetch worker did not unblock"
    # thread count settles (no leaked worker)
    time.sleep(0.3)
    names = [t.name for t in threading.enumerate()]
    assert sum("Thread-" in n for n in names) < 20


def test_run_chunked_leaves_resumable_state():
    """After run_chunked over an exact chunk multiple, the pipeline's
    streaming state must reflect the consumed frames (round-5 review:
    state() previously reported frame_idx=0 / prev=None, so a checkpoint
    there silently reprocessed the stream and a follow-up push()
    re-entered warm-up, dropping two results at the seam)."""
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(96, 96)),
        flow=FlowConfig(),
        faithful_prev_diff=False,
    )
    frames = _synthetic_frames(10, h=80, w=100)

    pipe = VideoPipeline(cfg)
    chunked = list(pipe.run_chunked(frames[:8], chunk_size=4))  # no tail
    st = pipe.state()
    assert st["frame_idx"] == 8
    assert st["prev_gray"] is not None and st["prev_diff"] is not None
    # continuing with push() produces the SAME results as an unbroken run
    cont = [r for f in frames[8:] for r in [pipe.push(f)] if r is not None]
    assert len(cont) == 2  # no warm-up re-entry at the seam
    full = [
        r for r in VideoPipeline(cfg).run(frames, prefetch=0)
    ]
    np.testing.assert_allclose(
        np.asarray(cont[-1].u), np.asarray(full[-1].u), atol=1e-5
    )


def test_uint8_nonsaturating_paths_return_float():
    """as_uint8=False / faithful_uint8=False on uint8 inputs must return
    the float samples, not wrap-cast bicubic overshoot back into uint8
    (-3 -> 253; round-5 review)."""
    from optical_flow_tpu.pipeline.preprocess import gaussian_blur, resize_cubic

    rng = np.random.RandomState(2)
    img = np.zeros((32, 40), np.uint8)
    img[8:24, 10:30] = 255  # sharp edges: guaranteed cubic overshoot
    out = np.asarray(resize_cubic(jnp.asarray(img), (48, 60), as_uint8=False))
    assert out.dtype == np.float32
    assert out.min() < 0 or out.max() > 255  # the overshoot is real...
    ref = np.asarray(
        resize_cubic(jnp.asarray(img, jnp.float32), (48, 60))
    )
    np.testing.assert_allclose(out, ref, atol=1e-3)  # ...and preserved
    outb = np.asarray(
        gaussian_blur(jnp.asarray(img), 9, 1.5, faithful_uint8=False)
    )
    assert outb.dtype == np.float32


def test_explicit_ffmpeg_backend_fails_clearly(tmp_path):
    """backend='ffmpeg' on an unprobeable file raises a clear error, not
    a NoneType unpack (round-5 review)."""
    from optical_flow_tpu.io.video_reader import VideoReader

    p = tmp_path / "not_a_video.txt"
    p.write_text("plain text")
    with pytest.raises(RuntimeError, match="ffprobe"):
        VideoReader(str(p), backend="ffmpeg")
