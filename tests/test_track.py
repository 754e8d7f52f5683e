"""Sparse tracking tests: synthetic ground truth + cv2 cross-checks."""

import numpy as np
import pytest

import jax.numpy as jnp

from optical_flow_tpu.track import (
    SparseLKConfig,
    good_features_to_track,
    track_features,
)

cv2 = pytest.importorskip("cv2")


def _texture(h=240, w=320, seed=0):
    r = np.random.RandomState(seed)
    img = r.rand(h // 8, w // 8).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    return (255 * (img - img.min()) / (img.max() - img.min())).astype(np.uint8)


def _shift(img, dx, dy):
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(
        img, M, (img.shape[1], img.shape[0]), flags=cv2.INTER_CUBIC,
        borderMode=cv2.BORDER_REFLECT_101,
    )


def test_good_features_close_to_cv2():
    img = _texture()
    pts, valid = good_features_to_track(jnp.asarray(img), 100, 0.01, 10)
    ours = np.asarray(pts)[np.asarray(valid)]
    assert len(ours) >= 20
    ref = cv2.goodFeaturesToTrack(img, 100, 0.01, 10).reshape(-1, 2)
    # most of our corners should be within 2 px of a cv2 corner
    d = np.linalg.norm(ours[:, None, :] - ref[None, :, :], axis=-1).min(axis=1)
    assert (d <= 2.0).mean() >= 0.6, f"only {(d<=2).mean():.0%} matched"


def test_track_recovers_translation():
    img1 = _texture(seed=1)
    dx, dy = 3.7, -2.2
    img2 = _shift(img1, dx, dy)
    pts, valid = good_features_to_track(jnp.asarray(img1), 80, 0.01, 10)
    pts_np = np.asarray(pts)[np.asarray(valid)]
    # keep features away from borders
    keep = (
        (pts_np[:, 0] > 30) & (pts_np[:, 0] < 290)
        & (pts_np[:, 1] > 30) & (pts_np[:, 1] < 210)
    )
    pts_np = pts_np[keep]
    assert len(pts_np) >= 10
    new, status, err = track_features(img1, img2, pts_np)
    new = np.asarray(new)[np.asarray(status)]
    old = pts_np[np.asarray(status)]
    assert len(new) >= 10
    d = new - old
    med = np.median(d, axis=0)
    np.testing.assert_allclose(med, [dx, dy], atol=0.1)


def test_track_close_to_cv2():
    img1 = _texture(seed=2)
    img2 = _shift(img1, 2.5, 1.5)
    ref_pts = cv2.goodFeaturesToTrack(img1, 60, 0.01, 10).reshape(-1, 2)
    keep = (
        (ref_pts[:, 0] > 30) & (ref_pts[:, 0] < 290)
        & (ref_pts[:, 1] > 30) & (ref_pts[:, 1] < 210)
    )
    ref_pts = ref_pts[keep].astype(np.float32)
    cv_new, cv_st, _ = cv2.calcOpticalFlowPyrLK(
        img1, img2, ref_pts.reshape(-1, 1, 2), None,
        winSize=(31, 31), maxLevel=2,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 20, 0.03),
    )
    cv_new = cv_new.reshape(-1, 2)
    cv_st = cv_st.reshape(-1).astype(bool)
    our_new, our_st, _ = track_features(img1, img2, ref_pts)
    both = cv_st & np.asarray(our_st)
    assert both.sum() >= 10
    diff = np.linalg.norm(np.asarray(our_new)[both] - cv_new[both], axis=-1)
    assert np.median(diff) <= 0.5, f"median diff {np.median(diff):.2f} px"


def test_track_border_and_out_of_bounds_status():
    img1 = _texture(seed=3)
    img2 = _shift(img1, 2.0, 0.0)
    # cv2 keeps tracking points near (even on) the border; it loses only
    # points outside the image by more than the half-window (verified
    # against cv2.calcOpticalFlowPyrLK).
    pts = np.array(
        [[5.0, 5.0], [160.0, 120.0], [-40.0, 120.0], [40.0, 120.0]], np.float32
    )
    _, status, _ = track_features(img1, img2, pts)
    status = np.asarray(status)
    assert status[0]  # near-border: tracked, like cv2
    assert status[1]  # interior
    assert not status[2]  # fully outside: lost
    assert status[3]  # within the coarse level's reach: tracked, like cv2


def test_homography_from_minimal_four_points():
    """K=4 exact correspondences must recover the homography (round-5
    review: the reduced SVD's vt[-1] was not the null vector for an
    (8, 9) design matrix, so the documented minimal case silently
    returned garbage)."""
    import numpy as np

    from optical_flow_tpu.track.pose import estimate_homography

    H_true = np.asarray(
        [[1.1, 0.05, 3.0], [-0.04, 0.95, -2.0], [1e-4, -2e-4, 1.0]]
    )
    p1 = np.asarray(
        [[10.0, 12.0], [80.0, 15.0], [20.0, 70.0], [90.0, 85.0]], np.float32
    )
    ph = np.concatenate([p1, np.ones((4, 1))], axis=1) @ H_true.T
    p2 = (ph[:, :2] / ph[:, 2:3]).astype(np.float32)
    from optical_flow_tpu.track.pose import RansacConfig

    H, inliers, n = estimate_homography(
        p1, p2, config=RansacConfig(inlier_px=0.5)
    )
    assert int(n) == 4, (np.asarray(H), int(n))
    Hn = np.asarray(H) / np.asarray(H)[2, 2]
    np.testing.assert_allclose(Hn, H_true / H_true[2, 2], atol=1e-3)


def test_good_features_per_image_threshold():
    """Batched corner detection thresholds PER IMAGE: a bright image in
    the batch must not blank a low-contrast image's corners (round-5
    review: the threshold was a global max over the whole batch)."""
    import numpy as np

    from optical_flow_tpu.track.features import good_features_to_track

    rng = np.random.RandomState(3)
    lowc = (rng.rand(64, 64) * 10).astype(np.float32)  # weak texture
    bright = (rng.rand(64, 64) * 255).astype(np.float32)
    _, v_single = good_features_to_track(jnp.asarray(lowc), 50, 0.01, 8)
    _, v_batch = good_features_to_track(
        jnp.stack([jnp.asarray(bright), jnp.asarray(lowc)]), 50, 0.01, 8
    )
    # the low-contrast image keeps (about) the corners it has alone
    assert int(v_batch[1].sum()) >= int(v_single.sum()) * 0.9


def test_track_features_prebuilt_pyramids_match():
    """pyr1/pyr2 reuse path is bit-identical to the internal build."""
    import numpy as np

    from optical_flow_tpu.track.sparse_lk import (
        SparseLKConfig,
        build_tracking_pyramid,
        track_features,
    )

    rng = np.random.RandomState(5)
    img1 = (rng.rand(96, 128) * 255).astype(np.float32)
    img2 = np.roll(img1, (1, 2), axis=(0, 1))
    pts = np.stack([rng.uniform(20, 100, 12), rng.uniform(20, 70, 12)], -1)
    cfg = SparseLKConfig(win=15, max_level=1)
    a = track_features(img1, img2, pts, cfg)
    b = track_features(
        img1, img2, pts, cfg,
        pyr1=build_tracking_pyramid(img1, cfg),
        pyr2=build_tracking_pyramid(img2, cfg),
    )
    # in-jit vs eager pyramid builds may fuse/round differently on CPU
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
