"""Checkpoint/resume tests: pytree roundtrip + resumed pipeline parity."""

import numpy as np

import jax.numpy as jnp

from optical_flow_tpu.config import FlowConfig, PreprocessConfig, VideoConfig
from optical_flow_tpu.pipeline import VideoPipeline
from optical_flow_tpu.utils.checkpoint import load_state, save_state


def test_pytree_roundtrip(tmp_path):
    state = {
        "a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "b": None,
        "c": [jnp.ones((2, 2)), 5, "tag"],
        "d": {"x": True, "y": (1.5, np.zeros(3))},
    }
    p = tmp_path / "ckpt.npz"
    save_state(p, state)
    back = load_state(p)
    np.testing.assert_array_equal(back["a"], state["a"])
    assert back["b"] is None
    np.testing.assert_array_equal(back["c"][0], np.ones((2, 2)))
    assert back["c"][1] == 5 and back["c"][2] == "tag"
    assert back["d"]["x"] is True
    assert back["d"]["y"][0] == 1.5
    np.testing.assert_array_equal(back["d"]["y"][1], np.zeros(3))


def _frames(n, seed=0):
    r = np.random.RandomState(seed)
    base = (r.rand(96, 128, 3) * 255).astype(np.uint8)
    return [np.roll(base, 3 * i, axis=1) for i in range(n)]


def test_pipeline_resume_matches_uninterrupted(tmp_path):
    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(64, 64)), flow=FlowConfig()
    )
    frames = _frames(7)

    # uninterrupted
    full = list(VideoPipeline(cfg).run(frames))

    # interrupted after 4 frames, checkpointed, resumed in a new pipeline
    p1 = VideoPipeline(cfg)
    p1.reset()
    first = [r for f in frames[:4] for r in [p1.push(f)] if r is not None]
    save_state(tmp_path / "state.npz", p1.state())

    p2 = VideoPipeline(cfg)
    p2.restore(load_state(tmp_path / "state.npz"))
    second = [r for f in frames[4:] for r in [p2.push(f)] if r is not None]

    resumed = first + second
    assert len(resumed) == len(full) == 5
    for a, b in zip(resumed, full):
        np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=1e-6)
        np.testing.assert_allclose(np.asarray(a.v), np.asarray(b.v), atol=1e-6)
