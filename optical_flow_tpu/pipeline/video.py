"""Video gesture-tracking pipeline driver (reference flagship,
ParallelVideoPyr.cpp:730-905).

The reference loop is strictly sequential: capture -> preprocess -> pyramidal
LK on (prevDiff, diff) -> gesture -> imshow. Two device execution modes:

- streaming: one jitted step per frame pair, preserving the reference's
  sequential-state quirks (including `faithful_prev_diff`: the pyramid warp
  mutates `diff` in place through level-0 aliasing BEFORE it is saved as the
  next prevDiff — LKof.cpp:193-226 + ParallelVideoPyr.cpp:841);
- batched: N frames preprocessed and N-2 flow fields solved as one batch
  (frame data parallelism, shardable over the 'frames' mesh axis). Batching
  requires faithful_prev_diff=False since the warped-diff feedback is a
  sequential dependency.

Both run the same jitted compute; the host loop only feeds frames and
collects results (no device->host sync inside the loop).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from optical_flow_tpu.config import VideoConfig
from optical_flow_tpu.flow.coarse_to_fine import (
    coarse_to_fine_pyramids,
    coarse_to_fine_with_images,
)
from optical_flow_tpu.ops.pyramid import gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu.pipeline.gesture import GestureResult, detect_gesture
from optical_flow_tpu.pipeline.preprocess import diff_features, preprocess_frame


class FrameResult(NamedTuple):
    u: jnp.ndarray
    v: jnp.ndarray
    gesture: GestureResult


class VideoPipeline:
    """Gesture tracking over a frame stream.

    Usage:
        pipe = VideoPipeline(VideoConfig())
        for result in pipe.run(frames):   # frames: iterable of HxWx3 uint8
            if bool(result.gesture.detected): ...
    """

    def __init__(self, config: VideoConfig = VideoConfig(), mesh=None):
        if config.faithful_prev_diff and config.flow.warp_impl == "auto":
            # The fed-back prevDiff is the reference's cv2.remap output, so
            # it takes the exact warp: the loop amplifies any sub-pixel
            # change of the warped diff, and shift_sep's flow-space 1/32 px
            # rounding would turn f32 roundoff (sharded vs unsharded, GPU
            # vs CPU) into diverging streams.
            config = dataclasses.replace(
                config, flow=dataclasses.replace(config.flow, warp_impl="gather")
            )
        self.config = config
        self.mesh = mesh
        self._preprocess = jax.jit(self._preprocess_impl)
        self._diff = jax.jit(self._diff_impl)
        self._flow_step = jax.jit(self._flow_step_impl)
        self._batch_flow = jax.jit(self._batch_flow_impl)
        self._build_pyr = jax.jit(self._build_pyr_impl)
        self._flow_step_pyr = jax.jit(self._flow_step_pyr_impl)
        self._batch_flow_pyr = jax.jit(self._batch_flow_pyr_impl)
        self._chunk_first = jax.jit(self._chunk_first_impl)
        self._chunk_step = jax.jit(self._chunk_step_impl)
        # Streaming pyramid reuse: each frame's Gaussian pyramid serves two
        # consecutive pairs ((t-1, t) and (t, t+1)), so cache it instead of
        # rebuilding — ~25% of the per-frame flow work at 1080^2. Only valid
        # when prevDiff is the RAW diff (faithful_prev_diff warps it in
        # place, so its pyramid differs); the mesh path reuses too
        # (sharded_coarse_to_fine_pyramids).
        self._reuse_pyramids = not config.faithful_prev_diff
        self.reset()

    def reset(self) -> None:
        self._prev_gray = None
        self._prev_diff = None
        self._prev_pyr = None
        self._frame_idx = 0

    # --- checkpoint / resume (utils/checkpoint.py) -------------------------

    def state(self) -> dict:
        """Resumable streaming state (the reference's prevFrame/prevDiff
        warm-up Mats, ParallelVideoPyr.cpp:794-822, plus the frame index)."""
        import numpy as np

        return {
            "prev_gray": None if self._prev_gray is None else np.asarray(self._prev_gray),
            "prev_diff": None if self._prev_diff is None else np.asarray(self._prev_diff),
            "frame_idx": self._frame_idx,
        }

    def restore(self, state: dict) -> None:
        self._prev_gray = None if state["prev_gray"] is None else jnp.asarray(state["prev_gray"])
        self._prev_diff = None if state["prev_diff"] is None else jnp.asarray(state["prev_diff"])
        # the cached pyramid is derived state: rebuild it (deterministic,
        # so resumed streams stay bit-identical to uninterrupted ones)
        self._prev_pyr = (
            self._build_pyr(self._prev_diff)
            if (self._reuse_pyramids and self._prev_diff is not None)
            else None
        )
        self._frame_idx = int(state["frame_idx"])

    # --- jitted stages -----------------------------------------------------

    def _preprocess_impl(self, frame_bgr):
        return preprocess_frame(frame_bgr, self.config.preprocess)

    def _diff_impl(self, cur_gray, prev_gray):
        return diff_features(cur_gray, prev_gray, self.config.preprocess)

    def _flow_step_impl(self, prev_diff, diff):
        levels = max_pyramid_levels(diff.shape)
        if self.mesh is not None:
            from optical_flow_tpu.parallel.sharded_flow import (
                sharded_coarse_to_fine_with_images,
            )

            u, v, _, warped_diff = sharded_coarse_to_fine_with_images(
                prev_diff, diff, self.mesh, levels, config=self.config.flow
            )
        else:
            u, v, _, warped_diff = coarse_to_fine_with_images(
                prev_diff, diff, levels, config=self.config.flow
            )
        gesture = detect_gesture(u, v, self.config.gesture)
        next_prev = warped_diff if self.config.faithful_prev_diff else diff
        return FrameResult(u, v, gesture), next_prev

    def _build_pyr_impl(self, diff):
        return tuple(gaussian_pyramid(diff, max_pyramid_levels(diff.shape)))

    def _flow_step_pyr_impl(self, prev_pyr, pyr):
        if self.mesh is not None:
            from optical_flow_tpu.parallel.sharded_flow import (
                sharded_coarse_to_fine_pyramids,
            )

            u, v, _, _ = sharded_coarse_to_fine_pyramids(
                prev_pyr, pyr, self.mesh, config=self.config.flow
            )
        else:
            u, v, _, _ = coarse_to_fine_pyramids(
                prev_pyr, pyr, config=self.config.flow
            )
        return FrameResult(u, v, detect_gesture(u, v, self.config.gesture))

    def _batch_flow_impl(self, prev_diffs, diffs):
        levels = max_pyramid_levels(diffs.shape)
        if self.mesh is not None:
            from optical_flow_tpu.parallel.sharded_flow import sharded_coarse_to_fine

            u, v = sharded_coarse_to_fine(
                prev_diffs, diffs, self.mesh, levels, config=self.config.flow
            )
        else:
            u, v, _, _ = coarse_to_fine_with_images(
                prev_diffs, diffs, levels, config=self.config.flow
            )
        return FrameResult(u, v, detect_gesture(u, v, self.config.gesture))

    def _batch_flow_pyr_impl(self, diffs):
        # one pyramid per diff; the N-2 pairs are batch SLICES of the same
        # level arrays (each frame's pyramid serves both its pairs for free)
        pyr = tuple(gaussian_pyramid(diffs, max_pyramid_levels(diffs.shape)))
        prev = tuple(p[:-1] for p in pyr)
        cur = tuple(p[1:] for p in pyr)
        if self.mesh is not None:
            from optical_flow_tpu.parallel.sharded_flow import (
                sharded_coarse_to_fine_pyramids,
            )

            u, v, _, _ = sharded_coarse_to_fine_pyramids(
                prev, cur, self.mesh, config=self.config.flow
            )
        else:
            u, v, _, _ = coarse_to_fine_pyramids(
                prev, cur, config=self.config.flow
            )
        return FrameResult(u, v, detect_gesture(u, v, self.config.gesture))

    # --- chunked streaming (one dispatch per N frames) ----------------------

    def _flow_from_pyr_pairs(self, prev, cur):
        if self.mesh is not None:
            from optical_flow_tpu.parallel.sharded_flow import (
                sharded_coarse_to_fine_pyramids,
            )

            u, v, _, _ = sharded_coarse_to_fine_pyramids(
                prev, cur, self.mesh, config=self.config.flow
            )
        else:
            u, v, _, _ = coarse_to_fine_pyramids(prev, cur, config=self.config.flow)
        return FrameResult(u, v, detect_gesture(u, v, self.config.gesture))

    def _chunk_first_impl(self, frames):
        """First chunk: N raw frames -> N-2 results + carry (no prior state).

        Reproduces the streaming warm-up (two frames consumed before the
        first result, ParallelVideoPyr.cpp:794-822) inside one traced call.
        """
        grays = preprocess_frame(frames, self.config.preprocess)
        diffs = diff_features(grays[1:], grays[:-1], self.config.preprocess)
        pyr = self._build_pyr_impl(diffs)
        prev = tuple(p[:-1] for p in pyr)
        cur = tuple(p[1:] for p in pyr)
        result = self._flow_from_pyr_pairs(prev, cur)
        carry = (grays[-1], tuple(p[-1] for p in pyr))
        return result, carry

    def _chunk_step_impl(self, carry, frames):
        """Steady-state chunk: carry + N raw frames -> N results + new carry.

        The carry is (last gray, last diff pyramid) so chunk boundaries are
        seamless: results are the same pair sequence the per-frame `push`
        loop produces, but the host dispatches ONE program per chunk instead
        of four per frame (the dispatch-depth lever VERDICT r3 #1 asks the
        bench to sweep)."""
        prev_gray, prev_pyr = carry
        grays = preprocess_frame(frames, self.config.preprocess)
        all_grays = jnp.concatenate([prev_gray[None], grays], axis=0)
        diffs = diff_features(all_grays[1:], all_grays[:-1], self.config.preprocess)
        pyr = self._build_pyr_impl(diffs)
        prev = tuple(
            jnp.concatenate([pp[None], p[:-1]], axis=0)
            for pp, p in zip(prev_pyr, pyr)
        )
        result = self._flow_from_pyr_pairs(prev, pyr)
        carry = (grays[-1], tuple(p[-1] for p in pyr))
        return result, carry

    def run_chunked(
        self,
        frames: Iterable[np.ndarray],
        chunk_size: int = 16,
        prefetch: int = 2,
    ) -> Iterator[FrameResult]:
        """Streaming over chunks: yields one FrameResult of `chunk_size`
        frames (leading batch axis) per dispatch, same pair sequence as
        `run`. Requires faithful_prev_diff=False (the warped-diff feedback
        is per-frame sequential). A short tail (< chunk_size frames) is
        processed per-frame via `push` and yielded as single-frame results
        (no batch axis) to avoid compiling a second chunk shape.
        """
        if self.config.faithful_prev_diff:
            raise ValueError(
                "chunked mode needs faithful_prev_diff=False (the warped-diff "
                "feedback is a sequential dependency)"
            )
        self.reset()
        from optical_flow_tpu.io.prefetch import prefetch_chunks_to_device

        carry = None
        tail: list = []
        for chunk in prefetch_chunks_to_device(
            frames, chunk_size=chunk_size, depth=prefetch
        ):
            if chunk.shape[0] < chunk_size:
                tail.append(chunk)
                break
            if carry is None:
                result, carry = self._chunk_first(chunk)
            else:
                result, carry = self._chunk_step(carry, chunk)
            self._frame_idx += int(chunk.shape[0])
            # seed the per-frame streaming state from the carry EVERY
            # chunk, before yielding: state()/checkpoint and a
            # subsequent push() must continue the pair sequence, not
            # restart the two-frame warm-up — including when the
            # consumer exits the generator early, where a post-loop
            # seeding would be skipped (round-5 review + meta-review)
            self._prev_gray = carry[0]
            self._prev_pyr = carry[1]
            # prev_diff is only consulted for the non-reuse path; the
            # reuse path (faithful_prev_diff=False) keys off _prev_pyr
            self._prev_diff = carry[1][0]
            yield result
        # tail frames: per-frame path, seeded from the chunk carry
        if tail:
            for frame in tail[0]:
                result = self.push(frame)
                if result is not None:
                    yield result

    # --- host loops --------------------------------------------------------

    def push(self, frame: np.ndarray) -> Optional[FrameResult]:
        """Feed one frame; returns a FrameResult once warmed up (the
        reference needs two warm-up frames: one for prevFrame, one for
        prevDiff — ParallelVideoPyr.cpp:794-822)."""
        gray = self._preprocess(jnp.asarray(frame))
        self._frame_idx += 1
        if self._prev_gray is None:
            self._prev_gray = gray
            return None
        diff = self._diff(gray, self._prev_gray)
        self._prev_gray = gray
        if self._reuse_pyramids:
            pyr = self._build_pyr(diff)
            if self._prev_diff is None:
                self._prev_diff = diff
                self._prev_pyr = pyr
                return None
            result = self._flow_step_pyr(self._prev_pyr, pyr)
            self._prev_diff, self._prev_pyr = diff, pyr
            return result
        if self._prev_diff is None:
            self._prev_diff = diff
            return None
        result, self._prev_diff = self._flow_step(self._prev_diff, diff)
        return result

    def run(
        self, frames: Iterable[np.ndarray], prefetch: int = 2
    ) -> Iterator[FrameResult]:
        """Streaming mode over an iterable of frames (resets first).

        prefetch > 0 stages the next frames on device from a background
        thread so decode + H2D hide under compute (SURVEY.md P6); 0
        disables it (frames are transferred inline).
        """
        self.reset()
        if prefetch > 0:
            from optical_flow_tpu.io.prefetch import prefetch_to_device

            frames = prefetch_to_device(frames, depth=prefetch)
        for frame in frames:
            result = self.push(frame)
            if result is not None:
                yield result

    def run_batched(self, frames: np.ndarray) -> FrameResult:
        """Batched mode: frames (N, H, W, 3) uint8 -> FrameResult with a
        leading N-2 batch axis. Requires faithful_prev_diff=False."""
        if self.config.faithful_prev_diff:
            raise ValueError(
                "batched mode needs faithful_prev_diff=False (the warped-diff "
                "feedback is a sequential dependency)"
            )
        grays = self._preprocess(jnp.asarray(frames))
        diffs = self._diff(grays[1:], grays[:-1])
        if self.mesh is None:
            return self._batch_flow_pyr(diffs)
        return self._batch_flow(diffs[:-1], diffs[1:])


def replay_video(path, config: Optional[VideoConfig] = None, max_frames: Optional[int] = None):
    """Convenience: run the pipeline over a video file (reference demo flow,
    but file-fed instead of VideoCapture(0))."""
    from optical_flow_tpu.io.video_reader import read_frames

    cfg = config or VideoConfig()
    pipe = VideoPipeline(cfg)
    frames = read_frames(path, max_frames=max_frames)
    return list(pipe.run(frames))
