"""Host-side IO: video decode and frame feeding.

The reference leans on OpenCV `VideoCapture` for decode
(ParallelVideoPyr.cpp:737). Here decode is host-native (it never belongs on
the device): an ffmpeg raw-pipe backend (own subprocess, zero-copy into numpy)
with a cv2 fallback, plus a double-buffered async prefetcher so decode and
H2D transfer overlap device compute (SURVEY.md P6).
"""

from optical_flow_tpu.io.video_reader import VideoReader, read_frames
from optical_flow_tpu.io.prefetch import prefetch_to_device

__all__ = ["VideoReader", "read_frames", "prefetch_to_device"]
