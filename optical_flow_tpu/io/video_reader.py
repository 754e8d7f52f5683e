"""Video decode backends.

Preferred backend is an ffmpeg subprocess streaming raw BGR24 frames over a
pipe — no per-frame Python codec work, and decode runs concurrently with
device compute in its own process (the replacement for the
reference's synchronous `capture >> frame`, ParallelVideoPyr.cpp:782).
Falls back to cv2.VideoCapture when ffmpeg is unavailable.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np


def _probe_ffmpeg(path: str) -> Optional[Tuple[int, int, float]]:
    """(width, height, fps) via ffprobe, or None if unavailable."""
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return None
    try:
        out = subprocess.run(
            [
                ffprobe, "-v", "error", "-select_streams", "v:0",
                "-show_entries", "stream=width,height,avg_frame_rate",
                "-of", "json", path,
            ],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        st = json.loads(out)["streams"][0]
        num, den = st["avg_frame_rate"].split("/")
        fps = float(num) / float(den) if float(den) else 0.0
        return int(st["width"]), int(st["height"]), fps
    except Exception:
        return None


def _parse_pipe_spec(spec: str):
    """'pipe:WxH[@FPS]:PATH' -> (width, height, fps, path) or None.

    A rawvideo pipe source (BGR24, or GRAY8 with gray=True) — how an
    external capture tool (a remote ffmpeg/gstreamer grabbing a camera,
    a renderer) feeds frames in through a FIFO without re-encoding."""
    if not spec.startswith("pipe:"):
        return None
    try:
        geom, path = spec[5:].split(":", 1)
        if "@" in geom:
            geom, fps = geom.split("@", 1)
            fps = float(fps)
        else:
            fps = 0.0
        w, h = (int(x) for x in geom.split("x"))
        return w, h, fps, path
    except ValueError:
        raise ValueError(
            f"bad pipe spec {spec!r}: expected pipe:WxH[@FPS]:PATH"
        ) from None


def _parse_device_spec(path):
    """Camera sources -> '/dev/videoN' device path, else None.

    Accepts an int, a digit string, 'device:N' and '/dev/videoN' — the
    reference's VideoCapture(0) modality (ParallelVideoPyr.cpp:737)."""
    if isinstance(path, int):
        return f"/dev/video{path}"
    s = str(path)
    if s.isdigit():
        return f"/dev/video{int(s)}"
    if s.startswith("device:") and s[7:].isdigit():
        return f"/dev/video{int(s[7:])}"
    if s.startswith("/dev/video"):
        return s
    return None


class VideoReader:
    """Iterate HxWx3 uint8 BGR frames from a video file, camera or pipe.

    Camera sources — an integer, 'device:N' or '/dev/videoN' (the
    reference's VideoCapture(0), ParallelVideoPyr.cpp:737) — capture via
    the native V4L2 backend (ioctl+mmap, native/v4l2cap.cpp), falling
    back to cv2.VideoCapture. 'pipe:WxH[@FPS]:PATH' reads rawvideo frames
    from a FIFO/file (an external capture tool's output).

    gray=True yields (H, W) GRAY8 frames instead — BT.601 luma produced
    during decode (libswscale/ffmpeg), so a third of the bytes cross
    host->device for gray-first consumers (the fast-preset pipeline).
    """

    def __init__(self, path, backend: str = "auto", gray: bool = False):
        self.gray = bool(gray)
        pipe = _parse_pipe_spec(path) if isinstance(path, str) else None
        if pipe is not None:
            self.width, self.height, self.fps, self.path = pipe
            self.backend = "pipe"
            return
        dev = _parse_device_spec(path)
        if dev is not None:
            self.path = dev
            self._init_camera(backend)
            return
        self.path = str(path)
        if not Path(self.path).exists():
            raise FileNotFoundError(self.path)
        ffprobe_result = None
        native_probe = None
        if backend == "auto":
            from optical_flow_tpu.native import load_library, probe_native

            # selection commits only to a backend whose PROBE succeeds:
            # a loaded native library whose linked libavformat can't open
            # this particular file must fall through to ffmpeg/cv2, as
            # the module docstring promises (round-5 review)
            native_probe = (
                probe_native(self.path) if load_library() is not None else None
            )
            if native_probe is not None:
                backend = "native"
            else:
                ffprobe_result = (
                    _probe_ffmpeg(self.path) if shutil.which("ffmpeg") else None
                )
                backend = "ffmpeg" if ffprobe_result else "cv2"
        self.backend = backend
        if backend == "native":
            from optical_flow_tpu.native import probe_native

            probe = native_probe or probe_native(self.path)
            if probe is None:
                raise RuntimeError(f"native probe failed for {self.path}")
            self.width, self.height, self.fps = probe
        elif backend == "ffmpeg":
            # reuse the auto-selection probe (one ffprobe per open); an
            # EXPLICIT ffmpeg backend gets a clear error instead of a
            # NoneType unpack when ffprobe is missing or can't parse
            probe = ffprobe_result or _probe_ffmpeg(self.path)
            if probe is None:
                raise RuntimeError(
                    f"ffprobe unavailable or failed for {self.path} "
                    "(backend='ffmpeg' requires a working ffprobe)"
                )
            self.width, self.height, self.fps = probe
        elif backend == "cv2":
            import cv2

            cap = cv2.VideoCapture(self.path)
            self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.fps = cap.get(cv2.CAP_PROP_FPS)
            cap.release()
        else:
            raise ValueError(f"unknown backend {backend!r}")

    def _init_camera(self, backend: str):
        # native V4L2 first (ioctl+mmap ring, v4l2cap.cpp), cv2 fallback
        if backend in ("auto", "v4l2"):
            from optical_flow_tpu.native import NativeCamera, load_library

            if load_library() is None:
                # an EXPLICIT v4l2 request must not silently degrade to
                # cv2 (same contract as the explicit ffmpeg backend)
                if backend == "v4l2":
                    raise RuntimeError(
                        "backend='v4l2' requires the native library "
                        "(make -C optical_flow_tpu/native)"
                    )
            else:
                try:
                    cam = NativeCamera(self.path, gray=self.gray)
                    self.backend = "v4l2"
                    self.width, self.height, self.fps = (
                        cam.width, cam.height, cam.fps,
                    )
                    self._camera = cam
                    return
                except RuntimeError:
                    if backend == "v4l2":
                        raise
        import cv2

        self.backend = "cv2"
        # cv2 wants the device INDEX
        idx = self.path
        if isinstance(idx, str) and idx.startswith("/dev/video"):
            idx = int(idx[len("/dev/video"):])
        self.path = idx
        cap = cv2.VideoCapture(self.path)
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = cap.get(cv2.CAP_PROP_FPS)
        cap.release()

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.backend == "v4l2":
            with getattr(self, "_camera") as cam:
                yield from cam
        elif self.backend == "pipe":
            yield from self._iter_pipe()
        elif self.backend == "native":
            yield from self._iter_native()
        elif self.backend == "ffmpeg":
            yield from self._iter_ffmpeg()
        else:
            yield from self._iter_cv2()

    def _iter_pipe(self):
        ch = 1 if self.gray else 3
        nbytes = self.width * self.height * ch
        shape = (
            (self.height, self.width)
            if self.gray
            else (self.height, self.width, 3)
        )
        with open(self.path, "rb", buffering=nbytes * 4) as f:
            while True:
                buf = f.read(nbytes)
                if len(buf) < nbytes:
                    break
                yield np.frombuffer(buf, np.uint8).reshape(shape)

    def _iter_native(self):
        from optical_flow_tpu.native import NativeFramePipe

        with NativeFramePipe(self.path, gray=self.gray) as pipe:
            yield from pipe

    def _iter_ffmpeg(self):
        ch = 1 if self.gray else 3
        nbytes = self.width * self.height * ch
        proc = subprocess.Popen(
            [
                shutil.which("ffmpeg"), "-v", "error", "-i", self.path,
                "-f", "rawvideo", "-pix_fmt", "gray" if self.gray else "bgr24",
                "-",
            ],
            stdout=subprocess.PIPE,
            bufsize=nbytes * 4,
        )
        try:
            shape = (
                (self.height, self.width)
                if self.gray
                else (self.height, self.width, 3)
            )
            while True:
                buf = proc.stdout.read(nbytes)
                if len(buf) < nbytes:
                    break
                yield np.frombuffer(buf, np.uint8).reshape(shape)
        finally:
            proc.stdout.close()
            proc.terminate()
            proc.wait()

    def _iter_cv2(self):
        import cv2

        cap = cv2.VideoCapture(self.path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                # host-side gray: cv2 has no decode-time luma output, but
                # the H2D saving is the same
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if self.gray else frame
        finally:
            cap.release()


def read_frames(
    path,
    max_frames: Optional[int] = None,
    start: int = 0,
    stride: int = 1,
    gray: bool = False,
) -> Iterator[np.ndarray]:
    """Frames [start::stride], up to max_frames of them.

    start/stride cover the reference demo's frame scrubbing
    (OpticalFlowDemo.cpp:265-274 keyboard stepping). With the native
    decoder, `start` uses container seeking (av_seek_frame to the
    preceding keyframe + decode-discard to the exact frame — O(GOP)
    instead of decoding `start` frames); other backends, or streams that
    can't seek, skip decoded frames, which is exact for any codec.
    gray=True yields (H, W) decode-time luma (see VideoReader).
    """
    if stride < 1:
        raise ValueError("stride must be >= 1 (decode cannot run backwards)")
    reader = VideoReader(path, gray=gray)
    source: Iterator[np.ndarray] = iter(reader)
    base = 0
    if start > 0 and getattr(reader, "backend", None) == "native":
        from optical_flow_tpu.native import NativeFramePipe

        try:
            pipe = NativeFramePipe(reader.path, start=start, gray=gray)

            def _seeked():
                with pipe:
                    yield from pipe

            source, base = _seeked(), start
        except RuntimeError:
            pass  # unseekable stream: decode-and-skip below
    yielded = 0
    for i, frame in enumerate(source, start=base):
        if i < start or (i - start) % stride:
            continue
        if max_frames is not None and yielded >= max_frames:
            break
        yield frame
        yielded += 1
