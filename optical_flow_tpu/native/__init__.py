"""ctypes bindings for the native host runtime (framepipe.cpp).

The library is built on demand (make -C optical_flow_tpu/native) and every
caller has a pure-Python fallback, so the package works without a C++
toolchain — just slower host IO.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_DIR = Path(__file__).parent
_LIB_PATH = _DIR / "libframepipe.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", str(_DIR), "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH.exists()
    except Exception:
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.exists() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.fp_open.restype = ctypes.c_void_p
        lib.fp_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fp_open_at.restype = ctypes.c_void_p
        lib.fp_open_at.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fp_open_fmt.restype = ctypes.c_void_p
        lib.fp_open_fmt.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fp_probe.restype = ctypes.c_int
        lib.fp_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fp_next.restype = ctypes.c_int
        lib.fp_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.fp_buffered.restype = ctypes.c_int
        lib.fp_buffered.argtypes = [ctypes.c_void_p]
        lib.fp_close.restype = None
        lib.fp_close.argtypes = [ctypes.c_void_p]
        lib.cam_open.restype = ctypes.c_void_p
        lib.cam_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.cam_next.restype = ctypes.c_int
        lib.cam_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.cam_close.restype = None
        lib.cam_close.argtypes = [ctypes.c_void_p]
        lib.gf_load.restype = ctypes.c_long
        lib.gf_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        lib.gf_save.restype = ctypes.c_int
        lib.gf_save.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long]
        _lib = lib
        return _lib


def probe_native(path):
    """(width, height, fps) from container headers only (no decode thread);
    None if the native library is unavailable or the file can't be opened."""
    lib = load_library()
    if lib is None:
        return None
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    fps = ctypes.c_double(0.0)
    rc = lib.fp_probe(
        str(path).encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps)
    )
    if rc != 0:
        return None
    return w.value, h.value, fps.value


class NativeFramePipe:
    """Ring-buffered libavcodec decode on a C++ thread (overlaps compute)."""

    def __init__(self, path: str, ring: int = 4, start: int = 0,
                 gray: bool = False):
        """start > 0 seeks the container (av_seek_frame to the preceding
        keyframe + decode-discard to the exact frame) before streaming —
        O(GOP) instead of decoding `start` frames. Raises RuntimeError if
        the stream can't seek (caller falls back to decode-and-skip).

        gray=True yields (H, W) GRAY8 frames — BT.601 luma straight from
        libswscale, one byte per pixel: a third of the bytes crossing
        host->device, for consumers that gray-convert first anyway (the
        fast-preset preprocess)."""
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        fps = ctypes.c_double(0.0)
        self._h = lib.fp_open_fmt(
            str(path).encode(), ring, start, 1 if gray else 0,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
        )
        if not self._h:
            raise RuntimeError(f"fp_open failed for {path} (start={start})")
        self.width = w.value
        self.height = h.value
        self.fps = fps.value
        self.gray = bool(gray)
        shape = (self.height, self.width) if gray else (self.height, self.width, 3)
        self._buf = np.empty(shape, np.uint8)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok = self._lib.fp_next(
                self._h, self._buf.ctypes.data_as(ctypes.c_char_p)
            )
            if not ok:
                break
            yield self._buf.copy()

    def buffered(self) -> int:
        return int(self._lib.fp_buffered(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.fp_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeCamera:
    """Live V4L2 capture via the kernel API (native/v4l2cap.cpp) — the
    reference's cv::VideoCapture(0) modality (ParallelVideoPyr.cpp:737)
    without OpenCV: ioctl + mmap streaming ring, libswscale conversion to
    BGR24 (or decode-time GRAY8), MJPEG cameras through libavcodec."""

    def __init__(self, device: str = "/dev/video0", gray: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        fps = ctypes.c_double(0.0)
        self._h = lib.cam_open(
            str(device).encode(), 1 if gray else 0,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
        )
        if not self._h:
            raise RuntimeError(f"cam_open failed for {device}")
        self.width = w.value
        self.height = h.value
        self.fps = fps.value
        self.gray = bool(gray)
        shape = (self.height, self.width) if gray else (self.height, self.width, 3)
        self._buf = np.empty(shape, np.uint8)

    def __iter__(self) -> Iterator[np.ndarray]:
        if not self._h:
            # the camera is single-shot: a previous iteration's cleanup
            # closed the device — fail loudly instead of silently
            # yielding zero frames (file backends re-open per iteration;
            # a kernel capture stream cannot)
            raise RuntimeError(
                "NativeCamera already closed (cameras are single-"
                "iteration; open a new NativeCamera to capture again)"
            )
        while True:
            ok = self._lib.cam_next(
                self._h, self._buf.ctypes.data_as(ctypes.c_char_p)
            )
            if not ok:
                break
            yield self._buf.copy()

    def close(self) -> None:
        if self._h:
            self._lib.cam_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def load_mat_native(path, rows: int, cols: int) -> Optional[np.ndarray]:
    """saveMat-format text matrix via the C parser; None if unavailable."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty(rows * cols, np.float64)
    n = lib.gf_load(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows * cols
    )
    if n != rows * cols:
        return None
    return out.reshape(rows, cols)


def save_mat_native(mat: np.ndarray, path) -> bool:
    lib = load_library()
    if lib is None:
        return False
    mat = np.ascontiguousarray(mat, np.float64)
    rows, cols = mat.shape
    rc = lib.gf_save(
        str(path).encode(), mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols
    )
    return rc == 0
