"""One warp choice, the same on every backend
(flow/coarse_to_fine.py resolve_warp_impl), the compile-cache placement,
and decoder entry points that start no second JAX process."""

import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

from optical_flow_tpu.config import FlowConfig, PreprocessConfig, VideoConfig
from optical_flow_tpu.flow.coarse_to_fine import resolve_warp_impl
from optical_flow_tpu.utils import compile_cache

BACKENDS = ["cpu", "gpu"]


def _faithful_pipeline_flow():
    from optical_flow_tpu.pipeline.video import VideoPipeline

    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(32, 32)), flow=FlowConfig(warp_clamp=8.0)
    )
    return VideoPipeline(cfg).config.flow


# what warp_impl='auto' resolves to, through the entry point each user calls
WARP_CASES = {
    "fast_preset": (lambda: VideoConfig.fast().flow, ("shift_sep", 4)),
    "clamped": (lambda: FlowConfig(warp_clamp=6.0), ("shift_sep", 3)),
    "unclamped": (lambda: FlowConfig(), ("gather", 0)),
    "faithful_prev_diff_pipeline": (_faithful_pipeline_flow, ("gather", 0)),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_path_table_ignores_backend(case, backend, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    make_config, expected = WARP_CASES[case]
    assert resolve_warp_impl(make_config()) == expected


@pytest.mark.parametrize("impl", ["gather", "shift_sep"])
def test_explicit_impl_passes_through(impl):
    assert resolve_warp_impl(FlowConfig(warp_clamp=8.0, warp_impl=impl))[0] == impl


def test_faithful_pipeline_keeps_an_explicit_warp():
    """Only 'auto' becomes the exact gather under faithful_prev_diff: a
    warp the caller names is kept."""
    from optical_flow_tpu.pipeline.video import VideoPipeline

    cfg = VideoConfig(
        preprocess=PreprocessConfig(size=(32, 32)),
        flow=FlowConfig(warp_clamp=8.0, warp_impl="shift_sep"),
    )
    assert VideoPipeline(cfg).config.flow.warp_impl == "shift_sep"


def test_unclamped_auto_warp_is_the_exact_gather():
    assert resolve_warp_impl(FlowConfig()) == ("gather", 0)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    monkeypatch.setattr(compile_cache, "_enabled", False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    # the env var's directory is JAX's own: nothing here overrides it
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(repo, ".xla_cache")


def test_cache_dir_is_never_a_temp_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    tmp = os.path.realpath(tempfile.gettempdir())
    assert not os.path.realpath(compile_cache.cache_dir()).startswith(tmp + os.sep)


def _decode_entry(name, tmp_path):
    if name == "video_reader":
        from optical_flow_tpu.io.video_reader import VideoReader

        raw = tmp_path / "frames.raw"
        raw.write_bytes(np.zeros((2, 4, 6, 3), np.uint8).tobytes())
        return sum(1 for _ in VideoReader(f"pipe:6x4:{raw}"))
    if name == "video_writer":
        from optical_flow_tpu.io.video_writer import VideoWriter

        with VideoWriter(tmp_path / "out", backend="png") as w:
            w.write(np.zeros((4, 6, 3), np.uint8))
        return w.frames_written
    if name == "imread_gray":
        from optical_flow_tpu.utils.images import imread_gray
        from optical_flow_tpu.utils.viz import save_png

        save_png(np.zeros((4, 6, 3), np.uint8), tmp_path / "a.png")
        return imread_gray(tmp_path / "a.png").shape
    from optical_flow_tpu import native

    return native.load_library()


@pytest.mark.parametrize(
    "entry", ["video_reader", "video_writer", "imread_gray", "native_library"]
)
def test_decoder_entry_starts_no_python_process(entry, tmp_path, monkeypatch):
    """No decode entry point spawns a second Python (JAX) process: on a
    card the parent already holds, that child could not reserve memory."""
    launched = []
    real_popen = subprocess.Popen

    def popen(args, *a, **kw):
        launched.append(args)
        return real_popen(args, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", popen)
    _decode_entry(entry, tmp_path)
    argv = [a if isinstance(a, (list, tuple)) else [a] for a in launched]
    assert not [a for a in argv if sys.executable in map(str, a)]


def test_cli_does_not_fall_back_to_cpu(capsys):
    from optical_flow_tpu.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["track", "--input", "nothing.mp4"])
    assert e.value.code != 0
    assert "--cpu" in capsys.readouterr().err
