"""Serving-layer tests (pipeline/serve.py).

The server is the deployment shape of the reference's live
webcam loop (ParallelVideoPyr.cpp:730-905): a resident process keeps the
compiled pipeline hot and answers frame streams over a socket. Tests run
the real wire protocol against an in-process threaded server on the CPU
backend and hold the responses to bit-identity with a directly-driven
VideoPipeline on the same frames.
"""

import os
import socket
import struct
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from optical_flow_tpu.config import PreprocessConfig, FlowConfig, VideoConfig
from optical_flow_tpu.pipeline.serve import FlowClient, FlowServer
from optical_flow_tpu.pipeline.video import VideoPipeline

H, W = 60, 80  # capture shape
PROC = (48, 64)  # processing shape


def _frames(n, seed=3):
    r = np.random.RandomState(seed)
    base = (r.rand(H, W, 3) * 255).astype(np.uint8)
    return [np.roll(base, shift=2 * i, axis=1) for i in range(n)]


def _direct_results(frames, preset="fast"):
    if preset == "fast":
        cfg = VideoConfig.fast(size=PROC)
    else:
        cfg = VideoConfig(preprocess=PreprocessConfig(size=PROC), flow=FlowConfig())
    pipe = VideoPipeline(cfg)
    out = []
    for f in frames:
        res = pipe.push(f)
        if res is not None:
            out.append(res)
    return out


@pytest.fixture(scope="module")
def server():
    srv = FlowServer(port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _stream(client, frames, **kw):
    hello = client.start_stream(H, W, proc_size=PROC, **kw)
    assert hello["ok"], hello
    replies = [client.push(f) for f in frames]
    tail = client.end_stream()
    return hello, replies, tail


def test_roundtrip_matches_direct_pipeline(server):
    frames = _frames(6)
    with FlowClient(server.address) as c:
        _, replies, tail = _stream(c, frames, preset="fast", return_flow=True)
    assert [r.get("warmup", False) for r in replies] == [True, True] + [False] * 4
    assert tail == {"end": True, "frames": 6}
    direct = _direct_results(frames, preset="fast")
    assert len(direct) == 4
    for reply, res in zip(replies[2:], direct):
        assert reply["votes"] == int(res.gesture.votes)
        assert reply["detected"] == bool(res.gesture.detected)
        assert reply["cx"] == pytest.approx(float(res.gesture.cx))
        assert reply["cy"] == pytest.approx(float(res.gesture.cy))
        # wire format is f32; the pipeline may compute in x64 under tests
        np.testing.assert_array_equal(reply["u"], np.asarray(res.u, np.float32))
        np.testing.assert_array_equal(reply["v"], np.asarray(res.v, np.float32))


def test_second_stream_reuses_pooled_pipeline(server):
    frames = _frames(5, seed=11)
    with FlowClient(server.address) as c:
        hello1, replies1, _ = _stream(c, frames, preset="fast")
        # same connection, new handshake: state must reset (warmups again)
        hello2, replies2, _ = _stream(c, frames, preset="fast")
    assert hello2["pooled"]  # compiled pipeline came back from the pool
    assert [r.get("warmup", False) for r in replies2] == [
        r.get("warmup", False) for r in replies1
    ]
    for a, b in zip(replies1, replies2):
        assert a == b  # identical stream -> identical replies


def test_concurrent_connections_are_isolated(server):
    frames_a = _frames(6, seed=21)
    frames_b = _frames(6, seed=22)
    results = {}

    def run(name, frames):
        with FlowClient(server.address) as c:
            _, replies, _ = _stream(c, frames, preset="fast", return_flow=True)
        results[name] = replies

    ta = threading.Thread(target=run, args=("a", frames_a))
    tb = threading.Thread(target=run, args=("b", frames_b))
    ta.start(), tb.start()
    ta.join(120), tb.join(120)
    assert set(results) == {"a", "b"}
    for name, frames in (("a", frames_a), ("b", frames_b)):
        direct = _direct_results(frames, preset="fast")
        for reply, res in zip(results[name][2:], direct):
            assert reply["votes"] == int(res.gesture.votes)
            np.testing.assert_array_equal(
                reply["u"], np.asarray(res.u, np.float32)
            )


def test_faithful_preset_matches_direct(server):
    frames = _frames(5, seed=31)
    with FlowClient(server.address) as c:
        _, replies, _ = _stream(c, frames, preset="faithful", return_flow=True)
    direct = _direct_results(frames, preset="faithful")
    for reply, res in zip(replies[2:], direct):
        assert reply["votes"] == int(res.gesture.votes)
        np.testing.assert_array_equal(reply["u"], np.asarray(res.u, np.float32))


def test_bad_handshake_is_reported(server):
    with socket.create_connection(server.address, timeout=30) as s:
        s.sendall(b'{"height": "nope"}\n')
        line = s.makefile("rb").readline()
    import json

    resp = json.loads(line)
    assert resp["ok"] is False and "error" in resp


@pytest.mark.parametrize("impl", ["pallas", "mosaic"])
def test_handshake_naming_an_impl_is_refused(server, impl):
    """Each stage has one path: a handshake that asks for another
    implementation gets an error reply, not a pipeline."""
    import json

    hs = {"v": 1, "height": H, "width": W, "proc_height": PROC[0],
          "proc_width": PROC[1], "impl": impl}
    with socket.create_connection(server.address, timeout=30) as s:
        s.sendall(json.dumps(hs).encode() + b"\n")
        resp = json.loads(s.makefile("rb").readline())
    assert resp["ok"] is False and "impl" in resp["error"]


@pytest.mark.parametrize("impl", ["auto", "jnp"])
def test_earlier_client_handshake_still_connects(server, impl):
    """Clients of earlier protocol-1 releases always sent an "impl" key
    ("auto" by default): it names the plain path, so the stream opens,
    serves a frame and ends as usual."""
    import json

    hs = {"v": 1, "height": H, "width": W, "proc_height": PROC[0],
          "proc_width": PROC[1], "return_flow": False, "impl": impl}
    frame = _frames(1)[0]
    with socket.create_connection(server.address, timeout=120) as s:
        f = s.makefile("rb")
        s.sendall(json.dumps(hs).encode() + b"\n")
        assert json.loads(f.readline())["ok"] is True
        s.sendall(struct.pack(">I", frame.nbytes) + frame.tobytes())
        assert json.loads(f.readline()) == {"frame": 0, "warmup": True}
        s.sendall(struct.pack(">I", 0))
        assert json.loads(f.readline()) == {"end": True, "frames": 1}


def test_wrong_frame_length_is_reported(server):
    with FlowClient(server.address) as c:
        hello = c.start_stream(H, W, proc_size=PROC)
        assert hello["ok"]
        resp = c.push(np.zeros((H, W + 2, 3), np.uint8))  # wrong width
    assert resp["ok"] is False and "expected" in resp["error"]


def test_wrong_frame_length_closes_connection_cleanly(server):
    """After the error reply the server must CLOSE the connection, not
    re-enter the handshake loop on the closed socket (ADVICE r4: every
    bad-frame client used to print a handler-thread traceback)."""
    with socket.create_connection(server.address, timeout=30) as s:
        import json as _json

        hs = {"v": 1, "height": H, "width": W, "channels": 3,
              "proc_height": PROC[0], "proc_width": PROC[1]}
        s.sendall(_json.dumps(hs).encode() + b"\n")
        f = s.makefile("rb")
        assert _json.loads(f.readline())["ok"]
        s.sendall(struct.pack(">I", 12) + b"x" * 12)  # wrong length
        assert _json.loads(f.readline())["ok"] is False
        # connection is done: reads drain to EOF, no further handshake
        assert f.read() == b""


def test_negative_dims_rejected_in_handshake(server):
    """-2 x -2 x 1 multiplies to a positive frame size; each dimension is
    validated alone so the reply is the normal error JSON (ADVICE r4)."""
    for hs in (
        {"v": 1, "height": -2, "width": -2, "channels": 1},
        {"v": 1, "height": H, "width": W, "proc_height": -4, "proc_width": 4},
    ):
        with socket.create_connection(server.address, timeout=30) as s:
            import json as _json

            s.sendall(_json.dumps(hs).encode() + b"\n")
            resp = _json.loads(s.makefile("rb").readline())
        assert resp["ok"] is False and "error" in resp


def test_unix_socket_roundtrip(tmp_path):
    if not hasattr(socket, "AF_UNIX"):
        pytest.skip("no AF_UNIX on this platform")
    path = os.path.join(tmp_path, "flow.sock")
    srv = FlowServer(unix_path=path)
    srv.start_background()
    try:
        frames = _frames(4, seed=41)
        with FlowClient(path) as c:
            _, replies, tail = _stream(c, frames, preset="fast")
        assert tail["frames"] == 4
        assert not replies[-1].get("warmup", False)
    finally:
        srv.shutdown()


def test_huge_proc_dims_rejected(server):
    """Handshake proc dims are bounded: an unbounded client value would
    OOM the server host-side via the dense resize matrices (round-5
    review: 65536^2 costs ~34 GB before any frame arrives)."""
    import json as _json

    hs = {"v": 1, "height": 16, "width": 16, "channels": 1,
          "proc_height": 65536, "proc_width": 65536}
    with socket.create_connection(server.address, timeout=30) as s:
        s.sendall(_json.dumps(hs).encode() + b"\n")
        resp = _json.loads(s.makefile("rb").readline())
    assert resp["ok"] is False and "proc dims" in resp["error"]
