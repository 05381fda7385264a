"""The port's HTTP surface (`emosaic_tpu_torch.serve._make_handler`, `main`)
on the CPU: `tests/test_serve.py`'s HTTP cases retargeted to the port's
service, with the JAX service's responses as the reference where the
bytes can be compared.

Every wait is bounded: the stalled-stream case parks its client until
the service logs the abort (a 0.5 s spool stall, then a 2 s socket
deadline), at most 60 s each.
"""

import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from emosaic_tpu import serve as jax_serve
from emosaic_tpu_torch import serve
from emosaic_tpu_torch.serve import MosaicService, _make_handler, _Spool
from tests.test_serve import scene  # noqa: F401 — the seeded scene fixture

ROOT = Path(__file__).resolve().parent.parent


def _quiet(*a):
    pass


def _service(scene, **kw):  # noqa: F811
    return MosaicService(scene[0], "1", 8, device="cpu", log=_quiet, **kw)


@contextmanager
def _serving(svc, make_handler=_make_handler, **handler_kw):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc, **handler_kw))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _post(base, data, query="", timeout=120):
    req = urllib.request.Request(f"{base}/mosaic{query}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _error(base, data, query="", method="POST", path="/mosaic", timeout=30):
    req = urllib.request.Request(f"{base}{path}{query}", data=data, method=method)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=timeout)
    return e.value.code, json.loads(e.value.read())


def _pixels(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _dechunk(rest: bytes) -> bytes:
    body = b""
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        body += rest[:n]
        rest = rest[n + 2:]
    return body


def test_healthz_equals_jax(scene):  # noqa: F811
    bodies = []
    for svc, make_handler in (
        (jax_serve.MosaicService(scene[0], "1", 8, log=_quiet), jax_serve._make_handler),
        (_service(scene), _make_handler),
    ):
        with _serving(svc, make_handler) as (base, _):
            with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
                assert r.headers["Content-Type"] == "application/json"
                bodies.append(r.read())
    assert bodies[1] == bodies[0]
    assert json.loads(bodies[1]) == {"status": "ok", "tiles": 10, "mode": "1",
                                     "tile_size": 8}


@pytest.mark.parametrize("query,opts", [("?tint=0.5", {"tint": 0.5}), ("", {}),
                                        ("?randomize=50&seed=7",
                                         {"randomize": 50.0, "seed": 7}),
                                        ("?no_repeat=1&downsample=3",
                                         {"no_repeat": True, "downsample": 3})])
def test_http_round_trip_equals_jax(scene, query, opts):  # noqa: F811
    svc = _service(scene)
    with _serving(svc) as (base, _):
        status, headers, png = _post(base, scene[1], query)
    assert status == 200 and headers["Content-Type"] == "image/png"
    jax_svc = jax_serve.MosaicService(scene[0], "1", 8, log=_quiet)
    assert png == jax_svc.render_bytes(scene[1], **opts)
    assert png == svc.render_bytes(scene[1], **opts)


@pytest.mark.parametrize("query", ["?tint=0.5", "?no_repeat=1&downsample=3"])
def test_http_chunked_stream_equals_buffered_and_jax(scene, query):  # noqa: F811
    """stream_threshold=1 streams every response: the chunked body's
    pixels equal the buffered response's, and its bytes the JAX service's
    chunked body."""
    svc = _service(scene)
    with _serving(svc, stream_threshold=1) as (base, _):
        _, headers, streamed = _post(base, scene[1], query)
    assert headers.get("Content-Length") is None
    assert headers["Transfer-Encoding"] == "chunked"
    with _serving(svc) as (base, _):
        _, _, buffered = _post(base, scene[1], query)
    np.testing.assert_array_equal(_pixels(streamed), _pixels(buffered))
    jax_svc = jax_serve.MosaicService(scene[0], "1", 8, log=_quiet)
    with _serving(jax_svc, jax_serve._make_handler, stream_threshold=1) as (base, _):
        _, _, jax_streamed = _post(base, scene[1], query)
    assert streamed == jax_streamed


def test_http_errors(scene):  # noqa: F811
    svc = _service(scene)
    with _serving(svc) as (base, _):
        # 108 blocks > 2 x 10 tiles: a client error with the message
        code, body = _error(base, scene[1], "?no_repeat=1")
        assert code == 400 and "Insufficient tiles" in body["error"]
        code, _ = _error(base, b"")
        assert code == 400
        code, body = _error(base, b"not an image")
        assert code == 400 and body["error"] == "undecodable image body"
        code, body = _error(base, b"x", path="/nope")
        assert code == 404 and body["error"] == "not found"
        code, body = _error(base, None, method="GET", path="/nope")
        assert code == 404 and body["error"] == "not found"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        assert _post(base, scene[1])[0] == 200


def test_http_413_body_cap_and_pixel_cap(scene):  # noqa: F811
    svc = _service(scene)
    with _serving(svc, max_request_bytes=100) as (base, _):
        code, body = _error(base, scene[1])
        assert code == 413 and "exceeds the 100-byte limit" in body["error"]
    with _serving(svc, max_source_pixels=50) as (base, _):
        code, body = _error(base, scene[1])
        assert code == 413 and "decode limit" in body["error"]


def test_malformed_content_length_400(scene):  # noqa: F811
    with _serving(_service(scene)) as (_, port):
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(b"POST /mosaic HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n")
            data = b""
            while b"invalid Content-Length" not in data:
                got = s.recv(4096)
                if not got:
                    break
                data += got
    assert b" 400 " in data.split(b"\r\n", 1)[0]


def test_device_error_gives_500_and_the_next_request_renders(scene, monkeypatch):  # noqa: F811
    """A device failure inside a render (here torch's out-of-memory
    error) answers with a JSON 500; the service goes on."""
    svc = _service(scene)
    real = svc.render_plan
    calls = []

    def failing_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(*a, **k)

    monkeypatch.setattr(svc, "render_plan", failing_once)
    with _serving(svc) as (base, _):
        code, body = _error(base, scene[1])
        assert code == 500 and body["error"].startswith("OutOfMemoryError")
        status, _, png = _post(base, scene[1])
    assert status == 200 and png == svc.render_bytes(scene[1])


def _in_flight(svc, monkeypatch):
    """Make the next render wait for `release` after setting `entered`."""
    entered, release = threading.Event(), threading.Event()
    real = svc.render_plan

    def slow_plan(*a, **k):
        entered.set()
        assert release.wait(30), "release never set"
        return real(*a, **k)

    monkeypatch.setattr(svc, "render_plan", slow_plan)
    return entered, release, real


def test_healthz_responsive_during_inflight_render(scene, monkeypatch):  # noqa: F811
    svc = _service(scene)
    entered, release, real = _in_flight(svc, monkeypatch)
    result = {}
    with _serving(svc) as (base, _):
        th = threading.Thread(target=lambda: result.update(png=_post(base, scene[1])[2]),
                              daemon=True)
        th.start()
        assert entered.wait(30)
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        release.set()
        th.join(timeout=120)
        assert not th.is_alive()
    monkeypatch.setattr(svc, "render_plan", real)
    assert result["png"] == svc.render_bytes(scene[1])


def test_http_503_when_pending_bound_exceeded(scene, monkeypatch):  # noqa: F811
    svc = _service(scene)
    entered, release, real = _in_flight(svc, monkeypatch)
    result = {}
    with _serving(svc, max_pending=1) as (base, _):
        th = threading.Thread(target=lambda: result.update(png=_post(base, scene[1])[2]),
                              daemon=True)
        th.start()
        assert entered.wait(30)
        code, body = _error(base, scene[1], timeout=10)
        assert code == 503 and "busy" in body["error"]
        release.set()
        th.join(timeout=120)
        assert not th.is_alive()
    monkeypatch.setattr(svc, "render_plan", real)
    assert result["png"] == svc.render_bytes(scene[1])


def test_http11_keepalive_not_poisoned_by_unread_body(scene):  # noqa: F811
    svc = _service(scene)
    with _serving(svc) as (base, port):
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(
                b"POST /wrongpath HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: %d\r\n\r\n" % len(scene[1]) + scene[1]
            )
            data = b""
            s.settimeout(5)
            try:
                while True:  # read to EOF: the server must close
                    got = s.recv(65536)
                    if not got:
                        break
                    data += got
            except TimeoutError:
                raise AssertionError("the server kept a poisoned connection open")
        assert b"404" in data.split(b"\r\n", 1)[0]
        assert data.count(b"HTTP/1.1") == 1  # the body was not parsed as a request
        assert _post(base, scene[1])[0] == 200


def test_slow_loris_body_times_out_and_frees_the_server(scene):  # noqa: F811
    svc = _service(scene)
    with _serving(svc, max_pending=1, io_timeout=1.0) as (base, port):
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.sendall(b"POST /mosaic HTTP/1.1\r\nHost: x\r\nContent-Length: 1000\r\n\r\n")
        s.settimeout(30)
        assert s.recv(4096) == b""  # EOF after the 1 s deadline
        s.close()
        assert _post(base, scene[1])[2] == svc.render_bytes(scene[1])


def test_spool_bounds_and_stall():
    # FIFO + drain/close
    sp = _Spool(budget=1 << 20, stall_secs=0)
    sp.write(b"ab")
    sp.write(b"cd")
    sp.close()
    assert sp.get() == b"ab" and sp.get() == b"cd" and sp.get() is None

    # budget backpressure: a second write blocks until the consumer drains
    sp = _Spool(budget=2, stall_secs=0)
    sp.write(b"xx")
    done = threading.Event()
    t = threading.Thread(target=lambda: (sp.write(b"yy"), done.set()), daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()
    assert sp.get() == b"xx"
    assert done.wait(5)
    sp.close()
    assert sp.get() == b"yy" and sp.get() is None

    # stall policy: a full spool with no consumer raises in the producer
    sp = _Spool(budget=1, stall_secs=0.2)
    sp.write(b"z")
    with pytest.raises(TimeoutError):
        sp.write(b"z")

    # cancel: a blocked producer aborts at once, and so do later writes
    sp = _Spool(budget=1, stall_secs=0)
    sp.write(b"z")
    err = {}

    def cancelled_writer():
        try:
            sp.write(b"z")
        except BrokenPipeError as e:
            err["e"] = e

    t = threading.Thread(target=cancelled_writer, daemon=True)
    t.start()
    time.sleep(0.1)
    sp.cancel()
    t.join(timeout=5)
    assert not t.is_alive() and "e" in err
    with pytest.raises(BrokenPipeError):
        sp.write(b"w")

    # fail: the consumer drains what is there, then sees the failure
    sp = _Spool(budget=8, stall_secs=0)
    sp.write(b"ab")
    sp.fail()
    assert sp.get() == b"ab" and sp.get() is None and sp.failed


def test_stream_slow_client_does_not_block_next_render(scene):  # noqa: F811
    svc = _service(scene)
    ref = svc.render_bytes(scene[1])
    with _serving(svc, stream_threshold=1) as (base, port):
        a = socket.create_connection(("127.0.0.1", port), timeout=60)
        a.sendall(b"POST /mosaic HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                  % len(scene[1]) + scene[1])
        first = a.recv(64)
        assert first.startswith(b"HTTP/1.1 200")
        # client B completes while A is parked mid-response
        np.testing.assert_array_equal(_pixels(_post(base, scene[1])[2]), _pixels(ref))
        a.settimeout(60)
        data = first
        while not data.endswith(b"0\r\n\r\n"):
            got = a.recv(65536)
            if not got:
                break
            data += got
        a.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    assert b"Transfer-Encoding: chunked" in head
    np.testing.assert_array_equal(_pixels(_dechunk(rest)), _pixels(ref))


def test_stream_stalled_client_aborts_render_and_frees_the_lock(scene, rng, monkeypatch):  # noqa: F811
    """A client that stops reading: the spool fills, the producer aborts
    after the 0.5 s stall, the socket write dies at the 2 s deadline, the
    band generator is closed mid-stream (on the card that frees its
    tensors), and the next request renders. The 384x384 random source
    gives a ~28 MB PNG, more than the socket buffers hold; composed in
    1 MB bands and encoded by one worker (each 1 MiB segment goes to the
    spool as it is made), the stall finds the generator suspended."""
    import functools

    monkeypatch.setattr(serve, "stream_tinted_bands",
                        functools.partial(serve.stream_tinted_bands, band_budget=1 << 20))
    monkeypatch.setattr(serve, "StreamingPNGWriter",
                        functools.partial(serve.StreamingPNGWriter, workers=1))
    svc = _service(scene)
    big = rng.integers(0, 256, size=(384, 384, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(big).save(buf, "PNG")
    big_bytes = buf.getvalue()
    svc.render_bytes(big_bytes)  # the mode-1 LUT of this library, cached
    plans = []
    real = svc.render_plan

    def recording_plan(*a, **k):
        plan = real(*a, **k)
        plans.append(plan)
        return plan

    monkeypatch.setattr(svc, "render_plan", recording_plan)
    aborted, lost = threading.Event(), threading.Event()

    def log(msg, *a):
        if "stream aborted" in msg:
            aborted.set()
        if "stream client lost" in msg:
            lost.set()

    svc.log = log
    with _serving(svc, stream_threshold=1, spool_bytes=4096, spool_stall_secs=0.5,
                  io_timeout=2.0) as (base, port):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.settimeout(60)
        s.connect(("127.0.0.1", port))
        s.sendall(b"POST /mosaic HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                  % len(big_bytes) + big_bytes)
        # parked, not reading, until the producer has given up on the full
        # spool and the blocked socket write has hit its deadline
        assert aborted.wait(60) and lost.wait(60)
        s.settimeout(30)
        data = b""
        while True:
            try:
                got = s.recv(65536)
            except TimeoutError:
                raise AssertionError("the server kept the stalled stream open")
            if not got:
                break
            data += got
        s.close()
        assert data.startswith(b"HTTP/1.1 200")
        assert not data.endswith(b"0\r\n\r\n")  # truncated, not completed
        (kind, _, _, bands), = plans
        assert kind == "stream" and bands.gi_frame is None  # the generator is closed
        _, _, png = _post(base, scene[1])
    monkeypatch.setattr(svc, "render_plan", real)
    np.testing.assert_array_equal(_pixels(png), _pixels(svc.render_bytes(scene[1])))


def _start_server(args, tmp_path, code=None):
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path / "xdg"), EMOSAIC_PREP_WORKERS="0")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    cmd = ([sys.executable, "-c", code] if code
           else [sys.executable, "-m", "emosaic_tpu_torch.serve"])
    return subprocess.Popen([*cmd, *args], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _serving_port(proc) -> int:
    deadline = time.time() + 180
    for line in proc.stderr:
        m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
        if m:
            return int(m.group(1))
        assert time.time() < deadline, "the server never came up"
    raise AssertionError(f"no serving banner (exit {proc.wait(timeout=30)})")


def _stop(proc):
    proc.send_signal(signal.SIGINT)  # KeyboardInterrupt -> a clean exit
    try:
        return proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=30)
        raise


def test_serve_main_subprocess_device_cpu(scene, tmp_path):  # noqa: F811
    """`python -m emosaic_tpu_torch.serve ... --device cpu`: argparse,
    service, warmup, the banner, /healthz and one request."""
    proc = _start_server([str(scene[0]), "-m", "1", "-s", "8", "--port", "0",
                          "--warmup", "16x16", "--device", "cpu"], tmp_path)
    try:
        port = _serving_port(proc)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "tiles": 10, "mode": "1",
                                            "tile_size": 8}
        status, _, png = _post(f"http://127.0.0.1:{port}", scene[1], "?seed=0")
        assert status == 200 and _pixels(png).shape == (9 * 8, 12 * 8, 3)
    finally:
        _stop(proc)
    assert proc.returncode == 0


def test_serve_subprocess_imports_neither_jax_nor_emosaic_tpu(scene, tmp_path):  # noqa: F811
    """The service's whole life in one process (start, warmup, a request,
    SIGINT): jax and emosaic_tpu never enter sys.modules."""
    code = (
        "import sys\n"
        "from emosaic_tpu_torch.serve import main\n"
        "rc = main(sys.argv[1:])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'emosaic_tpu'))\n"
        "print('CLEAN' if rc == 0 and not bad else f'DIRTY {rc} {bad}')\n"
    )
    proc = _start_server([str(scene[0]), "-m", "2", "-s", "8", "--port", "0",
                          "--warmup", "16x16", "--device", "cpu"], tmp_path, code=code)
    try:
        port = _serving_port(proc)
        assert _post(f"http://127.0.0.1:{port}", scene[1], "?tint=0.2")[0] == 200
    finally:
        out, _ = _stop(proc)
    assert "CLEAN" in out, out


def test_main_device_cuda_without_gpu_raises(scene):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda serves instead of raising")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([str(scene[0]), "-m", "1", "-s", "8", "--port", "0"])
