"""Phase unwrapping (np.unwrap parity + IIR) and host utilities."""

import os

import numpy as np
import pytest

import simplestereo_jax as ss
from simplestereo_jax import unwrapping


class TestUnwrap:
    def test_matches_numpy_1d(self, rng):
        phi = np.cumsum(rng.normal(0, 0.8, 200))
        wrapped = np.angle(np.exp(1j * phi))
        ours = np.asarray(unwrapping.unwrap(wrapped[None, :], axis=1))[0]
        theirs = np.unwrap(wrapped)
        np.testing.assert_allclose(ours, theirs, atol=1e-5)

    def test_axis0(self, rng):
        phi = np.cumsum(rng.normal(0, 0.8, (100, 3)), axis=0)
        wrapped = np.angle(np.exp(1j * phi))
        ours = np.asarray(unwrapping.unwrap(wrapped, axis=0))
        np.testing.assert_allclose(ours, np.unwrap(wrapped, axis=0),
                                   atol=1e-5)

    def test_unwrap2d_ramp(self):
        H, W = 32, 64
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        phi = 0.3 * xs + 0.2 * ys
        wrapped = np.angle(np.exp(1j * phi))
        out = np.asarray(unwrapping.unwrap2D(wrapped))
        # gradient recovered everywhere (absolute offset is arbitrary)
        np.testing.assert_allclose(np.diff(out, axis=1), 0.3, atol=1e-4)
        np.testing.assert_allclose(np.diff(out, axis=0), 0.2, atol=1e-4)


class TestIIR:
    def test_recovers_smooth_ramp(self):
        """Estrada 2011 IIR unwrap on a noiseless phase ramp."""
        H, W = 24, 48
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        phi = 0.25 * xs + 0.1 * ys
        wrapped = np.angle(np.exp(1j * phi))
        out = np.asarray(unwrapping.infiniteImpulseResponse(wrapped, 1.0))
        d = out - phi
        assert np.abs(d - d.mean()).max() < 1e-3

    def test_idempotent_call(self):
        """The reference warns 'if called twice, it may not work'
        (unwrapping.py:38-39) — ours must be a pure function."""
        rng = np.random.default_rng(0)
        phi = np.cumsum(rng.normal(0, 0.3, (10, 20)), axis=1)
        wrapped = np.angle(np.exp(1j * phi))
        a = np.asarray(unwrapping.infiniteImpulseResponse(wrapped, 0.5))
        b = np.asarray(unwrapping.infiniteImpulseResponse(wrapped, 0.5))
        np.testing.assert_array_equal(a, b)

    def test_bad_tau(self):
        with pytest.raises(ValueError):
            unwrapping.infiniteImpulseResponse(np.zeros((4, 4)), -1.0)


class TestCapture:
    def test_file_sequence(self, tmp_path, rng):
        from simplestereo_jax.imgio import imwrite
        paths = []
        for i in range(3):
            p = tmp_path / f"{i}.png"
            imwrite(str(p), rng.integers(0, 255, (8, 10, 3), np.uint8))
            paths.append(str(p))
        import time
        with ss.utils.Capture(paths) as cap:
            for _ in range(50):
                f = cap.get()
                if f is not None:
                    break
                time.sleep(0.01)
        assert f is not None and f.shape == (8, 10, 3)
        assert cap.getResolution() in (None, (10, 8))

    def test_callable_source(self):
        import itertools
        import time
        counter = itertools.count()
        src = lambda: np.full((4, 4), next(counter), np.uint8)
        cap = ss.utils.Capture(src)
        cap.start()
        time.sleep(0.05)
        f1 = cap.get()
        cap.stop()
        assert f1 is not None


def test_move_extrinsic_origin(rng):
    from simplestereo_jax.calibration import ba
    R1 = ba._rodrigues(rng.normal(0, 0.5, 3))
    R2 = ba._rodrigues(rng.normal(0, 0.5, 3))
    t1 = rng.normal(0, 10, 3)
    t2 = rng.normal(0, 10, 3)
    R, t = ss.utils.moveExtrinsicOriginToFirstCamera(R1, R2, t1, t2)
    # a world point must land at the same camera-2 coords either way
    X = rng.normal(0, 5, 3)
    x1 = R1 @ X + t1
    np.testing.assert_allclose(R @ x1 + t.ravel(), R2 @ X + t2, atol=1e-9)


def test_draw_epipolar_lines_returns_copies(rig2, rng):
    img1 = rng.integers(0, 255, (720, 1280, 3), np.uint8)
    img2 = rng.integers(0, 255, (720, 1280, 3), np.uint8)
    img1.setflags(write=False)
    F = np.asarray(rig2.getFundamentalMatrix())
    o1, o2 = ss.utils.drawCorrespondingEpipolarLines(
        img1, img2, F, x1=[(640, 360)])
    assert (o1 != img1).any() or (o2 != img2).any()


def test_profiling_throughput_and_memory(tmp_path):
    import numpy as np
    import jax.numpy as jnp
    from simplestereo_jax import profiling

    meter = profiling.Throughput("warp", unit="Mpix")
    for i in range(3):
        with meter.measure(0.5):
            np.asarray(jnp.arange(16) * i)
    rep = meter.report()
    assert rep["samples"] == 3 and rep["median_s"] > 0
    assert "Mpix_per_s" in rep

    mem = profiling.device_memory()
    assert len(mem) >= 1

    with profiling.annotate("test-region"):
        pass

    with profiling.trace(tmp_path):
        np.asarray(jnp.ones(8) + 1)
    import os
    assert any(os.scandir(tmp_path))


class TestCaptureDrivers:
    """Capture live-source parity (reference utils.py:13-181): driver
    protocol, control-method semantics, V4L2 open path, YUYV decode."""

    class SynthCamera:
        """Synthetic camera implementing the Capture driver protocol."""

        def __init__(self):
            self.w, self.h, self.fps = 16, 12, 30
            self.n = 0

        def read(self):
            self.n += 1
            f = np.zeros((self.h, self.w, 3), np.uint8)
            f[:, : self.w // 2] = (self.n % 255, 0, 0)
            return f

        def get_resolution(self):
            return (self.w, self.h)

        def set_resolution(self, w, h):
            self.w, self.h = int(w), int(h)
            return True

        def set_frame_rate(self, fps):
            self.fps = int(fps)
            return True

    def test_driver_object_end_to_end(self):
        import time
        cam = self.SynthCamera()
        cap = ss.utils.Capture(cam)
        # control before start: delegated to the driver
        assert cap.setResolution(32, 24) is True
        assert cap.setFrameRate(15) is True
        assert cap.getResolution() == (32, 24)
        cap.start()
        # reference semantics: no control while the grab thread runs
        assert cap.setResolution(64, 48) is False
        assert cap.setFrameRate(60) is False
        for _ in range(100):
            f = cap.get()
            if f is not None:
                break
            time.sleep(0.01)
        cap.stop()
        assert f is not None and f.shape == (24, 32, 3)

    def test_flipY(self):
        frame = np.zeros((4, 6, 3), np.uint8)
        frame[:, 0] = 255
        import time
        cap = ss.utils.Capture(lambda: frame, flipY=True)
        with cap:
            for _ in range(100):
                f = cap.get()
                if f is not None:
                    break
                time.sleep(0.01)
        assert f is not None
        assert (f[:, -1] == 255).all() and (f[:, 0] == 0).all()

    def test_file_sources_refuse_control(self, tmp_path, rng):
        from simplestereo_jax.imgio import imwrite
        p = tmp_path / "0.png"
        imwrite(str(p), rng.integers(0, 255, (8, 10, 3), np.uint8))
        cap = ss.utils.Capture([str(p)])
        assert cap.isFile
        assert cap.setResolution(640, 480) is False
        assert cap.setFrameRate(30) is False

    def test_single_file_path(self, tmp_path, rng):
        from simplestereo_jax.imgio import imwrite
        import time
        p = tmp_path / "f.png"
        imwrite(str(p), rng.integers(0, 255, (8, 10, 3), np.uint8))
        with ss.utils.Capture(str(p)) as cap:
            for _ in range(100):
                f = cap.get()
                if f is not None:
                    break
                time.sleep(0.01)
        assert f is not None and f.shape == (8, 10, 3)

    def test_missing_camera_raises(self):
        import pytest
        with pytest.raises(ValueError, match="Cannot open device"):
            ss.utils.Capture(87)  # no /dev/video87 in this environment

    def test_url_without_driver_raises(self):
        import pytest
        with pytest.raises(ValueError, match="Cannot open device"):
            ss.utils.Capture("rtsp://example/stream")

    def test_yuyv_to_bgr_roundtrip(self):
        from simplestereo_jax.v4l2 import yuyv_to_bgr
        # gray ramp: Y = value, U = V = 128 -> B = G = R = Y
        h, w = 4, 8
        y = np.tile(np.arange(0, 255, 32, np.uint8), (h, 1))
        buf = np.empty((h, w, 2), np.uint8)
        buf[..., 0] = y
        buf[..., 1] = 128
        out = yuyv_to_bgr(buf.tobytes(), w, h)
        assert out.shape == (h, w, 3)
        np.testing.assert_array_equal(out[..., 0], y)
        np.testing.assert_array_equal(out[..., 1], y)
        np.testing.assert_array_equal(out[..., 2], y)
        # pure chroma: V drives red up at mid luma
        buf[..., 0] = 128
        buf[:, 1::2, 1] = 255  # V
        buf[:, 0::2, 1] = 128  # U
        out = yuyv_to_bgr(buf.tobytes(), w, h)
        assert (out[..., 2] > out[..., 0]).all()  # R > B everywhere

    def test_example_002_flow(self, tmp_path, rng, monkeypatch):
        """Example 002 end-to-end against synthetic directory cameras."""
        import runpy
        import sys
        from simplestereo_jax.imgio import imwrite
        for cam in ("camL", "camR"):
            d = tmp_path / cam
            d.mkdir()
            for i in range(3):
                imwrite(str(d / f"{i}.png"),
                        rng.integers(0, 255, (8, 10, 3), np.uint8))
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(sys, "argv", [
            "002", str(tmp_path / "camL"), str(tmp_path / "camR")])
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        runpy.run_path(
            os.path.join(repo, "examples", "002_capture_image_pairs.py"),
            run_name="__main__")
        saved = list(tmp_path.glob("*_L.png"))
        assert len(saved) >= 1
