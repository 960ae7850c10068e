"""Point cloud I/O: native C++ serializer vs Python fallback parity."""

import os

import numpy as np
import pytest

from simplestereo_jax import points
import simplestereo_jax.native as native


@pytest.mark.parametrize("mode", ["plain", "bgr", "gray_int", "gray_float"])
def test_ply_native_matches_python(tmp_path, rng, mode):
    pts = rng.normal(size=(12, 9, 3))
    kw = {}
    ncols = 3
    if mode == "bgr":
        kw["referenceImage"] = rng.integers(
            0, 256, (12, 9, 3), np.uint8)
        ncols = 6
    elif mode == "gray_int":
        kw["referenceImage"] = rng.integers(0, 256, (12, 9), np.uint8)
        ncols = 4
    elif mode == "gray_float":
        kw["referenceImage"] = rng.random((12, 9)).astype(np.float32)
        ncols = 4

    p_native = str(tmp_path / "n.ply")
    p_python = str(tmp_path / "p.ply")
    assert native.get_ply() is not None, "native _ply failed to build"
    points.exportPLY(pts, p_native, **kw)
    real = native.get_ply
    native.get_ply = lambda: None
    try:
        points.exportPLY(pts, p_python, **kw)
        back_py = points.importPLY(p_python, *range(ncols))
    finally:
        native.get_ply = real
    back_nat = points.importPLY(p_native, *range(ncols))
    np.testing.assert_allclose(back_nat, back_py, atol=1e-12)
    np.testing.assert_allclose(back_nat[:, :3], pts.reshape(-1, 3),
                               atol=1e-5)


def test_ply_shape_comment_and_precision(tmp_path, rng):
    pts = rng.normal(size=(4, 5, 3))
    p = str(tmp_path / "a.ply")
    points.exportPLY(pts, p, precision=3)
    txt = open(p).read()
    assert "Original array shape 4x5x3" in txt
    back = points.importPLY(p)
    np.testing.assert_allclose(back.reshape(4, 5, 3), pts, atol=5e-3)


def test_import_ply_custom_columns(tmp_path, rng):
    pts = rng.normal(size=(3, 3, 3))
    ref = rng.integers(0, 256, (3, 3, 3), np.uint8)
    p = str(tmp_path / "c.ply")
    points.exportPLY(pts, p, referenceImage=ref)
    cols = points.importPLY(p, 3, 4, 5)  # the BGR color columns
    assert cols.shape == (9, 3)
    assert cols.min() >= 0 and cols.max() <= 255


def test_reproject_q_matches_manual(rng):
    from simplestereo_jax.points import reprojectImageTo3D

    disp = rng.uniform(1, 20, (6, 7)).astype(np.float32)
    Q = np.array([[1, 0, 0, -3.0],
                  [0, 1, 0, -2.0],
                  [0, 0, 0, 80.0],
                  [0, 0, 0.25, 0.0]])
    out = reprojectImageTo3D(disp, Q)
    xs, ys = np.meshgrid(np.arange(7), np.arange(6))
    hom = np.stack([xs, ys, disp, np.ones_like(disp)], -1) @ Q.T
    ref = hom[..., :3] / hom[..., 3:]
    np.testing.assert_allclose(out, ref, rtol=2e-5)


def test_adimensional_points_geometry(rng):
    disp = np.full((10, 16), 4.0, np.float32)
    cloud = points.getAdimensional3DPoints(disp)
    assert cloud.shape == (10, 16, 3)
    # constant disparity -> constant depth plane; the reference's
    # synthetic Q has Q[2,3] = -fx, so z = -fx*b/d = -width/4
    z = cloud[..., 2]
    np.testing.assert_allclose(z, -16.0 / 4.0, rtol=1e-5)


def test_distort_points_inverts_undistort(rng):
    import jax.numpy as jnp
    from simplestereo_jax.geometry import distortion

    dist = np.array([0.1, -0.05, 0.001, 0.002, 0.02])
    norm = rng.uniform(-0.4, 0.4, (50, 2))
    d = points.distortPoints(norm, dist).reshape(-1, 2)
    back = np.asarray(distortion.undistort_normalized(
        jnp.asarray(d, jnp.float64), jnp.asarray(dist), iterations=30))
    np.testing.assert_allclose(back, norm, atol=1e-6)
