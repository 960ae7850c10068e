"""Geometry core: rotations, distortion, projection (JAX vs numpy mirrors)."""

import numpy as np
import pytest

import jax.numpy as jnp

from simplestereo_jax import geometry
from simplestereo_jax.geometry import npgeom

DIST5 = np.array([-0.25, 0.08, 1e-3, -5e-4, 0.012])
DIST8 = np.array([-0.25, 0.08, 1e-3, -5e-4, 0.012, -0.2, 0.05, 0.008])
DIST14 = np.concatenate([DIST8, [1e-4, -2e-4, 5e-5, 1e-4, 1e-3, -2e-3]])


class TestRotations:
    def test_roundtrip_random(self, rng):
        for _ in range(20):
            rvec = rng.normal(size=3)
            R = np.asarray(geometry.rodrigues_to_matrix(jnp.asarray(rvec, jnp.float64)))
            assert np.allclose(R @ R.T, np.eye(3), atol=1e-6)
            back = np.asarray(geometry.matrix_to_rodrigues(R))
            assert np.allclose(back, rvec, atol=1e-5)

    def test_identity(self):
        R = np.asarray(geometry.rodrigues_to_matrix(jnp.zeros(3)))
        assert np.allclose(R, np.eye(3), atol=1e-7)

    def test_small_angle(self):
        rvec = np.array([1e-8, -2e-8, 1e-8])
        R = np.asarray(geometry.rodrigues_to_matrix(jnp.asarray(rvec)))
        assert np.allclose(R, np.eye(3), atol=1e-6)

    def test_near_pi(self):
        axis = np.array([1.0, 2.0, -0.5])
        axis /= np.linalg.norm(axis)
        rvec = axis * (np.pi - 1e-7)
        R = npgeom.rodrigues_to_matrix(rvec)
        back = npgeom.matrix_to_rodrigues(R)
        assert np.allclose(np.abs(back), np.abs(rvec), atol=1e-4)

    def test_np_jax_agree(self, rng):
        rvec = rng.normal(size=3)
        Rj = np.asarray(geometry.rodrigues_to_matrix(jnp.asarray(rvec, jnp.float64)))
        Rn = npgeom.rodrigues_to_matrix(rvec)
        assert np.allclose(Rj, Rn, atol=1e-10)


class TestDistortion:
    @pytest.mark.parametrize("dist", [None, DIST5, DIST8, DIST14])
    def test_roundtrip(self, dist, rng):
        pts = rng.uniform(-0.4, 0.4, size=(50, 2))
        d = np.asarray(geometry.distort_normalized(jnp.asarray(pts), dist))
        u = np.asarray(geometry.undistort_normalized(jnp.asarray(d), dist, iterations=20))
        assert np.allclose(u, pts, atol=1e-5)

    @pytest.mark.parametrize("dist", [None, DIST5, DIST8, DIST14])
    def test_np_jax_agree(self, dist, rng):
        pts = rng.uniform(-0.4, 0.4, size=(30, 2))
        dj = np.asarray(geometry.distort_normalized(jnp.asarray(pts, jnp.float64), dist))
        dn = npgeom.distort_normalized(pts, dist)
        assert np.allclose(dj, dn, atol=1e-9)

    def test_undistort_points_pixel_domain(self, rng):
        K = np.array([[800.0, 0, 320], [0, 790.0, 240], [0, 0, 1]])
        pts = rng.uniform([0, 0], [640, 480], size=(40, 2))
        # distort -> undistort with P=K must return to original pixels
        norm = npgeom.undistort_points(pts, K, None)  # normalize only
        dpx = npgeom.distort_points(pts, K, DIST5)
        back = npgeom.undistort_points(dpx, K, DIST5, P=K, iterations=20)
        assert np.allclose(back, pts, atol=1e-3)
        assert np.allclose(
            norm, (pts - [320, 240]) / [800, 790], atol=1e-9
        )

    def test_R_and_P_composition(self, rng):
        K = np.array([[800.0, 0, 320], [0, 790.0, 240], [0, 0, 1]])
        H = np.array([[1.0, 0.02, -3], [0.01, 0.98, 2], [1e-5, -2e-5, 1]])
        pts = rng.uniform([100, 100], [500, 380], size=(10, 2))
        out = npgeom.undistort_points(pts, K, None, R=H @ K)
        # zero distortion: equivalent to applying H @ K to normalized coords
        norm = (pts - [320, 240]) / [800, 790]
        h = np.concatenate([norm, np.ones((10, 1))], axis=1) @ (H @ K).T
        expected = h[:, :2] / h[:, 2:3]
        assert np.allclose(out, expected, atol=1e-8)


class TestProjection:
    def test_project_pinhole(self):
        K = np.array([[500.0, 0, 100], [0, 500.0, 80], [0, 0, 1]])
        pts = np.array([[0.0, 0, 5], [1, -1, 10]])
        px = np.asarray(
            geometry.project_points(jnp.asarray(pts), jnp.zeros(3), jnp.zeros(3), K)
        )
        assert np.allclose(px[0], [100, 80], atol=1e-4)
        assert np.allclose(px[1], [150, 30], atol=1e-3)

    def test_project_np_jax_agree(self, rng):
        K = np.array([[600.0, 0, 300], [0, 610.0, 200], [0, 0, 1]])
        rvec = rng.normal(size=3) * 0.2
        tvec = np.array([0.1, -0.05, 4.0])
        pts = rng.uniform(-1, 1, size=(25, 3)) + [0, 0, 5]
        pj = np.asarray(
            geometry.project_points(
                jnp.asarray(pts, jnp.float64), jnp.asarray(rvec, jnp.float64),
                jnp.asarray(tvec, jnp.float64), K, DIST5)
        )
        pn = npgeom.project_points(pts, rvec, tvec, K, DIST5)
        assert np.allclose(pj, pn, atol=1e-8)

    def test_perspective_transform(self, rng):
        H = np.array([[1.1, 0.1, 5], [0.05, 0.9, -2], [1e-4, 2e-4, 1]])
        pts = rng.uniform(0, 100, size=(7, 2))
        out = np.asarray(geometry.perspective_transform(jnp.asarray(pts), H))
        h = np.concatenate([pts, np.ones((7, 1))], axis=1) @ H.T
        assert np.allclose(out, h[:, :2] / h[:, 2:3], atol=1e-5)

    def test_cross_product_matrix(self, rng):
        v = rng.normal(size=3)
        w = rng.normal(size=3)
        M = np.asarray(geometry.cross_product_matrix(jnp.asarray(v)))
        assert np.allclose(M @ w, np.cross(v, w), atol=1e-6)
