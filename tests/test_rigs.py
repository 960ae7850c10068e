"""Rig data model: JSON schema parity, derived geometry, golden-file checks."""

import json

import numpy as np
import pytest

import simplestereo_jax as ss


class TestStereoRig:
    def test_fromfile_golden(self, rig2):
        assert rig2.res1 == (1280, 720)
        assert rig2.intrinsic1.shape == (3, 3)
        assert rig2.T.shape == (3, 1)

    def test_save_roundtrip(self, rig2, tmp_path):
        p = tmp_path / "rig.json"
        rig2.save(str(p))
        again = ss.StereoRig.fromFile(str(p))
        assert np.allclose(again.intrinsic1, rig2.intrinsic1)
        assert np.allclose(again.R, rig2.R)
        assert np.allclose(again.T, rig2.T)
        assert again.res1 == tuple(rig2.res1)
        # schema keys must match the reference exactly
        data = json.loads(p.read_text())
        assert set(data) >= {
            "res1", "res2", "intrinsic1", "intrinsic2", "R", "T",
            "distCoeffs1", "distCoeffs2",
        }

    def test_projection_matrices(self, rig2):
        P1, P2 = rig2.getProjectionMatrices()
        assert np.allclose(P1, np.hstack([rig2.intrinsic1, np.zeros((3, 1))]))
        assert np.allclose(P2, rig2.intrinsic2 @ np.hstack([rig2.R, rig2.T]))

    def test_baseline_matches_T(self, rig2):
        # C2 = -R^-1 T, so baseline == |T|
        assert np.isclose(rig2.getBaseline(), np.linalg.norm(rig2.T))

    def test_fundamental_epipolar_constraint(self, rig2, rng):
        """x2' F x1 = 0 for projections of random world points (no distortion)."""
        F = rig2.getFundamentalMatrix()
        P1, P2 = rig2.getProjectionMatrices()
        X = rng.uniform(-1, 1, size=(50, 3)) * [200, 200, 100] + [0, 0, 800]
        Xh = np.concatenate([X, np.ones((50, 1))], axis=1)
        x1 = Xh @ P1.T
        x2 = Xh @ P2.T
        x1 /= x1[:, 2:3]
        x2 /= x2[:, 2:3]
        resid = np.einsum("ni,ij,nj->n", x2, F, x1)
        scale = np.abs(F).max()
        assert np.abs(resid).max() / scale < 1e-3

    def test_essential_from_F(self, rig2):
        E = rig2.getEssentialMatrix()
        # E must have two equal singular values and one zero
        s = np.linalg.svd(E, compute_uv=False)
        assert s[2] / s[0] < 1e-6
        assert abs(s[0] - s[1]) / s[0] < 1e-6

    def test_default_dist_coeffs(self):
        rig = ss.StereoRig((10, 10), (10, 10), np.eye(3), np.eye(3), None,
                           None, np.eye(3), [1, 0, 0])
        assert rig.distCoeffs1.shape == (5,)
        assert np.all(rig.distCoeffs1 == 0)

    def test_undistort_images_arity(self, rng):
        """changeCameras toggles the 2-/4-tuple return (reference
        _rigs.py:285-338 quirk)."""
        K = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]])
        dist = np.array([0.05, 0, 0, 0, 0])
        rig = ss.StereoRig((64, 48), (64, 48), K, K, dist, dist,
                           np.eye(3), [1, 0, 0])
        img = rng.integers(0, 256, (48, 64, 3), np.uint8)
        out = rig.undistortImages(img, img)
        assert len(out) == 2 and out[0].shape == img.shape
        out4 = rig.undistortImages(img, img, changeCameras=True, alpha=1)
        assert len(out4) == 4
        u1, u2, K1new, K2new = out4
        assert u1.shape == img.shape
        assert K1new.shape == (3, 3) and np.isfinite(K1new).all()
        assert K1new[2, 2] == 1 and K1new[0, 1] == 0


class TestRectifiedStereoRig:
    def test_fromfile_golden_roundtrip(self, ref_res, tmp_path):
        path = str(ref_res / "2" / "rigRect.json")
        rig = ss.RectifiedStereoRig.fromFile(path)
        gold = json.load(open(path))
        assert np.allclose(rig.rectHomography1, gold["rectHomography1"])
        p = tmp_path / "rigRect.json"
        rig.save(str(p))
        data = json.loads(p.read_text())
        assert np.allclose(data["Rcommon"], gold["Rcommon"])
        assert np.allclose(data["rectHomography2"], gold["rectHomography2"])

    def test_K_bookkeeping(self, ref_res):
        rig = ss.RectifiedStereoRig.fromFile(str(ref_res / "2" / "rigRect.json"))
        # K1 = Fit H1 A1 Rcommon^T must be (close to) upper triangular
        assert rig.K1 is not None
        assert abs(rig.K1[1, 0]) < 1e-6 * abs(rig.K1[1, 1])
        assert abs(rig.K1[2, 0]) < 1e-6
        # after rectification both cameras share fy and cy
        assert np.isclose(rig.K1[1, 1], rig.K2[1, 1], rtol=1e-6)
        assert np.isclose(rig.K1[1, 2], rig.K2[1, 2], rtol=1e-5)

    def test_q_matrix_reprojection(self, ref_res):
        rig = ss.RectifiedStereoRig.fromFile(str(ref_res / "2" / "rigRect.json"))
        disp = np.full((72, 128), 50.0, np.float32)
        pts = rig.get3DPoints(disp)
        assert pts.shape == (72, 128, 3)
        # constant disparity plane: depth ~ fx*b/disp, same sign everywhere
        z = pts[..., 2]
        assert np.isfinite(z).all()
        assert (np.sign(z) == np.sign(z[0, 0])).all()


class TestStructuredLightRig:
    def test_triangulate_synthetic(self):
        """Exact triangulation of synthetic cam/projector correspondences."""
        K1 = np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
        K2 = np.array([[900.0, 0, 512], [0, 900.0, 384], [0, 0, 1]])
        R = np.eye(3)
        T = np.array([[-120.0], [0], [0]])  # projector to the right... (cam frame)
        rig = ss.StereoRig((640, 480), (1024, 768), K1, K2, None, None, R, T)
        sl = ss.StructuredLightRig(rig)

        rng = np.random.default_rng(0)
        X = rng.uniform(-1, 1, size=(100, 3)) * [100, 100, 50] + [0, 0, 600]
        # project to camera (identity extrinsics) and projector (R, T)
        x1 = (X @ K1.T)
        x1 = x1[:, :2] / x1[:, 2:3]
        Xp = X @ R.T + T.ravel()
        x2 = Xp @ K2.T
        x2 = x2[:, :2] / x2[:, 2:3]

        P = sl.triangulate(x1, x2).reshape(-1, 3)
        assert np.allclose(P, X, atol=1e-5)
