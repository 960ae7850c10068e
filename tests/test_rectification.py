"""Rectification suite: golden-file parity and epipolar alignment properties."""

import json

import numpy as np
import pytest

import simplestereo_jax as ss
from simplestereo_jax.geometry import npgeom


def _epipolar_alignment_error(rigRect, rng, n=200):
    """Max |y1 - y2| of rectified projections of random world points.

    The defining property of rectification: corresponding points land on
    the same row. Points are projected with the *distorted* camera models,
    then pushed through the full undistort+rectify pixel chain (H applied in
    normalized space, exactly like the rectification maps do).
    """
    P1, P2 = rigRect.getProjectionMatrices()
    X = rng.uniform(-1, 1, size=(n, 3)) * [300, 300, 200] + [0, 0, 1500]

    x1 = npgeom.project_points(X, np.eye(3), np.zeros(3),
                               rigRect.intrinsic1, rigRect.distCoeffs1)
    x2 = npgeom.project_points(X, rigRect.R, rigRect.T,
                               rigRect.intrinsic2, rigRect.distCoeffs2)

    # Same composition used by the map builder: K_new = Fit H K Rcommon^T
    # applied via object-space rotation; equivalently undistort with
    # R = H @ K in the normalized frame then the fitting affine — here we
    # use the stored K1/K2 and Rcommon directly.
    r1 = npgeom.undistort_points(
        x1, rigRect.intrinsic1, rigRect.distCoeffs1,
        R=rigRect.K1 @ rigRect.Rcommon)
    r2 = npgeom.undistort_points(
        x2, rigRect.intrinsic2, rigRect.distCoeffs2,
        R=rigRect.K2 @ rigRect.Rcommon @ rigRect.R.T)
    return np.abs(r1[:, 1] - r2[:, 1]).max()


class TestDirectRectify:
    def test_golden_homographies(self, rig2, ref_res):
        """Bit-level style parity with the committed rigRect.json."""
        gold = json.load(open(ref_res / "2" / "rigRect.json"))
        rigRect = ss.rectification.directRectify(rig2)
        for mine, ref in [
            (rigRect.rectHomography1, np.array(gold["rectHomography1"])),
            (rigRect.rectHomography2, np.array(gold["rectHomography2"])),
        ]:
            a = mine / np.linalg.norm(mine)
            b = ref / np.linalg.norm(ref)
            assert np.abs(a - b).max() < 1e-8
        # The golden Rcommon differs from the current reference algorithm by
        # a small rotation about the baseline (the x rows agree exactly);
        # assert the shared x-axis and a loose bound on the rest.
        assert np.abs(rigRect.Rcommon[0] - np.array(gold["Rcommon"])[0]).max() < 1e-9
        assert np.abs(rigRect.Rcommon - np.array(gold["Rcommon"])).max() < 0.02

    def test_epipolar_alignment(self, rig2, rng):
        rigRect = ss.rectification.directRectify(rig2)
        assert _epipolar_alignment_error(rigRect, rng) < 0.05


def _random_rig(rng):
    """A plausible random stereo rig: modest relative rotation, mostly-x
    baseline, distinct intrinsics and small distortion on both cameras."""
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix
    f1 = rng.uniform(700, 1500)
    f2 = f1 * rng.uniform(0.9, 1.1)
    K1 = np.array([[f1, 0, rng.uniform(600, 680)],
                   [0, f1 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    K2 = np.array([[f2, 0, rng.uniform(600, 680)],
                   [0, f2 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    R = rodrigues_to_matrix(rng.normal(0, 0.06, 3))
    T = np.array([[-rng.uniform(60, 220)],
                  [rng.normal(0, 5)], [rng.normal(0, 8)]])
    d1 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    d2 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    return ss.StereoRig((1280, 720), (1280, 720), K1, K2, d1, d2, R, T)


@pytest.mark.parametrize("algo", ["directRectify", "fusielloRectify",
                                  "loopRectify"])
def test_epipolar_alignment_random_rigs(algo, rng):
    """Property fuzz: every algorithm must rectify randomly generated
    plausible rigs, not just the committed golden one (directRectify's
    quartic-root numerics and loopRectify's quadric optimization are the
    fragile spots, SURVEY hard-parts 7)."""
    for _ in range(6):
        rig = _random_rig(rng)
        rigRect = getattr(ss.rectification, algo)(rig)
        assert _epipolar_alignment_error(rigRect, rng) < 0.05


class TestOtherAlgorithms:
    @pytest.mark.parametrize("algo", ["fusielloRectify", "loopRectify",
                                      "stereoRectify"])
    def test_epipolar_alignment(self, algo, rig2, rng):
        rigRect = getattr(ss.rectification, algo)(rig2)
        assert _epipolar_alignment_error(rigRect, rng) < 0.05

    def test_low_level_rectify(self, rig2, rng):
        """_lowLevelRectify aligns rows in the intrinsic-free frame."""
        R1, R2, R = ss.rectification._lowLevelRectify(rig2)
        X = rng.uniform(-1, 1, size=(50, 3)) * [200, 200, 100] + [0, 0, 1200]
        x1 = npgeom.project_points(X, np.eye(3), np.zeros(3), rig2.intrinsic1, None)
        x2 = npgeom.project_points(X, rig2.R, rig2.T, rig2.intrinsic2, None)
        r1 = npgeom.perspective_transform(x1, R1)
        r2 = npgeom.perspective_transform(x2, R2)
        assert np.abs(r1[:, 1] - r2[:, 1]).max() < 1e-6
        # x-axis of the common frame is the baseline
        _, C2 = rig2.getCenters()
        assert np.allclose(R[0], C2 / np.linalg.norm(C2), atol=1e-12)


class TestFittingMatrix:
    def test_corners_fit_in_dest(self, rig2):
        """With alpha=1 every rectified corner lies inside destDims."""
        rigRect = ss.rectification.directRectify(rig2)
        from simplestereo_jax.rectification import _getCorners, getFittingMatrix
        dest = (1280, 720)
        Fit = getFittingMatrix(
            rig2.intrinsic1, rig2.intrinsic2,
            rigRect.rectHomography1, rigRect.rectHomography2,
            rig2.res1, rig2.res2, rig2.distCoeffs1, rig2.distCoeffs2,
            dest, alpha=1)
        for H, K, dims, D in [
            (Fit @ rigRect.rectHomography1, rig2.intrinsic1, rig2.res1, rig2.distCoeffs1),
            (Fit @ rigRect.rectHomography2, rig2.intrinsic2, rig2.res2, rig2.distCoeffs2),
        ]:
            corners = np.array(_getCorners(H, K, dims, D))
            assert corners[:, 0].min() > -1.0
            assert corners[:, 0].max() < dest[0] + 1.0
            assert corners[:, 1].min() > -1.0
            assert corners[:, 1].max() < dest[1] + 1.0

    def test_shear_preserves_rows(self, rig2):
        """X-shear must not change the y coordinate of any point."""
        from simplestereo_jax.rectification import getBestXShearingTransformation
        rigRect = ss.rectification.directRectify(rig2)
        S = getBestXShearingTransformation(rigRect.rectHomography1, rig2.res1)
        assert S[1, 0] == 0 and S[1, 1] == 1 and S[1, 2] == 0
        assert S[2, 0] == 0 and S[2, 1] == 0 and S[2, 2] == 1
