"""
rectification
=============

Stereo rectification algorithms producing pixel-domain homographies.

Behavioral parity target: /root/reference/simplestereo/rectification.py.
All of this is small 3x3 control-plane algebra, so it runs host-side in
float64 numpy (see package docstring for the host/device split rationale);
the resulting homographies feed the device-side warping engine
(:mod:`simplestereo_jax.warp`).

Algorithms:

- :func:`stereoRectify` — half-rotation + baseline alignment (the classic
  scheme OpenCV implements; re-derived here, no cv2).
- :func:`fusielloRectify` — Fusiello, Trucco, Verri, "A compact algorithm
  for rectification of stereo pairs", MVA 2000.
- :func:`loopRectify` — Loop & Zhang, "Computing rectifying homographies
  for stereo vision", CVPR 1999 (quadric minimization).
- :func:`directRectify` — Lafiosca & Ceccaroni, "Rectifying homographies
  for stereo vision: analytical solution for minimal distortion", 2022
  (closed-form quartic; reference: rectification.py:539-731).
- :func:`getFittingMatrix` / :func:`getBestXShearingTransformation` —
  affine fitting into destination bounds (reference: rectification.py:17-156,
  490-535).
"""

import math
import warnings

import numpy as np
import scipy.optimize
from scipy.linalg import cholesky, null_space

from .geometry import npgeom
from .utils import getCrossProductMatrix


# --------------------------------------------------------------------------
# Fitting
# --------------------------------------------------------------------------

def _getCorners(H, intrinsicMatrix, dims, distCoeffs=None):
    """Image corners after undistortion + rectifying homography ``H``.

    Corners are pushed through ``undistort_points`` with the combined
    transform ``H @ K`` applied in normalized space — the same composition
    the reference builds with ``cv2.undistortPoints(..., R=H.dot(K))``
    (reference: rectification.py:125-156).

    Returns corners clockwise from top-left as (x, y) tuples.
    """
    w, h = dims
    corners = np.array(
        [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], dtype=np.float64
    )
    K = np.asarray(intrinsicMatrix, np.float64)
    R = np.asarray(H, np.float64) @ K
    out = npgeom.undistort_points(corners, K, distCoeffs, R=R)
    return [tuple(p) for p in out]


def getFittingMatrix(intrinsicMatrix1, intrinsicMatrix2, H1, H2, dims1, dims2,
                     distCoeffs1=None, distCoeffs2=None, destDims=None, alpha=1):
    """Common affine transform fitting both rectified images into ``destDims``.

    Scale/translate (and flip correction) shared by the pair; the y-scale is
    common to both images so rectification (equal row alignment) is not
    broken, the x-scale is chosen from the wider image. ``alpha`` blends
    between corner-preserving (1) and inner-valid-rectangle crop (0).

    Parity: reference rectification.py:17-122.

    Returns
    -------
    numpy.ndarray
        3x3 affine transform to pre-multiply both homographies.
    """
    if destDims is None:
        destDims = dims1

    c1 = _getCorners(H1, intrinsicMatrix1, dims1, distCoeffs1)
    c2 = _getCorners(H2, intrinsicMatrix2, dims2, distCoeffs2)
    tL1, tR1, bR1, bL1 = c1
    tL2, tR2, bR2, bL2 = c2

    xs1 = [p[0] for p in c1]
    xs2 = [p[0] for p in c2]
    ys = [p[1] for p in c1] + [p[1] for p in c2]

    minX1, maxX1 = min(xs1), max(xs1)
    minX2, maxX2 = min(xs2), max(xs2)
    minY, maxY = min(ys), max(ys)

    # Flip correction from the first image's corner ordering.
    flipX = -1 if tL1[0] > tR1[0] else 1
    flipY = -1 if tL1[1] > bL1[1] else 1

    # Common x-scale and y-scale (the y-scale *must* be shared to preserve
    # row alignment). NOTE (deviation from the reference,
    # rectification.py:74-93): the reference scales x by the larger of the
    # two per-image spans and anchors the translation at min(minX) — when
    # the two spans are offset, corners of one image spill outside the
    # destination. Scaling by the union extent guarantees the contract
    # ("fit the rectified images into desired dimensions") for both images,
    # and coincides with the reference when the spans coincide.
    minXall = min(minX1, minX2)
    maxXall = max(maxX1, maxX2)
    scaleX = flipX * destDims[0] / (maxXall - minXall)
    scaleY = flipY * destDims[1] / (maxY - minY)

    # Translation anchors the output at the left/top border.
    tX = -(minXall if flipX == 1 else maxXall) * scaleX
    tY = -(minY if flipY == 1 else maxY) * scaleY

    Fit = np.array([[scaleX, 0, tX], [0, scaleY, tY], [0, 0, 1]], np.float64)

    if alpha >= 1:
        return Fit
    alpha = max(alpha, 0)

    # Inner common rectangle after fitting; extra zoom as a linear function
    # of alpha between "fit corners" and "fill with valid pixels only".
    c1 = _getCorners(Fit @ np.asarray(H1, np.float64), intrinsicMatrix1, destDims, distCoeffs1)
    c2 = _getCorners(Fit @ np.asarray(H2, np.float64), intrinsicMatrix2, destDims, distCoeffs2)
    tL1, tR1, bR1, bL1 = c1
    tL2, tR2, bR2, bL2 = c2

    left = max(tL1[0], bL1[0], tL2[0], bL2[0])
    right = min(tR1[0], bR1[0], tR2[0], bR2[0])
    top = max(tL1[1], tR1[1], tL2[1], tR2[1])
    bottom = min(bL1[1], bR1[1], bL2[1], bR2[1])

    s = max(destDims[0] / (right - left), destDims[1] / (bottom - top))
    s = (s - 1) * (1 - alpha) + 1

    Z = np.array([[s, 0, -s * left], [0, s, -s * top], [0, 0, 1]], np.float64)
    return Z @ Fit


def getBestXShearingTransformation(rectHomography, dims):
    """Closed-form x-shear minimizing perspective distortion.

    Loop & Zhang 1999 §7: using the four mid-edge points of the image, the
    affine shear (a, b) preserving perpendicularity and aspect ratio of the
    warped axes is solved in closed form.
    Parity: reference rectification.py:490-535.
    """
    H = np.asarray(rectHomography, np.float64)
    w, h = dims

    def hmap(p):
        v = H @ np.array([p[0], p[1], 1.0])
        return v / v[2]

    a = hmap(((w - 1) / 2, 0))          # top mid
    b = hmap((w - 1, (h - 1) / 2))      # right mid
    c = hmap(((w - 1) / 2, h - 1))      # bottom mid
    d = hmap((0, (h - 1) / 2))          # left mid

    x = b - d
    y = c - a

    den = w * h * (x[1] * y[0] - x[0] * y[1])
    a_coeff = (h * h * x[1] * x[1] + w * w * y[1] * y[1]) / den
    b_coeff = (h * h * x[0] * x[1] + w * w * y[0] * y[1]) / (-den)

    return np.array([[a_coeff, b_coeff, 0], [0, 1, 0], [0, 0, 1]], np.float64)


def _getMinYCoord(H, dims):
    """Minimum y among the four transformed image corners."""
    H = np.asarray(H, np.float64)
    w, h = dims
    ys = []
    for p in [(0, 0), (0, h - 1), (w - 1, 0), (w - 1, h - 1)]:
        v = H @ np.array([p[0], p[1], 1.0])
        ys.append(v[1] / v[2])
    return min(ys)


# --------------------------------------------------------------------------
# Rectification algorithms
# --------------------------------------------------------------------------

def stereoRectify(rig):
    """Classic rectification: split the inter-camera rotation in half, then
    rotate the common frame so the baseline lies on the x-axis.

    This is the algorithm behind ``cv2.stereoRectify`` (the reference wraps
    cv2 at rectification.py:188-220); re-derived here without OpenCV.
    The common orientation averages the two camera orientations, so it does
    not minimize perspective distortion.

    Returns
    -------
    RectifiedStereoRig
    """
    from .rigs import RectifiedStereoRig

    R = np.asarray(rig.R, np.float64)
    T = np.asarray(rig.T, np.float64).reshape(3)

    # Half rotations: cam2 comes back by R^(-1/2), cam1 advances by R^(1/2).
    om = npgeom.matrix_to_rodrigues(R)
    r_half_inv = npgeom.rodrigues_to_matrix(-0.5 * om)  # R^(-1/2)

    # Baseline seen from the averaged frame.
    t = r_half_inv @ T

    # Rotate so the dominant baseline axis becomes exactly that axis.
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t[idx] > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    nt = np.linalg.norm(t)
    if nw > 1e-15:
        ww *= math.acos(min(abs(t[idx]) / nt, 1.0)) / nw
    wR = npgeom.rodrigues_to_matrix(ww)

    R1 = wR @ r_half_inv.T       # object-space rectifying rotation, cam1
    R2 = wR @ r_half_inv         # cam2;   R2 == R1 @ R.T

    # Convert object-space rotations to pixel homographies (H = R K^-1),
    # same conversion the reference applies (rectification.py:206-212).
    H1 = R1 @ np.linalg.inv(np.asarray(rig.intrinsic1, np.float64))
    H2 = R2 @ np.linalg.inv(np.asarray(rig.intrinsic2, np.float64))

    return RectifiedStereoRig(R1, H1, H2, rig)


def _baseline_frame(rig):
    """Common orientation whose x-axis is the baseline (Fusiello-style)."""
    _, B = rig.getCenters()
    v1 = np.asarray(B, np.float64).reshape(3)
    v2 = np.cross([0.0, 0.0, 1.0], v1)
    v3 = np.cross(v1, v2)
    v1 /= np.linalg.norm(v1)
    v2 /= np.linalg.norm(v2)
    v3 /= np.linalg.norm(v3)
    return np.array([v1, v2, v3])


def fusielloRectify(rig):
    """Fusiello et al. 2000 compact rectification.

    New common orientation: x along the baseline, y = z_old x x, z
    completing the frame. New shared intrinsics: the average of the two.
    Parity: reference rectification.py:224-267.

    Returns
    -------
    RectifiedStereoRig
    """
    from .rigs import RectifiedStereoRig

    Rot = _baseline_frame(rig)
    K1 = np.asarray(rig.intrinsic1, np.float64)
    K2 = np.asarray(rig.intrinsic2, np.float64)
    A = (K1 + K2) / 2

    H1 = A @ Rot @ np.linalg.inv(K1)
    H2 = A @ Rot @ np.linalg.inv(np.asarray(rig.R, np.float64)) @ np.linalg.inv(K2)

    return RectifiedStereoRig(Rot, H1, H2, rig)


def _lowLevelRectify(rig):
    """Minimal Fusiello-style rectifying transforms without new intrinsics.

    Used internally by every structured-light triangulation path
    (parity: reference rectification.py:271-302).

    Returns
    -------
    (R1, R2, R) : numpy.ndarray
        Transforms removing intrinsics and aligning both views to the
        baseline frame, and the common rotation itself.
    """
    R = _baseline_frame(rig)
    R1 = R @ np.linalg.inv(np.asarray(rig.intrinsic1, np.float64))
    R2 = (
        R
        @ np.linalg.inv(np.asarray(rig.R, np.float64))
        @ np.linalg.inv(np.asarray(rig.intrinsic2, np.float64))
    )
    return R1, R2, R


def _loop_zhang_quadrics(dims):
    """The P P^T and Pc Pc^T moment matrices of Loop-Zhang (lemma in §5)."""
    w, h = dims
    PPt = (w * h / 12.0) * np.array(
        [[w * w - 1.0, 0, 0], [0, h * h - 1.0, 0], [0, 0, 0]], np.float64
    )
    wc, hc = (w - 1) / 2.0, (h - 1) / 2.0
    PcPct = np.array(
        [[wc * wc, wc * hc, wc], [wc * hc, hc * hc, hc], [wc, hc, 1.0]], np.float64
    )
    return PPt, PcPct


def loopRectify(rig):
    """Loop & Zhang 1999 rectification via distortion-functional minimization.

    The projective component ``w`` is parameterized as ``z = [lambda, 1, 0]``
    and found by minimizing ``z'A1z/z'B1z + z'A2z/z'B2z`` (quadric Rayleigh
    quotients built from image moments), with the initial guess from the
    generalized eigen-problem after Cholesky whitening.
    Parity: reference rectification.py:305-486, including its documented
    sign flip on the second row of Hr1 ("Changed sign ... to make it work",
    rectification.py:436-444) and the z-axis construction for Rcommon.

    Returns
    -------
    RectifiedStereoRig
    """
    from .rigs import RectifiedStereoRig

    F = np.asarray(rig.getFundamentalMatrix(), np.float64)
    dims1, dims2 = rig.res1, rig.res2

    e1 = null_space(F)
    e1_cross = np.asarray(getCrossProductMatrix(np.squeeze(e1)), np.float64)

    PPt1, PcPct1 = _loop_zhang_quadrics(dims1)
    PPt2, PcPct2 = _loop_zhang_quadrics(dims2)

    A1 = e1_cross.T @ PPt1 @ e1_cross
    B1 = e1_cross.T @ PcPct1 @ e1_cross
    A2 = F.T @ PPt2 @ F
    B2 = F.T @ PcPct2 @ F

    def initial_guess(A1, B1, A2, B2):
        try:
            D1 = cholesky(A1, lower=True)
            D2 = cholesky(A2, lower=True)
        except Exception as err:
            # A1/A2 are PSD-*singular* by construction (A = M^T Q M with
            # M annihilating the epipole direction), so Cholesky fails
            # whenever rounding doesn't blur the zero eigenvalue. The
            # reference's fixed 1e-10 (rectification.py:340-345) is ~20
            # orders below these pixel-moment quadrics; scale the jitter
            # to the matrix magnitude instead (documented deviation —
            # it only seeds the optimizer).
            eps1 = max(1e-12 * float(np.trace(A1).real), 1e-10)
            eps2 = max(1e-12 * float(np.trace(A2).real), 1e-10)
            A1 = A1 + eps1 * np.eye(3)
            A2 = A2 + eps2 * np.eye(3)
            try:
                D1 = cholesky(A1, lower=True)
                D2 = cholesky(A2, lower=True)
                warnings.warn(
                    "Added scaled jitter to A1/A2 diagonals before "
                    "Cholesky.", RuntimeWarning)
            except np.linalg.LinAlgError:
                raise err

        zs = []
        for D, B in ((D1, B1), (D2, B2)):
            Dinv = np.linalg.inv(D)
            evals, evecs = np.linalg.eig(Dinv.T @ B @ Dinv)
            # NOTE: the reference takes the *row* of the eigenvector matrix
            # (rectification.py:353); we keep that behavior for parity since
            # this only seeds the optimizer.
            zmax = evecs[np.argmax(evals)]
            z = Dinv @ zmax
            zs.append(z / np.linalg.norm(z))
        return (zs[0] + zs[1]) / 2

    def distortion(z, A1, B1, A2, B2):
        z = np.array([z[0], 1.0, 0.0])
        return float(z @ A1 @ z / (z @ B1 @ z) + z @ A2 @ z / (z @ B2 @ z))

    z0 = np.real(initial_guess(A1, B1, A2, B2))
    result = scipy.optimize.minimize(distortion, z0, args=(A1, B1, A2, B2))
    if not result.success:
        # BFGS's "precision loss" status usually means it converged to
        # machine precision and merely couldn't improve further. The
        # reference raises on ANY failure (rectification.py:412-415);
        # deviation: accept the iterate when it's at least as good as
        # the seed, raise only on a genuine failure.
        if not (np.isfinite(result.fun)
                and result.fun <= distortion(z0, A1, B1, A2, B2) + 1e-12):
            raise ValueError(result.message)
    z = np.array([result.x[0], 1.0, 0.0])

    w1 = e1_cross @ z
    w2 = F @ z
    w1 = w1 / w1[2]
    w2 = w2 / w2[2]

    Rnew = _loop_rcommon(rig, e1[:, 0], z)
    H1, H2 = _loop_zhang_homographies(F, w1, w2, dims1, dims2)
    return RectifiedStereoRig(Rnew, H1, H2, rig)


def _loop_rcommon(rig, e1, z):
    """Common orientation consistent with the Loop-Zhang projective maps.

    NOTE (deviation from the reference, rectification.py:465-482): the
    reference normalizes ``zv = cross(e1, z)`` without orthogonalizing it
    against the baseline, producing a non-orthogonal "rotation". Since the
    map builder relies on ``Rcommon.T == Rcommon^-1`` to cancel (K1 is
    ``Fit H1 A1 Rcommon.T``), that defect leaks ~0.1 px of row misalignment
    into the rectified images. We project ``zv`` onto the plane orthogonal
    to the baseline first, which keeps the intended viewing direction and
    restores exact alignment.
    """
    C1, C2 = rig.getCenters()
    xv = np.asarray(C1, np.float64) - np.asarray(C2, np.float64)
    xv = xv / np.linalg.norm(xv)
    zv = np.cross(e1, z)
    zv = zv - (zv @ xv) * xv
    zv = zv / np.linalg.norm(zv)
    yv = np.cross(zv, xv)
    yv = yv / np.linalg.norm(yv)
    return np.array([xv, yv, zv])


def _loop_zhang_homographies(F, w1, w2, dims1, dims2):
    """Projective + similarity + shear pipeline shared by loop/direct rectify.

    Builds Hp (projective, rows [I; w]), Hr (similarity aligning epipolar
    lines horizontally, with the reference's sign convention on image 1),
    and the closed-form x-shear; returns the composed homographies.
    Parity: reference rectification.py:428-461 and :700-726.
    """
    Hp1 = np.array([[1, 0, 0], [0, 1, 0], w1], np.float64)
    Hp2 = np.array([[1, 0, 0], [0, 1, 0], w2], np.float64)

    vc2 = -min(_getMinYCoord(Hp1, dims1), _getMinYCoord(Hp2, dims2))

    Hr1 = np.array(
        [
            [F[2, 1] - w1[1] * F[2, 2], w1[0] * F[2, 2] - F[2, 0], 0],
            [w1[0] * F[2, 2] - F[2, 0], w1[1] * F[2, 2] - F[2, 1], -(F[2, 2] + vc2)],
            [0, 0, 1],
        ],
        np.float64,
    )
    Hr2 = np.array(
        [
            [F[1, 2] - w2[1] * F[2, 2], w2[0] * F[2, 2] - F[0, 2], 0],
            [F[0, 2] - w2[0] * F[2, 2], F[1, 2] - w2[1] * F[2, 2], vc2],
            [0, 0, 1],
        ],
        np.float64,
    )

    Hrp1 = Hr1 @ Hp1
    Hrp2 = Hr2 @ Hp2

    Hs1 = getBestXShearingTransformation(Hrp1, dims1)
    Hs2 = getBestXShearingTransformation(Hrp2, dims2)

    return Hs1 @ Hrp1, Hs2 @ Hrp2


def directRectify(rig):
    """Analytical minimal-distortion rectification (Lafiosca & Ceccaroni 2022).

    Solves for the scalar parameter (a point ordinate on image 1's y-axis)
    whose induced common orientation minimizes the Loop-Zhang distortion
    functional; the minimizing parameter is a root of a quartic, found in
    closed form. Falls back to the single-root case for equal orientations
    and to the identity case for already-rectified rigs.
    Parity: reference rectification.py:539-731.

    Returns
    -------
    RectifiedStereoRig
    """
    from .rigs import RectifiedStereoRig

    A1 = np.asarray(rig.intrinsic1, np.float64)
    A2 = np.asarray(rig.intrinsic2, np.float64)
    R = np.asarray(rig.R, np.float64)
    T = np.asarray(rig.T, np.float64).reshape(3)
    dims1, dims2 = rig.res1, rig.res2
    F = np.asarray(rig.getFundamentalMatrix(), np.float64)

    R1w = np.eye(3)          # world frame is camera 1
    R2w = R

    # Already-rectified special case: F proportional to the x-aligned form.
    with np.errstate(divide="ignore", invalid="ignore"):
        Fn = F / F[2, 1] if F[2, 1] != 0 else None
    if Fn is not None and np.allclose(Fn, [[0, 0, 0], [0, 0, -1], [0, 1, 0]]):
        w1 = w2 = np.array([0.0, 0.0, 1.0])
        Rnew = _baseline_frame(rig)
        H1, H2 = _loop_zhang_homographies(F, w1, w2, dims1, dims2)
        return RectifiedStereoRig(Rnew, H1, H2, rig)

    # Baseline vector (cam1 -> cam2) in world coordinates.
    bv = np.linalg.inv(R2w) @ T

    # L matrices: map the w-parameter space onto the Loop-Zhang quadrics.
    Bm = (bv @ bv * np.eye(3) - np.outer(bv, bv)) @ np.linalg.inv(A1 @ R1w)
    L1 = np.linalg.inv(A1 @ R1w).T @ Bm
    L2 = np.linalg.inv(A2 @ R2w).T @ Bm

    PPt1, PcPct1 = _loop_zhang_quadrics(dims1)
    PPt2, PcPct2 = _loop_zhang_quadrics(dims2)

    M1 = L1.T @ PPt1 @ L1
    C1 = L1.T @ PcPct1 @ L1
    M2 = L2.T @ PPt2 @ L2
    C2 = L2.T @ PcPct2 @ L2

    m1 = M1[1, 2] * C1[1, 2] - M1[2, 2] * C1[1, 1]
    m2 = M1[1, 1] * C1[1, 2] - M1[1, 2] * C1[1, 1]

    if (
        np.array_equal(R1w, R2w)
        and np.array_equal(A1, A2)
        and np.array_equal(PPt1, PPt2)
        and np.array_equal(PcPct1, PcPct2)
    ):
        # Equal orientation: the quartic degenerates to a single root.
        sols = [-m1 / m2]
    else:
        m3 = C2[1, 2] / C2[1, 1]
        m4 = C2[1, 1] / C1[1, 1]
        m5 = M2[1, 2] * C2[1, 2] - M2[2, 2] * C2[1, 1]
        m6 = M2[1, 1] * C2[1, 2] - M2[1, 2] * C2[1, 1]
        m7 = C1[1, 2] / C1[1, 1]
        m8 = 1.0 / m4

        a = m2 * m4 + m6 * m8
        b = m1 * m4 + 3 * m2 * m3 * m4 + m5 * m8 + 3 * m6 * m7 * m8
        c = 3 * (m1 * m3 * m4 + m2 * m3**2 * m4 + m5 * m7 * m8 + m6 * m7**2 * m8)
        d = 3 * m1 * m3**2 * m4 + m2 * m3**3 * m4 + 3 * m5 * m7**2 * m8 + m6 * m7**3 * m8
        e = m1 * m3**3 * m4 + m5 * m7**3 * m8

        # Ferrari resolvent, as in the paper (complex-safe intermediates).
        p = (8 * a * c - 3 * b * b) / (8 * a * a)
        q = 12 * a * e - 3 * b * d + c * c
        s = 27 * a * d * d - 72 * a * c * e + 27 * b * b * e - 9 * b * c * d + 2 * c**3
        disc = complex(s * s - 4 * q**3)
        D0 = complex(0.5 * (s + np.sqrt(disc))) ** (1.0 / 3.0)
        Qc = 0.5 * np.sqrt(-(2.0 / 3.0) * p + (D0 + q / D0) / (3 * a))
        Q = Qc.real if abs(Qc.imag) < 1e-9 * max(abs(Qc.real), 1.0) else None
        S = (8 * a * a * d - 4 * a * b * c + b**3) / (8 * a**3)

        sols = []
        if Q is not None and abs(Q) > 0:
            r1 = -4 * Q * Q - 2 * p + S / Q
            if r1 >= 0:
                sols.append(-b / (4 * a) - Q - 0.5 * math.sqrt(r1))
                sols.append(-b / (4 * a) - Q + 0.5 * math.sqrt(r1))
            r2 = -4 * Q * Q - 2 * p - S / Q
            if r2 >= 0:
                sols.append(-b / (4 * a) + Q - 0.5 * math.sqrt(r2))
                sols.append(-b / (4 * a) + Q + 0.5 * math.sqrt(r2))
        if not sols:
            raise ValueError("No analytic solution.")

    def solution_frame(yy):
        """Common orientation induced by the candidate parameter ``yy``."""
        # The candidate is the ordinate of a point on image 1's y-axis;
        # back-project it to a world direction defining the new z plane.
        p1w = np.linalg.inv(R1w) @ (np.linalg.inv(A1) @ np.array([0.0, yy, 1.0]))
        xv = bv / np.linalg.norm(bv)
        c2w = np.linalg.inv(R2w) @ T
        oop1w = (p1w + c2w) @ xv * xv - c2w
        zv = p1w - oop1w
        yv = np.cross(zv, bv)
        yv = yv / np.linalg.norm(yv)
        zv = zv / np.linalg.norm(zv)
        Rnew = np.array([xv, yv, zv])
        w1 = Rnew @ np.linalg.inv(A1 @ R1w)
        w2 = Rnew @ np.linalg.inv(A2 @ R2w)
        w1 = w1[2] / w1[2, 2]
        w2 = w2[2] / w2[2, 2]
        return w1, w2, Rnew

    def lz_distortion(yy):
        w1, w2, _ = solution_frame(yy)
        return float(
            w1 @ PPt1 @ w1 / (w1 @ PcPct1 @ w1) + w2 @ PPt2 @ w2 / (w2 @ PcPct2 @ w2)
        )

    best = min(sols, key=lz_distortion)
    w1, w2, Rnew = solution_frame(best)

    H1, H2 = _loop_zhang_homographies(F, w1, w2, dims1, dims2)
    return RectifiedStereoRig(Rnew, H1, H2, rig)
