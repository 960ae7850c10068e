"""
distortion
==========

Brown-Conrady lens distortion model (OpenCV-compatible rational model with
thin-prism and tilt terms), forward and inverse, as pure JAX functions.

Replaces ``cv2.undistortPoints`` / the distortion half of
``cv2.projectPoints`` / ``cv2.initUndistortRectifyMap``, which the reference
uses pervasively (/root/reference/simplestereo/rectification.py:154,
active.py:595,813, _rigs.py:685, calibration.py:399).

Coefficient order follows OpenCV:
``(k1, k2, p1, p2[, k3[, k4, k5, k6[, s1, s2, s3, s4[, taux, tauy]]]])``
with accepted lengths 0, 4, 5, 8, 12 and 14
(see /root/reference/simplestereo/calibration.py:1048-1094 for how the
reference maps coefficient counts to calibration flags).

All functions broadcast over leading dimensions and are jit/vmap/grad-safe.
"""

import functools

import jax
import jax.numpy as jnp

N_COEFFS = 14

# Full-f32 products: float32 matmuls may otherwise run in TF32 on a GPU,
# which costs whole pixels at image scale.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def pad_dist_coeffs(dist_coeffs, dtype=jnp.float32):
    """Normalize distortion coefficients to a length-14 vector.

    Accepts None (zero distortion) or any array of length 0/4/5/8/12/14.
    """
    if dist_coeffs is None:
        return jnp.zeros(N_COEFFS, dtype=dtype)
    d = jnp.asarray(dist_coeffs, dtype=dtype).reshape(-1)
    n = d.shape[0]
    if n > N_COEFFS:
        raise ValueError(f"Too many distortion coefficients: {n} > {N_COEFFS}")
    return jnp.concatenate([d, jnp.zeros(N_COEFFS - n, dtype=dtype)])


def _tilt_matrix(taux, tauy, dtype):
    """Projection matrix of the tilted-sensor model (OpenCV computeTiltProjectionMatrix).

    Rotates the image plane by tauy around y then taux around x, and
    re-projects onto z=1 keeping the principal ray fixed.
    """
    ctx, stx = jnp.cos(taux), jnp.sin(taux)
    cty, sty = jnp.cos(tauy), jnp.sin(tauy)
    # R = Rx(taux) @ Ry(tauy)  (OpenCV order)
    R = jnp.array(
        [
            [cty, 0.0, -sty],
            [stx * sty, ctx, stx * cty],
            [ctx * sty, -stx, ctx * cty],
        ],
        dtype=dtype,
    )
    # Projective normalization so that (0,0,1) maps to (0,0,1).
    P = jnp.array(
        [
            [R[2, 2], 0.0, -R[0, 2]],
            [0.0, R[2, 2], -R[1, 2]],
            [0.0, 0.0, 1.0],
        ],
        dtype=dtype,
    )
    return _mm(P, R)


def distort_normalized(points, dist_coeffs):
    """Apply lens distortion to normalized image coordinates.

    Parameters
    ----------
    points : jnp.ndarray
        (..., 2) undistorted normalized coordinates (x, y) on the z=1 plane.
    dist_coeffs : array or None
        Distortion coefficients, any accepted length.

    Returns
    -------
    jnp.ndarray
        (..., 2) distorted normalized coordinates.
    """
    points = jnp.asarray(points)
    d = pad_dist_coeffs(dist_coeffs, dtype=points.dtype)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy = [d[i] for i in range(N_COEFFS)]

    x = points[..., 0]
    y = points[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2

    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4

    # Tilted sensor model: T is exactly the identity when taux=tauy=0, so
    # applying it unconditionally keeps the trace static with no penalty.
    T = _tilt_matrix(taux, tauy, points.dtype)
    ones = jnp.ones_like(xd)
    h = _mm(jnp.stack([xd, yd, ones], axis=-1), T.T)
    return h[..., :2] / h[..., 2:3]


def undistort_normalized(points, dist_coeffs, iterations=10):
    """Invert lens distortion on normalized coordinates.

    Fixed-point compensation iteration, the same scheme as OpenCV's
    ``cvUndistortPointsInternal`` (which uses 5 iterations; we default to 10
    for tighter convergence — each iteration is a handful of FLOPs).

    Parameters
    ----------
    points : jnp.ndarray
        (..., 2) distorted normalized coordinates.
    dist_coeffs : array or None
    iterations : int
        Number of fixed-point iterations (static).

    Returns
    -------
    jnp.ndarray
        (..., 2) undistorted normalized coordinates.
    """
    points = jnp.asarray(points)
    d = pad_dist_coeffs(dist_coeffs, dtype=points.dtype)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy = [d[i] for i in range(N_COEFFS)]

    # Undo tilt first (inverse homography of the tilt projection).
    T = _tilt_matrix(taux, tauy, points.dtype)
    Tinv = jnp.linalg.inv(T)
    ones = jnp.ones_like(points[..., 0])
    h = _mm(jnp.stack([points[..., 0], points[..., 1], ones], axis=-1), Tinv.T)
    x0 = h[..., 0] / h[..., 2]
    y0 = h[..., 1] / h[..., 2]

    def body(_, xy):
        x, y = xy
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1.0 + k4 * r2 + k5 * r4 + k6 * r6) / (1.0 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4
        return ((x0 - dx) * icdist, (y0 - dy) * icdist)

    x, y = jax.lax.fori_loop(0, iterations, body, (x0, y0))
    return jnp.stack([x, y], axis=-1)


def undistort_points(points, camera_matrix, dist_coeffs, R=None, P=None, iterations=10):
    """Pixel-domain point undistortion — drop-in for ``cv2.undistortPoints``.

    Normalizes through ``camera_matrix``, inverts distortion, then applies
    the optional rectification transform ``R`` (a 3x3 homography/rotation in
    normalized space) and re-projects through ``P`` (3x3 or 3x4) if given.

    Matches the reference's usage patterns, e.g.
    ``cv2.undistortPoints(corners, K, D, R=H.dot(K))``
    (/root/reference/simplestereo/rectification.py:154) and
    ``cv2.undistortPoints(pp, K2, D2, P=K2)`` (_rigs.py:685).

    Parameters
    ----------
    points : jnp.ndarray
        (..., 2) pixel coordinates.
    camera_matrix : array
        3x3 intrinsic matrix.
    dist_coeffs : array or None
    R : array, optional
        3x3 transform applied after undistortion (in normalized space).
    P : array, optional
        3x3 or 3x4 new projection matrix applied last.

    Returns
    -------
    jnp.ndarray
        (..., 2) output coordinates: normalized if ``P`` is None, else pixels.
    """
    points = jnp.asarray(points)
    K = jnp.asarray(camera_matrix, dtype=points.dtype).reshape(3, 3)
    Kinv = jnp.linalg.inv(K)

    ones = jnp.ones_like(points[..., 0])
    h = _mm(jnp.stack([points[..., 0], points[..., 1], ones], axis=-1), Kinv.T)
    norm = h[..., :2] / h[..., 2:3]

    und = undistort_normalized(norm, dist_coeffs, iterations=iterations)

    M = jnp.eye(3, dtype=points.dtype)
    if R is not None:
        M = _mm(jnp.asarray(R, dtype=points.dtype).reshape(3, 3), M)
    if P is not None:
        Pm = jnp.asarray(P, dtype=points.dtype)
        Pm = Pm.reshape(3, -1)[:, :3]
        M = _mm(Pm, M)

    h = _mm(jnp.stack([und[..., 0], und[..., 1], jnp.ones_like(und[..., 0])], axis=-1), M.T)
    return h[..., :2] / h[..., 2:3]


def distort_points(points, camera_matrix, dist_coeffs, P=None):
    """Pixel-domain forward distortion (inverse of :func:`undistort_points`).

    Used for the projector "inverse pinhole" re-distortion trick
    (/root/reference/simplestereo/active.py:1239-1246, _rigs.py:685).

    Parameters
    ----------
    points : jnp.ndarray
        (..., 2) undistorted pixel coordinates (w.r.t. ``camera_matrix``).
    camera_matrix : array
        3x3 intrinsic matrix used to normalize.
    dist_coeffs : array or None
    P : array, optional
        3x3 matrix to re-apply after distortion; defaults to camera_matrix.

    Returns
    -------
    jnp.ndarray
        (..., 2) distorted pixel coordinates.
    """
    points = jnp.asarray(points)
    K = jnp.asarray(camera_matrix, dtype=points.dtype).reshape(3, 3)
    Kinv = jnp.linalg.inv(K)
    ones = jnp.ones_like(points[..., 0])
    h = _mm(jnp.stack([points[..., 0], points[..., 1], ones], axis=-1), Kinv.T)
    norm = h[..., :2] / h[..., 2:3]
    dist = distort_normalized(norm, dist_coeffs)
    Pm = K if P is None else jnp.asarray(P, dtype=points.dtype).reshape(3, 3)
    h = _mm(jnp.stack([dist[..., 0], dist[..., 1], jnp.ones_like(dist[..., 0])], axis=-1), Pm.T)
    return h[..., :2] / h[..., 2:3]
