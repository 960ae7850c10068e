"""
projection
==========

Camera projection and homography application as pure JAX functions.

Replaces ``cv2.projectPoints`` and ``cv2.perspectiveTransform``
(reference usage: /root/reference/simplestereo/active.py:478-481,
_rigs.py:674-698, calibration.py).
"""

import jax.numpy as jnp

from .rotations import rodrigues_to_matrix
from .distortion import _mm, distort_normalized


def to_homogeneous(points):
    """Append a 1 to the last axis: (..., n) -> (..., n+1)."""
    points = jnp.asarray(points)
    ones = jnp.ones(points.shape[:-1] + (1,), dtype=points.dtype)
    return jnp.concatenate([points, ones], axis=-1)


def from_homogeneous(points):
    """Divide by the last coordinate: (..., n+1) -> (..., n)."""
    points = jnp.asarray(points)
    return points[..., :-1] / points[..., -1:]


def cross_product_matrix(v):
    """3x3 antisymmetric matrix [v]_x such that [v]_x @ w == v x w.

    JAX twin of the reference helper
    (/root/reference/simplestereo/utils.py:213-232).
    """
    v = jnp.asarray(v).reshape(3)
    z = jnp.zeros((), dtype=v.dtype)
    return jnp.stack(
        [
            jnp.stack([z, -v[2], v[1]]),
            jnp.stack([v[2], z, -v[0]]),
            jnp.stack([-v[1], v[0], z]),
        ]
    )


def perspective_transform(points, M):
    """Apply a projective transform to 2D or 3D points.

    Drop-in for ``cv2.perspectiveTransform``: ``M`` is (n+1)x(n+1) for
    (..., n) points.

    Parameters
    ----------
    points : jnp.ndarray
        (..., 2) or (..., 3) coordinates.
    M : array
        Square homography of matching size + 1.

    Returns
    -------
    jnp.ndarray
        Transformed points, same shape as input.
    """
    points = jnp.asarray(points)
    n = points.shape[-1]
    M = jnp.asarray(M, dtype=points.dtype).reshape(n + 1, n + 1)
    h = _mm(to_homogeneous(points), M.T)
    return from_homogeneous(h)


def project_points(object_points, rvec, tvec, camera_matrix, dist_coeffs=None):
    """Project 3D world points to image pixels — drop-in for ``cv2.projectPoints``.

    Applies the rigid transform (Rodrigues ``rvec``, ``tvec``), pinhole
    division, lens distortion and the intrinsic matrix. Fully differentiable
    w.r.t. every argument: the calibration bundle adjustment takes
    ``jax.jacfwd`` of this instead of OpenCV's hand-derived Jacobians.

    Parameters
    ----------
    object_points : jnp.ndarray
        (..., 3) world coordinates.
    rvec : array
        (3,) Rodrigues rotation vector (or a 3x3 matrix).
    tvec : array
        (3,) translation.
    camera_matrix : array
        3x3 intrinsics.
    dist_coeffs : array or None
        Distortion coefficients (any accepted length).

    Returns
    -------
    jnp.ndarray
        (..., 2) pixel coordinates.
    """
    pts = jnp.asarray(object_points)
    rvec = jnp.asarray(rvec, dtype=pts.dtype)
    R = rvec if rvec.size == 9 else rodrigues_to_matrix(rvec)
    R = R.reshape(3, 3)
    t = jnp.asarray(tvec, dtype=pts.dtype).reshape(3)
    K = jnp.asarray(camera_matrix, dtype=pts.dtype).reshape(3, 3)

    cam = _mm(pts, R.T) + t
    norm = cam[..., :2] / cam[..., 2:3]
    dist = distort_normalized(norm, dist_coeffs)
    h = _mm(to_homogeneous(dist), K.T)
    return h[..., :2]
