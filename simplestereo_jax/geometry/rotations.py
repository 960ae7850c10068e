"""
rotations
=========

Rodrigues axis-angle <-> rotation-matrix conversions as pure JAX functions.

Replaces ``cv2.Rodrigues`` (used implicitly inside the reference's
``cv2.projectPoints`` / ``cv2.calibrateCamera`` calls, e.g.
/root/reference/simplestereo/active.py:478-481, calibration.py:87).

Both directions are differentiable and vmappable, which is what the
bundle-adjustment module relies on (jax.grad through the full reprojection
residual instead of OpenCV's hand-written LM Jacobians).
"""

import jax
import jax.numpy as jnp


def rodrigues_to_matrix(rvec):
    """Convert a Rodrigues rotation vector to a 3x3 rotation matrix.

    Uses the standard axis-angle exponential map with a Taylor-safe
    small-angle branch (needed so gradients are finite at theta=0).

    Parameters
    ----------
    rvec : jnp.ndarray
        Shape (3,) rotation vector; direction is the axis, norm the angle.

    Returns
    -------
    jnp.ndarray
        Shape (3, 3) rotation matrix.
    """
    rvec = jnp.asarray(rvec).reshape(3)
    theta2 = jnp.sum(rvec * rvec)
    theta = jnp.sqrt(theta2 + 1e-32)

    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks near zero.
    small = theta2 < 1e-12
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    cosc = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)

    K = jnp.array(
        [
            [0.0, -rvec[2], rvec[1]],
            [rvec[2], 0.0, -rvec[0]],
            [-rvec[1], rvec[0], 0.0],
        ],
        dtype=rvec.dtype,
    )
    eye = jnp.eye(3, dtype=rvec.dtype)
    return eye + sinc * K + cosc * jnp.matmul(
        K, K, precision=jax.lax.Precision.HIGHEST)


def matrix_to_rodrigues(R):
    """Convert a 3x3 rotation matrix to a Rodrigues vector.

    Inverse of :func:`rodrigues_to_matrix`. Stable for angles near 0 and
    near pi (uses the diagonal-based axis extraction in the pi branch).

    Parameters
    ----------
    R : jnp.ndarray
        Shape (3, 3) rotation matrix.

    Returns
    -------
    jnp.ndarray
        Shape (3,) rotation vector.
    """
    R = jnp.asarray(R).reshape(3, 3)
    trace = jnp.trace(R)
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)

    # Antisymmetric part gives axis*sin(theta).
    v = jnp.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
        dtype=R.dtype,
    )
    sin_theta = jnp.sqrt(jnp.maximum(jnp.sum(v * v), 1e-32)) * 0.5

    # Generic branch: axis = v / (2 sin t), rvec = axis * t.
    generic = v * (theta / jnp.maximum(2.0 * sin_theta, 1e-12))
    # Small-angle branch: rvec ~ v/2 (first order).
    small = v * 0.5

    # Near pi: axis from diagonal of (R + I)/2 = a a^T style extraction.
    A = (R + jnp.eye(3, dtype=R.dtype)) * 0.5
    diag = jnp.clip(jnp.diagonal(A), 0.0, None)
    axis_mag = jnp.sqrt(diag + 1e-32)
    # Pick the largest diagonal as the reference component to fix signs.
    k = jnp.argmax(diag)
    col = A[:, k] / jnp.maximum(axis_mag[k], 1e-12)
    axis_pi = col / jnp.maximum(jnp.linalg.norm(col), 1e-12)
    # Keep sign consistent with antisymmetric part when it is not exactly 0.
    sign = jnp.where(jnp.dot(axis_pi, v, precision=jax.lax.Precision.HIGHEST) < 0.0, -1.0, 1.0)
    near_pi = axis_pi * sign * theta

    is_small = theta < 1e-6
    is_pi = jnp.pi - theta < 1e-4
    return jnp.where(is_small, small, jnp.where(is_pi, near_pi, generic))
