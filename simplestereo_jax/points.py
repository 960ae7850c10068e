"""
points
======

Point-cloud management: PLY export/import, disparity reprojection.

Parity target: /root/reference/simplestereo/points.py. The PLY writers are
format-compatible with the reference (same header, same ``comment Original
array shape HxWx3`` convention) but vectorized: row formatting happens in
one numpy call instead of a Python loop per point.
"""

import numpy as np
import jax
import jax.numpy as jnp


def exportPLY(points3D, filepath, referenceImage=None, precision=6):
    """Export a point cloud to ASCII PLY.

    Matches the reference format (points.py:10-80): double x/y/z properties,
    optional per-vertex color from a BGR image (written as RGB uchar) or a
    grayscale intensity (int or float), and a header comment recording the
    original array shape.

    Parameters
    ----------
    points3D : numpy.ndarray
        (..., 3) points; flattened for writing.
    filepath : str
    referenceImage : numpy.ndarray, optional
        Color source. Same number of pixels as points: 3 channels = BGR,
        otherwise treated as grayscale intensity.
    precision : int
        Decimal places for coordinates.
    """
    points3D = np.asarray(points3D)
    originalShape = points3D.shape
    pts = points3D.reshape(-1, 3)
    n = pts.shape[0]

    header = [
        "ply",
        "format ascii 1.0",
        "comment SimpleStereo point cloud export",
        f"comment Original array shape {'x'.join(str(d) for d in originalShape)}",
        f"element vertex {n}",
        "property double x",
        "property double y",
        "property double z",
    ]

    fmt3 = " ".join([f"%.{precision}f"] * 3)
    if referenceImage is None:
        body_arr = pts
        fmt = fmt3
    else:
        referenceImage = np.asarray(referenceImage)
        if referenceImage.size == pts.size:  # BGR color image
            header += [
                "property uchar red",
                "property uchar green",
                "property uchar blue",
            ]
            rgb = referenceImage.reshape(-1, 3)[:, ::-1]  # BGR -> RGB
            body_arr = np.hstack([pts, rgb.astype(np.float64)])
            fmt = fmt3 + " %d %d %d"
        else:  # grayscale
            gray = np.ravel(referenceImage)
            if np.issubdtype(gray.dtype, np.integer):
                header.append("property int intensity")
                body_arr = np.hstack([pts, gray[:, None].astype(np.float64)])
                fmt = fmt3 + " %d"
            else:
                header.append("property float intensity")
                body_arr = np.hstack([pts, gray[:, None].astype(np.float64)])
                fmt = fmt3 + f" %.{precision}f"

    header.append("end_header")
    header_bytes = ("\n".join(header) + "\n").encode()

    # Fast path: the native C++ serializer (simplestereo_jax.native._ply);
    # falls back to numpy.savetxt when the extension is unavailable.
    from .native import get_ply
    _ply = get_ply()
    if _ply is not None:
        xyz = np.ascontiguousarray(pts, np.float64)
        if referenceImage is None:
            _ply.write_xyz(filepath, header_bytes, xyz, precision)
        elif referenceImage.size == pts.size:
            rgb = np.ascontiguousarray(
                referenceImage.reshape(-1, 3)[:, ::-1], np.uint8)
            _ply.write_xyz_rgb(filepath, header_bytes, xyz, rgb, precision)
        else:
            gray = np.ravel(referenceImage)
            as_int = 1 if np.issubdtype(gray.dtype, np.integer) else 0
            _ply.write_xyz_intensity(
                filepath, header_bytes, xyz,
                np.ascontiguousarray(gray, np.float64), as_int, precision)
        return

    with open(filepath, "w") as f:
        f.write("\n".join(header) + "\n")
        np.savetxt(f, body_arr, fmt=fmt)


def importPLY(filename, *properties):
    """Read float property columns from an ASCII PLY file.

    Parity: reference points.py:82-120 — skips to ``end_header`` then parses
    the requested column indices (default (0, 1, 2)) as floats.

    Returns
    -------
    numpy.ndarray
        (N, len(properties)) float array.
    """
    if not properties:
        properties = (0, 1, 2)
    n_skip = 0
    n_vertex = None
    n_cols = 0
    with open(filename, "r") as f:
        for line in f:
            n_skip += 1
            t = line.split()
            if t[:2] == ["element", "vertex"]:
                n_vertex = int(t[2])
            elif t and t[0] == "property":
                n_cols += 1
            if line.rstrip().lower() == "end_header":
                break

    from .native import get_ply
    _ply = get_ply()
    if _ply is not None and n_vertex is not None and n_cols > 0:
        raw = _ply.read_ascii_floats(filename, n_skip, n_vertex, n_cols)
        data = np.frombuffer(raw, np.float64).reshape(n_vertex, n_cols)
        return data[:, list(properties)]

    with open(filename, "r") as f:
        for line in f:
            if line.rstrip().lower() == "end_header":
                break
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    return data[:, list(properties)]


@jax.jit
def _reproject_q(disparity, Q):
    H, W = disparity.shape
    xs = jnp.arange(W, dtype=jnp.float32)
    ys = jnp.arange(H, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(xs, ys)
    d = disparity.astype(jnp.float32)
    X = Q[0, 0] * xx + Q[0, 1] * yy + Q[0, 2] * d + Q[0, 3]
    Y = Q[1, 0] * xx + Q[1, 1] * yy + Q[1, 2] * d + Q[1, 3]
    Z = Q[2, 0] * xx + Q[2, 1] * yy + Q[2, 2] * d + Q[2, 3]
    Wc = Q[3, 0] * xx + Q[3, 1] * yy + Q[3, 2] * d + Q[3, 3]
    inv = 1.0 / Wc
    return jnp.stack([X * inv, Y * inv, Z * inv], axis=-1)


def reprojectImageTo3D(disparityMap, Q):
    """Dense disparity -> (H, W, 3) points through a 4x4 Q matrix.

    JAX equivalent of ``cv2.reprojectImageTo3D`` (used by the reference at
    _rigs.py:628, points.py:176). Division by a zero homogeneous coordinate
    (disparity that maps to W=0) produces inf, as in OpenCV — callers should
    mask invalid disparities.
    """
    disparityMap = jnp.asarray(disparityMap)
    Q = jnp.asarray(Q, jnp.float32).reshape(4, 4)
    return np.asarray(_reproject_q(disparityMap, Q))


def getAdimensional3DPoints(disparityMap):
    """Rig-less disparity reprojection with synthetic intrinsics.

    Same synthetic Q as the reference (points.py:124-176): f = width,
    principal point at the image center, unit baseline. Useful for quick
    non-metric 3D previews of any disparity map.
    """
    disparityMap = np.asarray(disparityMap)
    height, width = disparityMap.shape[:2]

    b, fx, fy = 1.0, float(width), float(width)
    cx1 = cx2 = width / 2
    a1 = a2 = 0.0
    cy = height / 2

    Q = np.eye(4, dtype=np.float64)
    Q[0, 1] = -a1 / fy
    Q[0, 3] = a1 * cy / fy - cx1
    Q[1, 1] = fx / fy
    Q[1, 3] = -cy * fx / fy
    Q[2, 2] = 0
    Q[2, 3] = -fx
    Q[3, 1] = (a2 - a1) / (fy * b)
    Q[3, 2] = 1 / b
    Q[3, 3] = ((a1 - a2) * cy + (cx2 - cx1) * fy) / (fy * b)

    return reprojectImageTo3D(disparityMap, Q)


def distortPoints(points, distCoeff):
    """Forward-distort normalized points with the reference's polynomial model.

    NOTE: the reference's ``points.distortPoints`` (points.py:179-220) uses a
    *purely polynomial* radial model where k4..k6 are additional numerator
    terms (r^8..r^12), NOT the OpenCV rational model. This function keeps
    that exact behavior for parity (it is used by the white-centers pro-cam
    calibration, calibration.py:399); for the OpenCV-compatible rational
    model use :func:`simplestereo_jax.geometry.distort_normalized`.

    Parameters
    ----------
    points : array
        (N, 1, 2) or (N, 2) normalized undistorted coordinates.
    distCoeff : array
        4, 5 or 8 coefficients (k1, k2, p1, p2[, k3[, k4, k5, k6]]).

    Returns
    -------
    numpy.ndarray
        (N, 1, 2) distorted normalized coordinates.
    """
    distCoeff = np.asarray(distCoeff, np.float64).ravel()
    n = distCoeff.shape[0]
    if n not in (4, 5, 8):
        raise ValueError(f"distCoeff is not in a valid format! (length {n} unexpected)")
    k1, k2, p1, p2, k3, k4, k5, k6 = np.concatenate([distCoeff, np.zeros(8 - n)])

    pts = np.asarray(points, np.float64).reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3 + k4 * r2**4 + k5 * r2**5 + k6 * r2**6
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1).reshape(-1, 1, 2)
