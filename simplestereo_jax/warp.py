"""
warp
====

Dense image warping engine: vectorized gather resampling on device.

Replaces the OpenCV warping stack used by the reference:
``cv2.remap`` (/root/reference/simplestereo/_rigs.py:564-565, active.py:490),
``cv2.initUndistortRectifyMap`` (_rigs.py:540-541),
``cv2.undistort`` (_rigs.py:329-336, active.py:638),
``cv2.getOptimalNewCameraMatrix`` (_rigs.py:326-327).

A remap is a pure gather; for (H, W, C) images the channel axis is
vectorized. Everything here is jittable with static output shapes.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .geometry.distortion import distort_normalized
from .geometry import npgeom


def _gather2d(img, yi, xi):
    """img[(yi, xi)] with integer index arrays; img is (H, W) or (H, W, C).

    Lowered as a FLAT 1-D take of linearized indices (one index per
    sample instead of two). Indices are pre-clipped in-range by every
    caller, so mode="clip" cannot change a value."""
    H, W = img.shape[:2]
    lin = yi * W + xi
    if img.ndim == 3:
        C = img.shape[2]
        return jnp.take(img.reshape(-1, C), lin.reshape(-1), axis=0,
                        mode="clip").reshape(lin.shape + (C,))
    return jnp.take(img.reshape(-1), lin, mode="clip")


def _cubic_weights(t):
    """OpenCV bicubic kernel weights (a = -0.75) for taps at offsets
    -1, 0, 1, 2 around the floor sample; ``t`` is the fractional part."""
    a = -0.75
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    return [w0, w1, w2, w3]


def remap_row_invariant(image, mapx, mapy, interpolation="linear",
                        border_value=0.0):
    """:func:`remap` for a ROW-CONSTANT image (every row identical).

    Semantically identical to ``remap(image, mapx, mapy, ...)`` when
    ``image``'s rows are all equal, but samples a single padded ROW with
    4 (cubic) / 2 (linear) / 1 (nearest) 1-D taps instead of 16/4/1 2-D
    gathers, and folds the y-axis interpolation into a scalar
    inside-the-image weight (interior rows all carry the same sampled
    value; border rows carry ``border_value``). Motivation: the FTP
    virtual-reference resample — fringe images are row-invariant by
    construction (incl. the reference's committed fringe8.png), and this
    form replaces the 16-tap 2-D cubic gather with 4 1-D taps. Agreement
    with :func:`remap` is f32-ulp level (1-2 ulps worst case from XLA
    fusion reassociation). Callers
    must verify row-invariance (host-side ``np.array_equal`` against
    row 0) before choosing this path.
    """
    image = jnp.asarray(image)
    in_dtype = image.dtype
    if image.ndim != 2:
        raise ValueError("remap_row_invariant expects a (H, W) image!")
    H, W = image.shape
    row = image[0].astype(jnp.float32)
    x = jnp.asarray(mapx, jnp.float32)
    y = jnp.asarray(mapy, jnp.float32)

    if interpolation == "nearest":
        xi = jnp.round(x).astype(jnp.int32)
        yi = jnp.round(y).astype(jnp.int32)
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = jnp.where(inside,
                        jnp.take(row, jnp.clip(xi, 0, W - 1), mode="clip"),
                        border_value)
    elif interpolation in ("linear", "cubic"):
        pad = 1 if interpolation == "linear" else 2
        rpad = jnp.pad(row, (pad, pad), constant_values=border_value)
        lo = -float(pad)
        xc = jnp.clip(x, lo, float(W) + pad - 1.0) + pad
        yc = jnp.clip(y, lo, float(H) + pad - 1.0) + pad
        x0 = jnp.floor(xc).astype(jnp.int32)
        y0 = jnp.floor(yc).astype(jnp.int32)
        fx = xc - x0
        fy = yc - y0
        Hp, Wp = H + 2 * pad, W + 2 * pad
        if interpolation == "linear":
            x1 = jnp.clip(x0 + 1, 0, Wp - 1)
            x0c = jnp.clip(x0, 0, Wp - 1)
            sx = (jnp.take(rpad, x0c, mode="clip") * (1 - fx)
                  + jnp.take(rpad, x1, mode="clip") * fx)
            wy = [1 - fy, fy]
            rows = [y0, jnp.clip(y0 + 1, 0, Hp - 1)]
        else:
            wx = _cubic_weights(fx)
            sx = 0.0
            for j in range(4):
                xj = jnp.clip(x0 + j - 1, 0, Wp - 1)
                sx = sx + wx[j] * jnp.take(rpad, xj, mode="clip")
            wy = _cubic_weights(fy)
            rows = [jnp.clip(y0 + i - 1, 0, Hp - 1) for i in range(4)]
        # y-axis: interior padded rows all equal sx; border rows are
        # border_value — same accumulation order as remap's i-loop
        out = 0.0
        for wyi, ri in zip(wy, rows):
            inside = (ri >= pad) & (ri <= Hp - 1 - pad)
            out = out + wyi * jnp.where(inside, sx, border_value)
    else:
        raise ValueError(f"Unknown interpolation: {interpolation}")

    if jnp.issubdtype(in_dtype, jnp.integer):
        info = jnp.iinfo(in_dtype)
        out = jnp.clip(jnp.round(out), info.min, info.max).astype(in_dtype)
    return out


def remap(image, mapx, mapy, interpolation="linear", border_value=0.0):
    """Resample ``image`` at float coordinates — drop-in for ``cv2.remap``.

    ``out[y, x] = image[mapy[y, x], mapx[y, x]]`` with sub-pixel
    interpolation and constant (zero) border, matching OpenCV's default
    ``BORDER_CONSTANT`` semantics: samples falling outside blend with the
    border value.

    Parameters
    ----------
    image : jnp.ndarray
        (H, W) or (H, W, C), any real dtype.
    mapx, mapy : jnp.ndarray
        (Ho, Wo) float source coordinates.
    interpolation : str
        'nearest' | 'linear' | 'cubic'  (cubic uses OpenCV's a=-0.75 kernel).
    border_value : float
        Fill value for out-of-image samples.

    Returns
    -------
    jnp.ndarray
        (Ho, Wo[, C]) resampled image, same dtype as input for integer
        inputs (rounded), float otherwise.
    """
    image = jnp.asarray(image)
    in_dtype = image.dtype
    chan = image.ndim == 3
    H, W = image.shape[:2]
    x = jnp.asarray(mapx, jnp.float32)
    y = jnp.asarray(mapy, jnp.float32)

    imgf = image.astype(jnp.float32)

    if interpolation == "nearest":
        xi = jnp.round(x).astype(jnp.int32)
        yi = jnp.round(y).astype(jnp.int32)
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = _gather2d(imgf, jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1))
        mask = inside[..., None] if chan else inside
        out = jnp.where(mask, out, border_value)
    elif interpolation == "linear":
        pad = 1
        padded = jnp.pad(
            imgf,
            ((pad, pad), (pad, pad)) + (((0, 0),) if chan else ()),
            constant_values=border_value,
        )
        xc = jnp.clip(x, -1.0, float(W)) + pad
        yc = jnp.clip(y, -1.0, float(H)) + pad
        x0 = jnp.floor(xc).astype(jnp.int32)
        y0 = jnp.floor(yc).astype(jnp.int32)
        fx = xc - x0
        fy = yc - y0
        if chan:
            fx = fx[..., None]
            fy = fy[..., None]
        Hp, Wp = H + 2 * pad, W + 2 * pad
        x1 = jnp.clip(x0 + 1, 0, Wp - 1)
        y1 = jnp.clip(y0 + 1, 0, Hp - 1)
        x0 = jnp.clip(x0, 0, Wp - 1)
        y0 = jnp.clip(y0, 0, Hp - 1)
        v00 = _gather2d(padded, y0, x0)
        v01 = _gather2d(padded, y0, x1)
        v10 = _gather2d(padded, y1, x0)
        v11 = _gather2d(padded, y1, x1)
        out = (
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )
    elif interpolation == "cubic":
        pad = 2
        padded = jnp.pad(
            imgf,
            ((pad, pad), (pad, pad)) + (((0, 0),) if chan else ()),
            constant_values=border_value,
        )
        xc = jnp.clip(x, -2.0, float(W) + 1.0) + pad
        yc = jnp.clip(y, -2.0, float(H) + 1.0) + pad
        x0 = jnp.floor(xc).astype(jnp.int32)
        y0 = jnp.floor(yc).astype(jnp.int32)
        fx = xc - x0
        fy = yc - y0

        wx = _cubic_weights(fx)
        wy = _cubic_weights(fy)
        Hp, Wp = H + 2 * pad, W + 2 * pad
        out = 0.0
        for i in range(4):
            yi = jnp.clip(y0 + i - 1, 0, Hp - 1)
            row = 0.0
            for j in range(4):
                xj = jnp.clip(x0 + j - 1, 0, Wp - 1)
                w = wx[j][..., None] if chan else wx[j]
                row = row + w * _gather2d(padded, yi, xj)
            w = wy[i][..., None] if chan else wy[i]
            out = out + w * row
    else:
        raise ValueError(f"Unknown interpolation: {interpolation}")

    if jnp.issubdtype(in_dtype, jnp.integer):
        info = jnp.iinfo(in_dtype)
        out = jnp.clip(jnp.round(out), info.min, info.max).astype(in_dtype)
    return out


def _inv3(M):
    """Inverse of a 3x3 matrix by its adjugate: elementwise f32 math, so
    no matmul precision setting (TF32 on a GPU) can touch it."""
    c = [[M[(i + 1) % 3, (j + 1) % 3] * M[(i + 2) % 3, (j + 2) % 3]
          - M[(i + 1) % 3, (j + 2) % 3] * M[(i + 2) % 3, (j + 1) % 3]
          for j in range(3)] for i in range(3)]
    det = M[0, 0] * c[0][0] + M[0, 1] * c[0][1] + M[0, 2] * c[0][2]
    return jnp.array([[c[j][i] for j in range(3)] for i in range(3)]) / det


@functools.partial(jax.jit, static_argnames=("size",))
def _compute_rectify_map(K, dist14, R, newP, size):
    w, h = size
    u = jnp.arange(w, dtype=jnp.float32)
    v = jnp.arange(h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)  # (h, w)

    iR = _inv3(jnp.matmul(newP, R, precision=jax.lax.Precision.HIGHEST))
    X = iR[0, 0] * uu + iR[0, 1] * vv + iR[0, 2]
    Y = iR[1, 0] * uu + iR[1, 1] * vv + iR[1, 2]
    Wc = iR[2, 0] * uu + iR[2, 1] * vv + iR[2, 2]
    xn = X / Wc
    yn = Y / Wc

    pts = jnp.stack([xn, yn], axis=-1)
    dpts = distort_normalized(pts, dist14)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    mapx = fx * dpts[..., 0] + skew * dpts[..., 1] + cx
    mapy = fy * dpts[..., 1] + cy
    return mapx, mapy


def init_undistort_rectify_map(camera_matrix, dist_coeffs, R, new_camera_matrix, size):
    """Build undistort+rectify sampling maps — drop-in for
    ``cv2.initUndistortRectifyMap`` (CV_32FC1 output flavor).

    For every destination pixel: back-project through
    ``(new_camera_matrix @ R)^-1``, apply forward lens distortion, and
    project through the *original* intrinsics. No iterative inversion is
    needed in this direction.

    Parameters
    ----------
    camera_matrix : array
        3x3 original intrinsics.
    dist_coeffs : array or None
    R : array or None
        3x3 rectification transform (object-space, OpenCV convention).
    new_camera_matrix : array
        3x3 (or 3x4, first 3 cols used) new projection.
    size : tuple
        (width, height) of the destination image.

    Returns
    -------
    (mapx, mapy) : jnp.ndarray
        Two (height, width) float32 maps for :func:`remap`.
    """
    from .geometry.distortion import pad_dist_coeffs

    K = jnp.asarray(camera_matrix, jnp.float32).reshape(3, 3)
    d = pad_dist_coeffs(dist_coeffs, dtype=jnp.float32)
    Rm = jnp.eye(3, dtype=jnp.float32) if R is None else jnp.asarray(R, jnp.float32).reshape(3, 3)
    nK = jnp.asarray(new_camera_matrix, jnp.float32)
    nK = nK.reshape(3, -1)[:, :3]
    return _compute_rectify_map(K, d, Rm, nK, (int(size[0]), int(size[1])))


def undistort_image(image, camera_matrix, dist_coeffs, new_camera_matrix=None,
                    interpolation="linear"):
    """Undistort an image — drop-in for ``cv2.undistort``.

    Parameters
    ----------
    image : jnp.ndarray
        (H, W[, C]) image.
    camera_matrix : array
        3x3 intrinsics.
    dist_coeffs : array or None
    new_camera_matrix : array, optional
        Defaults to ``camera_matrix``.

    Returns
    -------
    jnp.ndarray
        Undistorted image, same shape/dtype.
    """
    image = jnp.asarray(image)
    h, w = image.shape[:2]
    nK = camera_matrix if new_camera_matrix is None else new_camera_matrix
    mapx, mapy = init_undistort_rectify_map(camera_matrix, dist_coeffs, None, nK, (w, h))
    return remap(image, mapx, mapy, interpolation=interpolation)


def get_optimal_new_camera_matrix(camera_matrix, dist_coeffs, image_size, alpha,
                                  new_image_size=None, center_principal_point=False):
    """New intrinsics trading off valid-pixel crop vs full field of view.

    Equivalent of ``cv2.getOptimalNewCameraMatrix`` (used by
    ``StereoRig.undistortImages``, /root/reference/simplestereo/_rigs.py:326).
    Computes the outer (all pixels) and inner (only valid pixels) rectangles
    of the undistorted image from an N x N border grid, then blends with
    ``alpha``.

    Returns
    -------
    (new_camera_matrix, roi) : (numpy.ndarray, tuple)
        3x3 matrix and (x, y, w, h) valid ROI — mirroring OpenCV's API.
    """
    K = np.asarray(camera_matrix, np.float64).reshape(3, 3)
    w, h = int(image_size[0]), int(image_size[1])
    if new_image_size is None:
        new_image_size = (w, h)
    nw, nh = int(new_image_size[0]), int(new_image_size[1])

    N = 9
    # Border grid of the source image (OpenCV icvGetRectangles uses a 9x9 grid
    # over the full image; rectangles come from the undistorted grid).
    xs = np.linspace(0, w - 1, N)
    ys = np.linspace(0, h - 1, N)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    und = npgeom.undistort_points(pts, K, dist_coeffs).reshape(N, N, 2)

    # Outer rect: bounding box of all undistorted grid points.
    ox0, oy0 = und[..., 0].min(), und[..., 1].min()
    ox1, oy1 = und[..., 0].max(), und[..., 1].max()

    # Inner rect: per-side extrema so that every border row/column is inside.
    ix0 = und[:, 0, 0].max()     # left column → max x
    ix1 = und[:, -1, 0].min()    # right column → min x
    iy0 = und[0, :, 1].max()     # top row → max y
    iy1 = und[-1, :, 1].min()    # bottom row → min y

    def k_from_rect(x0, y0, x1, y1):
        fx = (nw - 1) / max(x1 - x0, 1e-9)
        fy = (nh - 1) / max(y1 - y0, 1e-9)
        cx = -fx * x0
        cy = -fy * y0
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)

    K_outer = k_from_rect(ox0, oy0, ox1, oy1)
    K_inner = k_from_rect(ix0, iy0, ix1, iy1)

    newK = K_inner * (1 - alpha) + K_outer * alpha
    newK[2, 2] = 1.0
    if center_principal_point:
        newK[0, 2] = (nw - 1) * 0.5
        newK[1, 2] = (nh - 1) * 0.5

    # Valid ROI: the inner rectangle (normalized coords) through newK.
    def mapped(x, y):
        v = newK @ np.array([x, y, 1.0])
        return v[:2] / v[2]

    tl = mapped(ix0, iy0)
    br = mapped(ix1, iy1)
    x0r, y0r = int(np.ceil(tl[0])), int(np.ceil(tl[1]))
    x1r, y1r = int(np.floor(br[0])), int(np.floor(br[1]))
    x0r, y0r = max(x0r, 0), max(y0r, 0)
    roi = (x0r, y0r, max(x1r - x0r, 0), max(y1r - y0r, 0))
    return newK, roi


def map_coordinates(image, coords, order=1):
    """Sample ``image`` at (y, x) float coordinates (scipy-style).

    Equivalent of ``scipy.ndimage.map_coordinates`` as used by the
    reference's phase-shift calibration for sub-pixel phase sampling
    (/root/reference/simplestereo/calibration.py:748-749).

    Parameters
    ----------
    image : jnp.ndarray
        (H, W) array.
    coords : jnp.ndarray
        (2, N) stacked (y, x) sample positions.
    order : int
        0 (nearest), 1 (bilinear) or 3 (bicubic).

    Returns
    -------
    jnp.ndarray
        (N,) sampled values.
    """
    coords = jnp.asarray(coords)
    y, x = coords[0], coords[1]
    interp = {0: "nearest", 1: "linear", 3: "cubic"}[order]
    out = remap(image, x.reshape(1, -1), y.reshape(1, -1), interpolation=interp)
    return out.reshape(-1)
