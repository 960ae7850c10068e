"""
calibration
===========

Camera and projector calibration.

API parity target: /root/reference/simplestereo/calibration.py — but with
no OpenCV anywhere in the stack:

- corner detection: :mod:`.chessboard` (prototype-correlation likelihood on
  device + lattice-growth ordering);
- bundle adjustment: :mod:`.ba` (Zhang init + complex-step LM, host f64)
  and :mod:`.sharded` (device Gauss-Newton with psum-reduced normal
  equations for large view counts);
- projector calibration (Gray code / phase shift): :mod:`.procam`.
"""

import numpy as np

from . import ba
from .chessboard import find_chessboard_corners, corner_subpix
from .procam import (
    chessboardProCam,
    chessboardProCamWhite,
    phaseShift,
    phaseShiftWhite,
    solvePnP,
    wrapped_phase_4step,
    heterodyne_unwrap,
)

DEFAULT_CHESSBOARD_SIZE = (7, 6)   # (cols, rows) inner corners
DEFAULT_CORNERSUBPIX_WINSIZE = (11, 11)


def _object_grid(chessboard_size, square_size):
    """(N,3) planar chessboard corner grid in world units
    (parity: calibration.py:60-61, row-major over (rows, cols))."""
    cols, rows = chessboard_size
    xx, yy = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack(
        [xx.ravel() * float(square_size), yy.ravel() * float(square_size),
         np.zeros(cols * rows)], axis=1)


def _load_gray(img):
    if isinstance(img, (str, bytes)):
        from ..imgio import imread
        return imread(img, grayscale=True)
    img = np.asarray(img)
    if img.ndim == 3:
        # BGR -> luminance (ITU-R 601)
        return (0.114 * img[..., 0] + 0.587 * img[..., 1]
                + 0.299 * img[..., 2])
    return img


def chessboardSingle(images, chessboardSize=DEFAULT_CHESSBOARD_SIZE,
                     squareSize=1, showImages=False, distCoeffsNumber=5):
    """Calibrate a single camera with a chessboard pattern.

    Parity: calibration.py:25-87. ``images`` is a list of image paths or
    arrays. Returns (retval RMS, cameraMatrix, distCoeffs, rvecs, tvecs)
    like ``cv2.calibrateCamera``.
    """
    objp = _object_grid(chessboardSize, squareSize)
    objs, imgs = [], []
    size = None
    for im in images:
        g = _load_gray(im)
        size = (g.shape[1], g.shape[0])
        found, corners = find_chessboard_corners(g, chessboardSize)
        if found:
            objs.append(objp)
            imgs.append(corners)
    if len(objs) < 2:
        raise ValueError("Chessboard not found in enough images!")
    rms, K, dist, rvecs, tvecs = ba.calibrate_camera(
        objs, imgs, size, num_coeffs=distCoeffsNumber)
    return rms, K, dist.reshape(1, -1), rvecs, tvecs


def chessboardStereo(images, chessboardSize=DEFAULT_CHESSBOARD_SIZE,
                     squareSize=1, distCoeffsNumber=5):
    """Calibrate a stereo rig from chessboard image pairs.

    Parity: calibration.py:90-171. ``images`` is a list of (left, right)
    path or array pairs. Returns a :class:`simplestereo_jax.StereoRig`
    with ``reprojectionError`` set to the stereo RMS.
    """
    from ..rigs import StereoRig

    objp = _object_grid(chessboardSize, squareSize)
    objs, im1, im2 = [], [], []
    size = None
    for left, right in images:
        g1 = _load_gray(left)
        g2 = _load_gray(right)
        size = (g1.shape[1], g1.shape[0])
        f1, c1 = find_chessboard_corners(g1, chessboardSize)
        f2, c2 = find_chessboard_corners(g2, chessboardSize)
        if f1 and f2:
            objs.append(objp)
            im1.append(c1)
            im2.append(c2)
    if len(objs) < 2:
        raise ValueError("Chessboard not found in enough image pairs!")
    rms, K1, d1, K2, d2, R, T, E, F, _ = ba.stereo_calibrate(
        objs, im1, im2, size, num_coeffs=distCoeffsNumber)
    return StereoRig(size, size, K1, K2, d1, d2, R, T, F=F, E=E,
                     reprojectionError=rms)


def generateChessboardSVG(chessboardSize, filepath, squareSize=20,
                          border=10):
    """Write a printable chessboard SVG (parity: calibration.py:980-1009).

    ``chessboardSize`` counts *inner* corners (cols, rows), so the board
    has (cols+1) x (rows+1) squares.
    """
    cols, rows = chessboardSize
    ncols, nrows = cols + 1, rows + 1
    parts = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'width="{ncols * squareSize}mm" height="{nrows * squareSize}mm" '
        f'viewBox="0 0 {ncols} {nrows}" '
        f'style="border: {border}mm solid #FFF;">',
        f'<rect fill="#FFF" x="0" y="0" width="{ncols}" height="{nrows}"/>',
    ]
    squares = []
    for r in range(nrows):
        for c in range(ncols):
            if (r + c) % 2 == 0:
                squares.append(
                    f'<rect fill="#000" x="{c}" y="{r}" '
                    f'width="1" height="1"/>')
    parts.extend(squares)
    parts.append('</svg>')
    with open(filepath, "w") as f:
        f.write("".join(parts))


def getFundamentalMatrixFromProjections(P1, P2):
    """F from two 3x4 projection matrices (determinant formula).

    Parity: calibration.py:1012-1045. F[i, j] is the determinant of the
    4x4 matrix stacking the two rows of P1 complementary to j over the two
    rows of P2 complementary to i.
    """
    P1 = np.asarray(P1, np.float64)
    P2 = np.asarray(P2, np.float64)
    comp = [(1, 2), (2, 0), (0, 1)]
    F = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            M = np.vstack([P1[comp[j][0]], P1[comp[j][1]],
                           P2[comp[i][0]], P2[comp[i][1]]])
            F[i, j] = np.linalg.det(M)
    return F


__all__ = [
    "ba",
    "find_chessboard_corners",
    "corner_subpix",
    "chessboardSingle",
    "chessboardStereo",
    "chessboardProCam",
    "chessboardProCamWhite",
    "phaseShift",
    "phaseShiftWhite",
    "solvePnP",
    "wrapped_phase_4step",
    "heterodyne_unwrap",
    "generateChessboardSVG",
    "getFundamentalMatrixFromProjections",
    "DEFAULT_CHESSBOARD_SIZE",
    "DEFAULT_CORNERSUBPIX_WINSIZE",
]
