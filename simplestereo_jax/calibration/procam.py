"""
procam
======

Camera-projector calibration.

Parity targets in /root/reference/simplestereo/calibration.py:

- :func:`chessboardProCam` (:174-345) — Moreno & Taubin 2012 local
  Gray-code homographies (method of kamino410/procam-calibration, which
  the reference adapted; reimplemented here from the paper's structure);
- :func:`chessboardProCamWhite` (:408-614) — white-square-center variant;
- :func:`phaseShift` (:617-782) — 4-step phase shifting + heterodyne
  multi-period unwrapping [Reich 1997];
- :func:`phaseShiftWhite` (:785-977).

Device-first difference: the reference decodes Gray-code bits per pixel with
``getProjPixel`` inside Python patch loops; here each image set is decoded
*once* by the vectorized device kernel
(:func:`simplestereo_jax.active.decode_graycode`) and the patch loops just
gather from the decoded maps.
"""

import warnings

import numpy as np

from . import ba
from .chessboard import find_chessboard_corners
from ..geometry import npgeom


def _load_gray_f(img):
    if isinstance(img, (str, bytes)):
        from ..imgio import imread
        return imread(img, grayscale=True).astype(np.float64)
    img = np.asarray(img)
    if img.ndim == 3:
        img = (0.114 * img[..., 0] + 0.587 * img[..., 1]
               + 0.299 * img[..., 2])
    return img.astype(np.float64)


def _object_grid(chessboard_size, square_size):
    cols, rows = chessboard_size
    xx, yy = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack(
        [xx.ravel() * float(square_size), yy.ravel() * float(square_size),
         np.zeros(cols * rows)], 1)


def solvePnP(objp, imgp, K, dist):
    """Single-view pose from known intrinsics (cv2.solvePnP analog):
    one-view bundle adjustment with intrinsics fixed."""
    _, _, _, rv, tv = ba.calibrate_camera(
        [objp], [imgp], (0, 0), num_coeffs=len(np.ravel(dist)) if dist
        is not None else 0, K_init=K, dist_init=dist, fix_intrinsic=True,
        max_iter=40)
    return rv[0], tv[0]


def _decode_set(pattern_imgs, proj_res, white_thr):
    """Vectorized Gray-code decode of one captured set."""
    import jax.numpy as jnp
    from ..active.graycode import decode_graycode
    from ..active.patterns import graycode_num_bits

    nx = graycode_num_bits(proj_res[0])
    ny = graycode_num_bits(proj_res[1])
    imgs = np.stack([np.asarray(i) for i in pattern_imgs])
    px, py, valid = decode_graycode(
        jnp.asarray(imgs), nx=nx, ny=ny, white_thr=white_thr)
    px, py, valid = map(np.asarray, (px, py, valid))
    valid = valid & (px < proj_res[0]) & (py < proj_res[1])
    return px, py, valid


def _patch_homography_point(corner, px, py, valid, patch_half,
                            extra_mask=None):
    """Map one camera point into the projector via a local homography of
    decoded Gray-code correspondences (Moreno-Taubin local patch)."""
    H, W = px.shape
    c_x = int(round(corner[0]))
    c_y = int(round(corner[1]))
    x0, x1 = max(c_x - patch_half, 0), min(c_x + patch_half + 1, W)
    y0, y1 = max(c_y - patch_half, 0), min(c_y + patch_half + 1, H)
    sub_v = valid[y0:y1, x0:x1]
    if extra_mask is not None:
        sub_v = sub_v & extra_mask[y0:y1, x0:x1]
    ys, xs = np.nonzero(sub_v)
    if len(ys) < patch_half ** 2:
        return None
    src = np.stack([xs + x0, ys + y0], 1).astype(np.float64)
    dst = np.stack([px[y0:y1, x0:x1][ys, xs],
                    py[y0:y1, x0:x1][ys, xs]], 1).astype(np.float64)
    try:
        Hm = ba._homography_dlt(src, dst)
    except np.linalg.LinAlgError:
        return None
    p = Hm @ np.array([corner[0], corner[1], 1.0])
    return p[:2] / p[2]


def _finalize_procam(cam_shape, projectorResolution, objps_list,
                     cam_pts_list, proj_pts_list, camIntrinsic,
                     camDistCoeffs, cam_objps_list, cam_corners_list,
                     extended=False):
    """Shared tail: camera calib (unless given), projector calib, then
    stereo calibration with fixed intrinsics (CALIB_FIX_INTRINSIC)."""
    from ..rigs import StereoRig

    h, w = cam_shape
    if camIntrinsic is None:
        _, cam_int, cam_dist, _, _ = ba.calibrate_camera(
            cam_objps_list, cam_corners_list, (w, h))
    else:
        cam_int = np.asarray(camIntrinsic, np.float64)
        cam_dist = (np.zeros(5) if camDistCoeffs is None
                    else np.ravel(camDistCoeffs).astype(np.float64))

    _, proj_int, proj_dist, _, _ = ba.calibrate_camera(
        objps_list, proj_pts_list, projectorResolution)

    out = ba.stereo_calibrate(
        objps_list, cam_pts_list, proj_pts_list, (w, h),
        K1=cam_int, dist1=cam_dist, K2=proj_int, dist2=proj_dist,
        fix_intrinsic=True)
    rms, K1, d1, K2, d2, R, T, E, F, per_view = out
    rig = StereoRig((w, h), projectorResolution, K1, K2, d1, d2, R, T,
                    F=F, E=E, reprojectionError=rms)
    if extended:
        return rig, per_view
    return rig


def chessboardProCam(images, projectorResolution,
                     chessboardSize=(7, 6), squareSize=1,
                     black_thr=40, white_thr=5, camIntrinsic=None,
                     camDistCoeffs=None):
    """Camera-projector calibration via Gray code (Moreno & Taubin).

    ``images``: list of sets; each set is ordered as all Gray-code
    patterns followed by black, normal-light and white images (parity:
    calibration.py:174-345). Returns a StereoRig (camera = position 1).
    """
    objps = _object_grid(chessboardSize, squareSize)
    n_expected = None

    cam_corners_list = []
    cam_objps_list = []
    cam_corners_list2 = []
    proj_objps_list = []
    proj_corners_list = []
    skipped = 0
    cam_shape = None
    patch_half = None

    from ..active.patterns import graycode_num_bits
    n_pat = 2 * (graycode_num_bits(projectorResolution[0])
                 + graycode_num_bits(projectorResolution[1]))

    for imageset in images:
        if len(imageset) != n_pat + 3:
            raise ValueError("Invalid number of images in set!")
        grays = [_load_gray_f(p) for p in imageset]
        white_img = grays.pop()
        normal_img = grays.pop()
        black_img = grays.pop()
        if cam_shape is None:
            cam_shape = normal_img.shape
            patch_half = int(np.ceil(cam_shape[1] / 180))
        elif normal_img.shape != cam_shape:
            raise ValueError("Image size mismatch!")

        found, cam_corners = find_chessboard_corners(
            normal_img, chessboardSize)
        if not found:
            raise ValueError("Chessboard not found in set!")

        cam_corners_list.append(cam_corners)
        cam_objps_list.append(objps)

        px, py, valid = _decode_set(grays, projectorResolution, white_thr)
        lit = (white_img - black_img) > black_thr
        valid = valid & lit

        proj_objps = []
        proj_corners = []
        cam_corners2 = []
        for corner, objp in zip(cam_corners, objps):
            pt = _patch_homography_point(corner, px, py, valid, patch_half)
            if pt is None:
                skipped += 1
                continue
            proj_objps.append(objp)
            proj_corners.append(pt)
            cam_corners2.append(corner)
        if len(proj_corners) < 3:
            raise ValueError("Not enough corners were found in set "
                             "(less than 3).")
        proj_objps_list.append(np.asarray(proj_objps))
        proj_corners_list.append(np.asarray(proj_corners))
        cam_corners_list2.append(np.asarray(cam_corners2))

    if skipped > 0:
        warnings.warn(f"{skipped} skipped corners.")

    return _finalize_procam(
        cam_shape, projectorResolution, proj_objps_list, cam_corners_list2,
        proj_corners_list, camIntrinsic, camDistCoeffs, cam_objps_list,
        cam_corners_list)


def _white_centers(cam_corners_list, cam_int, cam_dist, chessboardSize,
                   squareSize):
    """Centers of white squares (diagonal intersection computed in
    undistorted space, then re-distorted). Parity: calibration.py:348-405.

    Returns (list of (m,2) centers per view, (m,3) object points).
    """
    cols, rows = chessboardSize
    upper_left = []
    for i in range(cols * (rows - 1)):
        r, c = divmod(i, cols)
        if c == cols - 1:
            continue
        # white square: in a standard board the square below-right of
        # corner (r, c) is white when r+c is odd (origin square black)
        if (r + c) % 2 == 1:
            upper_left.append(i)
    white_objps = np.zeros((len(upper_left), 3))
    for k, w in enumerate(upper_left):
        white_objps[k, 0] = (w % cols + 0.5) * squareSize
        white_objps[k, 1] = (w // cols + 0.5) * squareSize

    out = []
    for pts in cam_corners_list:
        und = npgeom.undistort_points(np.asarray(pts, np.float64),
                                      cam_int, cam_dist)
        centers = []
        for w in upper_left:
            xa, ya = und[w]
            xb, yb = und[w + 1]
            xd, yd = und[w + cols]
            xc, yc = und[w + cols + 1]
            # intersection of the two diagonals a-c and b-d
            den = (yd - yb) * (xc - xa) - (yc - ya) * (xd - xb)
            x_c = (xb * (yd - yb) * (xc - xa)
                   + (ya - yb) * (xd - xb) * (xc - xa)
                   - xa * (yc - ya) * (xd - xb)) / den
            y_c = (yc - ya) * (x_c - xa) / (xc - xa) + ya
            centers.append((x_c, y_c))
        centers = np.asarray(centers)  # normalized undistorted coords
        dist_norm = npgeom.distort_normalized(centers, cam_dist)
        hpts = np.hstack([dist_norm, np.ones((len(dist_norm), 1))])
        pix = hpts @ np.asarray(cam_int, np.float64).T
        out.append(pix[:, :2] / pix[:, 2:3])
    return out, white_objps


def chessboardProCamWhite(images, projectorResolution,
                          chessboardSize=(7, 6), squareSize=1,
                          black_thr=40, white_thr=5, camIntrinsic=None,
                          camDistCoeffs=None, extended=False):
    """Gray-code pro-cam calibration using white-square centers (less
    decode ambiguity than high-contrast corners). Parity:
    calibration.py:408-614; with extended=True also returns
    perViewErrors."""
    objps = _object_grid(chessboardSize, squareSize)

    from ..active.patterns import graycode_num_bits
    n_pat = 2 * (graycode_num_bits(projectorResolution[0])
                 + graycode_num_bits(projectorResolution[1]))

    cam_corners_list = []
    cam_objps_list = []
    decoded = []
    cam_shape = None
    patch_half = None
    for imageset in images:
        if len(imageset) != n_pat + 3:
            raise ValueError("Invalid number of images in set!")
        grays = [_load_gray_f(p) for p in imageset]
        white_img = grays.pop()
        normal_img = grays.pop()
        black_img = grays.pop()
        if cam_shape is None:
            cam_shape = normal_img.shape
            patch_half = int(np.ceil(cam_shape[1] / 180))
        found, cam_corners = find_chessboard_corners(
            normal_img, chessboardSize)
        if not found:
            raise ValueError("Chessboard not found in set!")
        cam_corners_list.append(cam_corners)
        cam_objps_list.append(objps)
        px, py, valid = _decode_set(grays, projectorResolution, white_thr)
        valid = valid & ((white_img - black_img) > black_thr)
        decoded.append((px, py, valid))

    h, w = cam_shape
    if camIntrinsic is None:
        _, cam_int, cam_dist, _, _ = ba.calibrate_camera(
            cam_objps_list, cam_corners_list, (w, h))
    else:
        cam_int = np.asarray(camIntrinsic, np.float64)
        cam_dist = (np.zeros(5) if camDistCoeffs is None
                    else np.ravel(camDistCoeffs).astype(np.float64))

    white_list, white_objps = _white_centers(
        cam_corners_list, cam_int, cam_dist, chessboardSize, squareSize)

    proj_objps_list, proj_pts_list, cam_pts_list = [], [], []
    skipped = 0
    for (px, py, valid), centers in zip(decoded, white_list):
        po, pp, cc = [], [], []
        for center, objp in zip(centers, white_objps):
            pt = _patch_homography_point(center, px, py, valid, patch_half)
            if pt is None:
                skipped += 1
                continue
            po.append(objp)
            pp.append(pt)
            cc.append(center)
        if len(pp) < 3:
            raise ValueError("Not enough centers decoded in a set!")
        proj_objps_list.append(np.asarray(po))
        proj_pts_list.append(np.asarray(pp))
        cam_pts_list.append(np.asarray(cc))
    if skipped:
        warnings.warn(f"{skipped} skipped white centers.")

    return _finalize_procam(
        cam_shape, projectorResolution, proj_objps_list, cam_pts_list,
        proj_pts_list, cam_int, cam_dist, cam_objps_list,
        cam_corners_list, extended=extended)


# --------------------------------------------------------------------------
# phase shifting
# --------------------------------------------------------------------------

def wrapped_phase_4step(I0, I1, I2, I3):
    """Wrapped phase of a 4-step shift cos(theta + i*pi/2) in [0, 2pi)
    (parity: calibration.py:656-667)."""
    return np.mod(np.arctan2(np.asarray(I3, float) - I1,
                             np.asarray(I0, float) - I2), 2 * np.pi)


def heterodyne_unwrap(theta0, theta1, T0, T1):
    """Unwrap theta1 (period T1) against the absolute theta0 (period T0);
    result normalized to [0, 2pi) at period T0 (calibration.py:670-678)."""
    k = np.rint((theta0 * T0 / T1 - theta1) / (2 * np.pi))
    return (theta1 + 2 * np.pi * k) * T1 / T0


def _absolute_phases(grays, periods):
    """Heterodyne-combined absolute phase maps (horizontal, vertical)."""
    i = 0
    phase = [None, None]
    for v in range(2):
        for j, T in enumerate(periods[v]):
            p = wrapped_phase_4step(*grays[i:i + 4])
            if j == 0:
                phase[v] = p
            else:
                phase[v] = heterodyne_unwrap(phase[v], p,
                                             periods[v][0], T)
            i += 4
    return phase


def _sample_bilinear(img, pts):
    """Bilinear sample img at (x, y) float points (map_coordinates o=1)."""
    from scipy.ndimage import map_coordinates
    pts = np.asarray(pts, np.float64)
    return map_coordinates(img, [pts[:, 1], pts[:, 0]], order=1)


def phaseShift(periods, projectorResolution, cameraImages,
               chessboardSize=(7, 6), squareSize=1, camIntrinsic=None,
               camDistCoeffs=None):
    """Camera-projector calibration via 4-step phase shifting and
    heterodyne unwrapping (parity: calibration.py:617-782).

    ``periods``: [horizontal_periods, vertical_periods], each in
    descending order, the first equal to the projector dimension.
    ``cameraImages``: list of sets, 4 images per period (horizontal sets
    first), final image under normal light.
    """
    objps = _object_grid(chessboardSize, squareSize)
    cam_corners_list, cam_objps_list = [], []
    proj_corners_list, proj_objps_list = [], []
    cam_shape = None

    for imageset in cameraImages:
        grays = [_load_gray_f(p) for p in imageset]
        normal_img = grays[-1]
        if cam_shape is None:
            cam_shape = normal_img.shape
        found, cam_corners = find_chessboard_corners(
            normal_img, chessboardSize)
        if not found:
            raise ValueError("Chessboard not found in set!")
        cam_corners_list.append(cam_corners)
        cam_objps_list.append(objps)

        phase = _absolute_phases(grays, periods)
        phase_x = _sample_bilinear(phase[0], cam_corners)
        phase_y = _sample_bilinear(phase[1], cam_corners)
        proj = np.stack(
            [projectorResolution[0] * phase_x / (2 * np.pi),
             projectorResolution[1] * phase_y / (2 * np.pi)], 1)
        proj_corners_list.append(proj)
        proj_objps_list.append(objps)

    return _finalize_procam(
        cam_shape, projectorResolution, proj_objps_list, cam_corners_list,
        proj_corners_list, camIntrinsic, camDistCoeffs, cam_objps_list,
        cam_corners_list)


def phaseShiftWhite(periods, projectorResolution, cameraImages,
                    chessboardSize=(7, 6), squareSize=1, camIntrinsic=None,
                    camDistCoeffs=None, extended=False):
    """Phase-shift calibration sampling at white-square centers
    (parity: calibration.py:785-977)."""
    objps = _object_grid(chessboardSize, squareSize)
    cam_corners_list, cam_objps_list = [], []
    phases = []
    cam_shape = None

    for imageset in cameraImages:
        grays = [_load_gray_f(p) for p in imageset]
        normal_img = grays[-1]
        if cam_shape is None:
            cam_shape = normal_img.shape
        found, cam_corners = find_chessboard_corners(
            normal_img, chessboardSize)
        if not found:
            raise ValueError("Chessboard not found in set!")
        cam_corners_list.append(cam_corners)
        cam_objps_list.append(objps)
        phases.append(_absolute_phases(grays, periods))

    h, w = cam_shape
    if camIntrinsic is None:
        _, cam_int, cam_dist, _, _ = ba.calibrate_camera(
            cam_objps_list, cam_corners_list, (w, h))
    else:
        cam_int = np.asarray(camIntrinsic, np.float64)
        cam_dist = (np.zeros(5) if camDistCoeffs is None
                    else np.ravel(camDistCoeffs).astype(np.float64))

    white_list, white_objps = _white_centers(
        cam_corners_list, cam_int, cam_dist, chessboardSize, squareSize)

    proj_pts_list, proj_objps_list, cam_pts_list = [], [], []
    for phase, centers in zip(phases, white_list):
        phase_x = _sample_bilinear(phase[0], centers)
        phase_y = _sample_bilinear(phase[1], centers)
        proj = np.stack(
            [projectorResolution[0] * phase_x / (2 * np.pi),
             projectorResolution[1] * phase_y / (2 * np.pi)], 1)
        proj_pts_list.append(proj)
        proj_objps_list.append(white_objps)
        cam_pts_list.append(centers)

    return _finalize_procam(
        cam_shape, projectorResolution, proj_objps_list, cam_pts_list,
        proj_pts_list, cam_int, cam_dist, cam_objps_list,
        cam_corners_list, extended=extended)
