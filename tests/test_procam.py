"""Camera-projector calibration on fully synthetic scenes: rendered
chessboards, simulated Gray-code captures and phase-shift fringes, known
ground-truth projector pose to recover."""

import numpy as np
import pytest

import simplestereo_jax as ss
from simplestereo_jax.calibration import ba
from simplestereo_jax.calibration.procam import (
    chessboardProCam, chessboardProCamWhite, phaseShift, phaseShiftWhite,
    wrapped_phase_4step, heterodyne_unwrap)
from simplestereo_jax.active import graycode_patterns

CAM_RES = (256, 192)
PROJ_RES = (256, 192)
KC = np.array([[240., 0, 127.5], [0, 240., 95.5], [0, 0, 1]])
KP = np.array([[300., 0, 127.5], [0, 300., 95.5], [0, 0, 1]])
SQ = 20.0
CB = (7, 6)  # (cols, rows) inner corners


def _gt_projector():
    R = ba._rodrigues(np.array([0.02, -0.06, 0.01]))
    T = np.array([-60.0, 3.0, 10.0])
    return R, T


def _view_poses():
    # Poses keep the whole board inside BOTH frustums (the projector is
    # 60 units to the left, so the board sits right of the world origin).
    rng = np.random.default_rng(7)
    poses = []
    while len(poses) < 8:
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-15, 8), rng.normal(-45, 8),
                         rng.normal(430, 30)])
        R = ba._rodrigues(rvec)
        # keep the board covered by both frustums (checked by the
        # coverage test below)
        cols, rows = CB
        corners = np.array([[-SQ, -SQ, 0], [cols * SQ, -SQ, 0],
                            [-SQ, rows * SQ, 0],
                            [cols * SQ, rows * SQ, 0]])
        Rp, Tp = _gt_projector()
        q = ((corners @ R.T + tvec) @ Rp.T + Tp) @ KP.T
        uv = q[:, :2] / q[:, 2:]
        qc = (corners @ R.T + tvec) @ KC.T
        uvc = qc[:, :2] / qc[:, 2:]
        if (uv[:, 0].min() > 2 and uv[:, 0].max() < PROJ_RES[0] - 2
                and uv[:, 1].min() > 2 and uv[:, 1].max() < PROJ_RES[1] - 2
                and uvc[:, 0].min() > 2 and uvc[:, 0].max() < CAM_RES[0] - 2
                and uvc[:, 1].min() > 2
                and uvc[:, 1].max() < CAM_RES[1] - 2):
            poses.append((R, tvec))
    return poses


def test_synthetic_geometry_is_covered():
    """Every board corner must land inside the projector image."""
    Rp, Tp = _gt_projector()
    cols, rows = CB
    xx, yy = np.meshgrid(np.arange(-1, cols + 1), np.arange(-1, rows + 1))
    objp = np.stack([xx.ravel() * SQ, yy.ravel() * SQ,
                     np.zeros(xx.size)], 1)
    for Rb, tb in _view_poses():
        Xc = objp @ Rb.T + tb
        q = (Xc @ Rp.T + Tp) @ KP.T
        uv = q[:, :2] / q[:, 2:]
        assert uv[:, 0].min() > 2 and uv[:, 0].max() < PROJ_RES[0] - 2
        assert uv[:, 1].min() > 2 and uv[:, 1].max() < PROJ_RES[1] - 2


def _board_geometry(Rb, tb, scale=1):
    """Per camera (sub)pixel: board plane intersection -> camera-frame
    point, board (x, y) coords, and hit mask. scale > 1 supersamples
    (subpixel i maps to pixel coordinate (i + 0.5)/scale - 0.5)."""
    w, h = CAM_RES
    xs = (np.arange(w * scale, dtype=float) + 0.5) / scale - 0.5
    ys = (np.arange(h * scale, dtype=float) + 0.5) / scale - 0.5
    xs, ys = np.meshgrid(xs, ys)
    p = np.stack([xs, ys, np.ones_like(xs)], -1)
    d = p @ np.linalg.inv(KC).T
    n = Rb[:, 2]
    s = (n @ tb) / (d @ n)
    Xc = s[..., None] * d
    Xb = (Xc - tb) @ Rb
    return Xc, Xb[..., 0], Xb[..., 1], s > 0


def _render_board(Rb, tb, scale=4):
    """Anti-aliased chessboard render (supersample + box filter); sharp
    binary edges would bias the subpixel corner refinement."""
    _, bx, by, ok = _board_geometry(Rb, tb, scale=scale)
    cols, rows = CB
    inside = ((bx > -SQ) & (bx < cols * SQ)
              & (by > -SQ) & (by < rows * SQ) & ok)
    parity = (np.floor(bx / SQ) + np.floor(by / SQ)) % 2 == 0
    img = np.where(inside & parity, 20.0, 235.0)
    img = img.reshape(CAM_RES[1], scale, CAM_RES[0], scale).mean((1, 3))
    return img.astype(np.uint8)


def _proj_pixel_of_cam(Rb, tb):
    """Projector pixel illuminating each camera pixel (via the board)."""
    Rp, Tp = _gt_projector()
    Xc, _, _, ok = _board_geometry(Rb, tb)
    q = (Xc @ Rp.T + Tp) @ KP.T
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2], ok


def _graycode_sets():
    pats, _, _ = graycode_patterns(PROJ_RES)
    sets = []
    for Rb, tb in _view_poses():
        pu, pv, ok = _proj_pixel_of_cam(Rb, tb)
        ui = np.round(pu).astype(int)
        vi = np.round(pv).astype(int)
        lit = ok & (ui >= 0) & (ui < PROJ_RES[0]) \
            & (vi >= 0) & (vi < PROJ_RES[1])
        uis = np.clip(ui, 0, PROJ_RES[0] - 1)
        vis = np.clip(vi, 0, PROJ_RES[1] - 1)
        caps = [np.where(lit, p[vis, uis], 0).astype(np.uint8)
                for p in pats]
        black = np.zeros(CAM_RES[::-1], np.uint8)
        white = np.where(lit, 255, 0).astype(np.uint8)
        normal = _render_board(Rb, tb)
        sets.append(caps + [black, normal, white])
    return sets


def _phaseshift_sets(periods):
    sets = []
    for Rb, tb in _view_poses():
        pu, pv, ok = _proj_pixel_of_cam(Rb, tb)
        imgs = []
        for v, coord in ((0, pu), (1, pv)):
            for T in periods[v]:
                for i in range(4):
                    th = 2 * np.pi * coord / T + i * np.pi / 2
                    imgs.append((127.5 * (1 + np.cos(th))))
        imgs.append(_render_board(Rb, tb).astype(float))
        sets.append(imgs)
    return sets


def _check_rig(rig, t_tol=3.0, r_tol=2e-2):
    Rp, Tp = _gt_projector()
    assert np.abs(np.asarray(rig.R) - Rp).max() < r_tol
    assert np.abs(np.asarray(rig.T).ravel() - Tp).max() < t_tol
    assert rig.reprojectionError < 1.0


def test_heterodyne_unwrap_math():
    x = np.linspace(0, 127, 500)
    T0, T1 = 128.0, 16.0
    theta0 = 2 * np.pi * x / T0            # absolute (coarse, noisy-free)
    theta1 = np.mod(2 * np.pi * x / T1, 2 * np.pi)
    out = heterodyne_unwrap(theta0 + 0.03, theta1, T0, T1)
    np.testing.assert_allclose(out, theta0, atol=1e-9)


def test_wrapped_phase_4step():
    th = np.linspace(0.1, 2 * np.pi - 0.1, 50)
    I = [np.cos(th + i * np.pi / 2) for i in range(4)]
    np.testing.assert_allclose(wrapped_phase_4step(*I), th, atol=1e-9)


@pytest.mark.slow
def test_chessboard_procam_recovers_geometry():
    rig = chessboardProCam(_graycode_sets(), PROJ_RES,
                           chessboardSize=CB, squareSize=SQ)
    # Gray-code quantization limits accuracy; pose must still be close.
    _check_rig(rig, t_tol=6.0, r_tol=2e-2)


@pytest.mark.slow
def test_chessboard_procam_white_recovers_geometry():
    rig = chessboardProCamWhite(_graycode_sets(), PROJ_RES,
                                chessboardSize=CB, squareSize=SQ)
    # ~15 white centers per view constrain the pose less tightly than the
    # 42 corners; T_z trades off against the projector focal length.
    _check_rig(rig, t_tol=20.0, r_tol=3e-2)


@pytest.mark.slow
def test_phase_shift_recovers_geometry():
    periods = [[256.0, 32.0], [192.0, 24.0]]
    rig = phaseShift(periods, PROJ_RES, _phaseshift_sets(periods),
                     chessboardSize=CB, squareSize=SQ)
    _check_rig(rig)


@pytest.mark.slow
def test_phase_shift_white_recovers_geometry():
    periods = [[256.0, 32.0], [192.0, 24.0]]
    rig = phaseShiftWhite(periods, PROJ_RES, _phaseshift_sets(periods),
                          chessboardSize=CB, squareSize=SQ, extended=True)
    rig, per_view = rig
    _check_rig(rig, t_tol=20.0, r_tol=3e-2)
    assert per_view.shape[1] == 2
