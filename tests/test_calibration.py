"""Calibration: synthetic BA recovery, chessboard detection on the
reference's committed calibration suite, helpers."""

import numpy as np
import pytest

import simplestereo_jax as ss
from simplestereo_jax.calibration import ba


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(1)
    K = np.array([[800., 0, 640], [0, 790, 360], [0, 0, 1]])
    dist = np.array([-0.12, 0.03, 0.001, -0.0005, 0.01])
    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 30., yy.ravel() * 30., np.zeros(42)], 1)
    views, imgs = [], []
    for _ in range(10):
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-90, 30), rng.normal(-75, 30),
                         rng.normal(600, 100)])
        pts = ba.project_points(obj, rvec, tvec, K[0, 0], K[1, 1],
                                K[0, 2], K[1, 2], dist)
        views.append((rvec, tvec))
        imgs.append(pts + rng.normal(0, 0.05, pts.shape))
    return dict(K=K, dist=dist, obj=obj, views=views, imgs=imgs, rng=rng)


def test_rodrigues_roundtrip(rng):
    for _ in range(20):
        r = rng.normal(0, 1, 3)
        R = ba._rodrigues(r)
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-12)
        assert np.allclose(ba._rodrigues_inv(R), r, atol=1e-9)


def test_complex_step_jacobian_matches_fd():
    def f(x):
        return np.array([x[0] ** 2 * x[1], np.sin(x[0]) + x[1] ** 3])

    x = np.array([0.7, -1.3])
    J = ba.complex_step_jacobian(f, x)
    expected = np.array([[2 * x[0] * x[1], x[0] ** 2],
                         [np.cos(x[0]), 3 * x[1] ** 2]])
    assert np.allclose(J, expected, rtol=1e-12)


def test_single_camera_calibration_recovers(synth):
    rms, K, dist, rv, tv = ba.calibrate_camera(
        [synth["obj"]] * len(synth["imgs"]), synth["imgs"], (1280, 720))
    assert rms < 0.12
    assert np.abs(K - synth["K"]).max() < 5.0
    assert np.abs(dist[:2] - synth["dist"][:2]).max() < 0.05


def test_stereo_calibration_recovers(synth):
    rng = synth["rng"]
    Rrel = ba._rodrigues(np.array([0.01, -0.03, 0.005]))
    Trel = np.array([-120., 2., 3.])
    K2 = np.array([[810., 0, 630], [0, 805, 355], [0, 0, 1]])
    dist2 = np.array([-0.10, 0.02, -0.0005, 0.001, 0.0])
    imgs2 = []
    for (rvec, tvec) in synth["views"]:
        R1 = ba._rodrigues(rvec)
        pts = ba.project_points(
            synth["obj"], Rrel @ R1, Rrel @ tvec + Trel,
            K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2], dist2)
        imgs2.append(pts + rng.normal(0, 0.05, pts.shape))
    rms, K1e, d1e, K2e, d2e, R, T, E, F, pve = ba.stereo_calibrate(
        [synth["obj"]] * len(synth["imgs"]), synth["imgs"], imgs2,
        (1280, 720))
    assert rms < 0.12
    assert np.abs(R - Rrel).max() < 2e-3
    assert np.abs(T.ravel() - Trel).max() < 0.5
    assert pve.shape == (len(synth["imgs"]), 2)
    # E must equal [T]x R (up to scale) for the returned extrinsics
    t = np.asarray(T, np.float64).ravel()
    Tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_expected = Tx @ R
    En = E / np.linalg.norm(E)
    Ee = E_expected / np.linalg.norm(E_expected)
    assert min(np.abs(En - Ee).max(), np.abs(En + Ee).max()) < 1e-9
    # epipolar constraint x2^T F x1 = 0 on noise-free (ideal pinhole)
    # correspondences generated from the returned K1, K2, R, T
    rng2 = np.random.default_rng(7)
    X = np.stack([rng2.uniform(-200, 200, 64), rng2.uniform(-150, 150, 64),
                  rng2.uniform(400, 900, 64)], axis=1)
    x1h = (K1e @ X.T).T
    x1h /= x1h[:, 2:]
    x2h = (K2e @ (X @ R.T + T.ravel()).T).T
    x2h /= x2h[:, 2:]
    resid = np.abs(np.einsum("ni,ij,nj->n", x2h, F, x1h))
    # normalize by the epipolar line magnitude for a pixel-scale residual
    lines = x1h @ F.T
    resid /= np.linalg.norm(lines[:, :2], axis=1)
    assert resid.max() < 1e-6


def test_distortion_flag_counts():
    with pytest.raises(ValueError):
        ba.calibrate_camera([np.zeros((4, 3))], [np.zeros((4, 2))],
                            (10, 10), num_coeffs=3)


def test_chessboard_detection_real_pair(ref_res):
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.calibration import find_chessboard_corners
    gl = imread(str(ref_res / "1" / "calib" / "0_L.png"), grayscale=True)
    gr = imread(str(ref_res / "1" / "calib" / "0_R.png"), grayscale=True)
    fl, cl = find_chessboard_corners(gl, (7, 6))
    fr, cr = find_chessboard_corners(gr, (7, 6))
    assert fl and fr
    assert cl.shape == cr.shape == (42, 2)
    # row-major ordering: consecutive corners in a row are ~60px apart
    step = np.linalg.norm(cl[1] - cl[0])
    assert 20 < step < 150
    # col/row directions are roughly orthogonal
    v_col = cl[1] - cl[0]
    v_row = cl[7] - cl[0]
    cosang = abs(v_col @ v_row) / (
        np.linalg.norm(v_col) * np.linalg.norm(v_row))
    assert cosang < 0.3
    # both views order the same physical corners (same directions)
    assert v_col @ (cr[1] - cr[0]) > 0
    assert v_row @ (cr[7] - cr[0]) > 0


def test_generate_chessboard_svg(tmp_path):
    p = tmp_path / "board.svg"
    ss.calibration.generateChessboardSVG((7, 6), str(p))
    s = p.read_text()
    assert s.startswith("<?xml") and "svg" in s
    # (7+1)x(6+1) squares, half of them black
    assert s.count('fill="#000"') == (8 * 7 + 1) // 2


def test_fundamental_from_projections(rig2):
    P1, P2 = rig2.getProjectionMatrices()
    F = ss.calibration.getFundamentalMatrixFromProjections(
        np.asarray(P1), np.asarray(P2))
    Fr = np.asarray(rig2.getFundamentalMatrix())
    # same up to scale
    F = F / np.linalg.norm(F)
    Fr = Fr / np.linalg.norm(Fr)
    if np.sign(F[2, 2]) != np.sign(Fr[2, 2]):
        F = -F
    assert np.abs(F - Fr).max() < 1e-8


@pytest.mark.slow
def test_full_suite_golden_parity(ref_res):
    """30-pair stereo calibration within tolerance of the committed rig."""
    import json
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.calibration import find_chessboard_corners

    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 60.5, yy.ravel() * 60.5, np.zeros(42)], 1)
    objs, im1, im2 = [], [], []
    for i in range(30):
        gl = imread(str(ref_res / "1" / "calib" / f"{i}_L.png"),
                    grayscale=True)
        gr = imread(str(ref_res / "1" / "calib" / f"{i}_R.png"),
                    grayscale=True)
        fl, cl = find_chessboard_corners(gl, (7, 6))
        fr, cr = find_chessboard_corners(gr, (7, 6))
        if fl and fr:
            objs.append(obj)
            im1.append(cl)
            im2.append(cr)
    assert len(objs) >= 28
    rms, K1, d1, K2, d2, R, T, E, F, _ = ba.stereo_calibrate(
        objs, im1, im2, (1280, 720))
    gold = json.load(open(ref_res / "1" / "rig.json"))
    assert rms < gold["reprojectionError"] * 1.1
    assert np.abs(K1 - np.array(gold["intrinsic1"])).max() < 10
    assert np.abs(R - np.array(gold["R"])).max() < 1e-3
    assert np.abs(T - np.array(gold["T"])).max() < 1.0


@pytest.mark.slow
def test_full_suite_golden_parity_res2(ref_res):
    """Second committed golden rig: the 37-pair res/2 suite. All pairs
    must detect and the calibration must land on the reference's
    committed rig.json (measured: RMS 0.211 vs golden 0.207, K1 within
    1.5 px, R within 4e-4, T within 0.04 mm)."""
    import json
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.calibration import find_chessboard_corners

    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 60.5, yy.ravel() * 60.5, np.zeros(42)], 1)
    objs, im1, im2 = [], [], []
    for i in range(37):
        gl = imread(str(ref_res / "2" / "calib" / f"{i}_L.png"),
                    grayscale=True)
        gr = imread(str(ref_res / "2" / "calib" / f"{i}_R.png"),
                    grayscale=True)
        fl, cl = find_chessboard_corners(gl, (7, 6))
        fr, cr = find_chessboard_corners(gr, (7, 6))
        if fl and fr:
            objs.append(obj)
            im1.append(cl)
            im2.append(cr)
    assert len(objs) == 37
    rms, K1, d1, K2, d2, R, T, E, F, _ = ba.stereo_calibrate(
        objs, im1, im2, (1280, 720))
    gold = json.load(open(ref_res / "2" / "rig.json"))
    assert rms < gold["reprojectionError"] * 1.1
    assert np.abs(K1 - np.array(gold["intrinsic1"])).max() < 10
    assert np.abs(R - np.array(gold["R"])).max() < 1e-3
    assert np.abs(T - np.array(gold["T"])).max() < 1.0


def test_sharded_ba_matches_truth(synth):
    """Distributed Schur-complement GN on the 8-device mesh."""
    from simplestereo_jax.calibration.sharded import calibrate_camera_sharded
    from simplestereo_jax import parallel

    V = 16
    rng = synth["rng"]
    obj = synth["obj"]
    K, dist = synth["K"], synth["dist"]
    imgs = []
    for _ in range(V):
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-90, 30), rng.normal(-75, 30),
                         rng.normal(600, 100)])
        pts = ba.project_points(obj, rvec, tvec, K[0, 0], K[1, 1],
                                K[0, 2], K[1, 2], dist)
        imgs.append(pts + rng.normal(0, 0.1, pts.shape))
    mesh = parallel.make_mesh({"views": 8})
    Hs = [ba._homography_dlt(obj[:, :2], i) for i in imgs[:6]]
    fx, fy, cx, cy = ba._zhang_intrinsics(Hs, (1280, 720))
    K0 = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    rms, Ke, de, poses = calibrate_camera_sharded(
        np.tile(obj[None], (V, 1, 1)), np.stack(imgs), K0, np.zeros(5),
        mesh, axis="views", iterations=25)
    assert rms < 0.25
    assert np.abs(Ke - K).max() < 5.0
    assert poses.shape == (V, 6)

    with pytest.raises(ValueError):
        calibrate_camera_sharded(
            np.tile(obj[None], (3, 1, 1)), np.stack(imgs[:3]), K0,
            np.zeros(5), mesh, axis="views")


@pytest.mark.slow
def test_chessboard_detection_other_suites(ref_res):
    """Robustness on the reference's second real 1280x720 calibration
    suite (res/2/calib: 37 pairs — res/1 is covered by the golden-parity
    test) AND no false positives on non-board scenes: res/new holds
    example-002's arbitrary capture dumps (indoor scene shots, no
    chessboard) — the detector must reject every one, not hallucinate a
    lattice."""
    import glob
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.calibration.chessboard import \
        find_chessboard_corners

    files = sorted(glob.glob(str(ref_res / "2/calib" / "*_L.png")))[:8]
    assert files
    found = 0
    for f in files:
        ok, corners = find_chessboard_corners(
            imread(f, grayscale=True), (7, 6))
        if ok:
            assert corners.shape == (42, 2)
            found += 1
    assert found == len(files), f"2/calib: {found}/{len(files)}"

    scenes = sorted(glob.glob(str(ref_res / "new" / "*_L.png")))[:8]
    assert scenes
    false_pos = sum(
        find_chessboard_corners(imread(f, grayscale=True), (7, 6))[0]
        for f in scenes)
    assert false_pos == 0, f"new (no boards): {false_pos} false positives"
