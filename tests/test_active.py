"""Structured light: patterns, stripe finder, Gray-code scan and FTP on
synthetic scenes with known geometry."""

import numpy as np
import pytest

import simplestereo_jax as ss
from simplestereo_jax.active import (
    graycode_patterns, graycode_num_bits, decode_graycode,
    buildFringe, buildBinaryFringe, buildAnaglyphFringe,
    findCentralStripe, computeROI, GrayCode, GrayCodeDouble, StereoFTP)


# --------------------------------------------------------------------------
# synthetic camera-projector scene
# --------------------------------------------------------------------------

CAM_RES = (128, 96)    # (width, height)
PROJ_RES = (128, 96)


def _make_rig():
    # T_z != 0 keeps the projector epipole finite (the FTP pipeline, like
    # the reference's, assumes a near-horizontal but not exactly parallel
    # camera-projector arrangement).
    K = np.array([[140., 0, 63.5], [0, 140., 47.5], [0, 0, 1]])
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix
    R = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
    T = np.array([[-40.], [1.0], [6.0]])
    return ss.StereoRig(CAM_RES, PROJ_RES, K, K, None, None, R, T)


def _proj_coords_for_plane(rig, z_plane, pixel_center=0.0):
    """Projector pixel hit by each camera pixel for a fronto plane."""
    w, h = rig.res1
    K1 = np.asarray(rig.intrinsic1, float)
    K2 = np.asarray(rig.intrinsic2, float)
    R = np.asarray(rig.R, float)
    T = np.asarray(rig.T, float).ravel()
    xs, ys = np.meshgrid(np.arange(w) + pixel_center,
                         np.arange(h) + pixel_center)
    p = np.stack([xs, ys, np.ones_like(xs)], -1)
    rays = p @ np.linalg.inv(K1).T
    P = z_plane * rays                       # camera-frame points (z = z0)
    q = (P @ R.T + T) @ K2.T
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2], P


def _capture(pattern, mapu, mapv):
    """Nearest-neighbor simulated camera capture of a projected pattern.

    Pixels whose ray misses the projector frustum receive no light."""
    h2, w2 = pattern.shape[:2]
    ui = np.round(mapu).astype(int)
    vi = np.round(mapv).astype(int)
    lit = (ui >= 0) & (ui < w2) & (vi >= 0) & (vi < h2)
    out = pattern[np.clip(vi, 0, h2 - 1), np.clip(ui, 0, w2 - 1)]
    return np.where(lit, out, 0).astype(pattern.dtype)


# --------------------------------------------------------------------------
# patterns
# --------------------------------------------------------------------------

def test_graycode_patterns_layout():
    pats, nx, ny = graycode_patterns((64, 32))
    assert nx == 6 and ny == 5
    assert pats.shape == (2 * (6 + 5), 32, 64)
    # each image is followed by its inverse
    assert (pats[0] + pats[1] == 255).all()
    # first pattern: vertical stripes (constant along y)
    assert (pats[0] == pats[0][0]).all()
    # later patterns: horizontal stripes (constant along x)
    assert (pats[-1] == pats[-1][:, :1]).all()


def test_graycode_decode_identity():
    """Feeding the patterns themselves as captures recovers pixel ids."""
    import jax.numpy as jnp
    pats, nx, ny = graycode_patterns((64, 32))
    px, py, valid = decode_graycode(jnp.asarray(pats), nx=nx, ny=ny)
    px, py, valid = map(np.asarray, (px, py, valid))
    assert valid.all()
    gx, gy = np.meshgrid(np.arange(64), np.arange(32))
    assert (px == gx).all() and (py == gy).all()


def test_graycode_decode_float_captures():
    """Float capture stacks (e.g. normalized to [0, 1]) must decode with
    their values preserved — quantizing them to uint8 would collapse
    [0, 1] to {0, 1} and silently return garbage (round-4 regression
    guard on _gray_host)."""
    rig = _make_rig()
    pats, nx, ny = graycode_patterns(rig.res2)
    mapu, mapv, _ = _proj_coords_for_plane(rig, 500.0)
    # identical scene, two encodings
    caps8 = [_capture(p, mapu, mapv) for p in pats]
    capsf = [c.astype(np.float32) / 255.0 for c in caps8]
    gc8 = GrayCode(rig, white_thr=5)
    gcf = GrayCode(rig, white_thr=5 / 255.0)
    px8, py8, v8 = gc8.decode(caps8)
    pxf, pyf, vf = gcf.decode(capsf)
    assert v8.any()
    np.testing.assert_array_equal(v8, vf)
    np.testing.assert_array_equal(px8[v8], pxf[vf])
    np.testing.assert_array_equal(py8[v8], pyf[vf])


def test_generate_graycode_imgs(tmp_path):
    n = ss.active.generateGrayCodeImgs(str(tmp_path), (32, 16))
    assert n == 2 * (5 + 4)
    files = {p.name for p in tmp_path.iterdir()}
    assert "0.png" in files and "black.png" in files and "white.png" in files


def test_build_fringe_shapes_and_stripe():
    f = buildFringe(16, dims=(128, 8))
    assert f.shape == (8, 128) and f.dtype == np.uint8
    assert f.max() == 255 and f.min() == 0
    fc = buildFringe(16, dims=(128, 8), stripeColor="red")
    assert fc.shape == (8, 128, 3)
    # inside the stripe only the red channel is nonzero
    peak = int(ss.active._getCentralPeak(128, 16))
    assert fc[0, peak, 2] > 0 and fc[0, peak, 0] == 0
    fv = buildFringe(16, dims=(128, 64), vertical=True)
    assert fv.shape == (64, 128)
    assert (fv == fv[:, :1]).all()  # constant along x

    fb = buildBinaryFringe(period=16, dims=(128, 8))
    assert set(np.unique(fb)) <= {0, 255}
    fa = buildAnaglyphFringe(period=16, dims=(128, 8))
    assert fa.shape == (8, 128, 3)
    # B and R are in antiphase: their sum is roughly constant
    s = fa[0, :, 0].astype(int) + fa[0, :, 2].astype(int)
    assert s.std() < 3


def test_find_central_stripe():
    img = np.zeros((20, 64, 3), np.uint8)
    img[:, 30, 2] = 200
    img[:, 31, 2] = 200
    out = findCentralStripe(img, "r")
    assert out.shape == (20, 2)
    np.testing.assert_allclose(out[:, 0], 30.5, atol=1e-6)
    assert findCentralStripe(np.zeros((4, 4, 3), np.uint8), "r") is None
    with pytest.raises(ValueError):
        findCentralStripe(img, "purple")


def test_compute_roi():
    img = np.zeros((60, 80), np.uint8)
    img[10:50, 20:70] = 200
    x, y, w, h = computeROI(img, blackThreshold=50)
    assert abs(x - 20) <= 2 and abs(y - 10) <= 2
    assert abs(w - 50) <= 4 and abs(h - 40) <= 4
    # extraMargin shrinks each side by that many pixels (reference
    # active.py:1689-1692)
    xm, ym, wm, hm = computeROI(img, blackThreshold=50, extraMargin=3)
    assert (xm, ym, wm, hm) == (x + 3, y + 3, w - 6, h - 6)
    # an absurd margin is clamped so the rectangle stays non-empty
    xg, yg, wg, hg = computeROI(img, blackThreshold=50, extraMargin=1000)
    assert wg > 0 and hg > 0
    assert xg >= x and yg >= y and xg + wg <= x + w and yg + hg <= y + h
    # negative margins do not silently expand the box
    assert computeROI(img, blackThreshold=50, extraMargin=-5) == \
        (x, y, w, h)


# --------------------------------------------------------------------------
# Gray-code scanning on a synthetic plane
# --------------------------------------------------------------------------

def test_graycode_cloud_recovers_plane():
    rig = _make_rig()
    z0 = 500.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    pats, nx, ny = graycode_patterns(PROJ_RES)
    captures = [_capture(p, mapu, mapv) for p in pats]

    gc = GrayCode(rig)
    assert gc.num_patterns == len(pats)
    pts = gc.getCloud(captures)
    pts = pts.reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    assert len(pts) > 0.5 * CAM_RES[0] * CAM_RES[1]
    # One projector pixel of disparity here is ~z0^2/(B*f) ~ 45 units of
    # depth, so integer Gray-code decode bounds the achievable accuracy.
    zerr = np.abs(pts[:, 2] - z0)
    quant = z0 * z0 / (40.0 * 140.0)
    assert np.median(zerr) < 0.5 * quant
    assert np.percentile(zerr, 90) < 3.0 * quant


def _cam_to_proj_map(Kc, Rc, Tc, Kp, Rp, Tp, res, z0):
    """Camera pixel -> projector pixel via the plane z=z0 (world frame)."""
    w, h = res
    xs, ys = np.meshgrid(np.arange(w, dtype=float),
                         np.arange(h, dtype=float))
    p = np.stack([xs, ys, np.ones_like(xs)], -1)
    d = p @ np.linalg.inv(Kc).T @ Rc          # ray dirs, world frame
    C = -(Rc.T @ Tc).ravel()                  # camera center, world frame
    t = (z0 - C[2]) / d[..., 2]
    P = C + t[..., None] * d
    q = (P @ Rp.T + Tp.ravel()) @ Kp.T
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]


def test_graycode_double_recovers_plane():
    rig = _make_rig()
    z0 = 500.0
    K1 = np.asarray(rig.intrinsic1, float)
    K2 = np.asarray(rig.intrinsic2, float)
    R = np.asarray(rig.R, float)
    T = np.asarray(rig.T, float)
    # Uncalibrated projector colocated with camera 1 (identity pose);
    # both calibrated cameras decode its patterns.
    I3, z3 = np.eye(3), np.zeros((3, 1))
    mapu1, mapv1 = _cam_to_proj_map(K1, I3, z3, K1, I3, z3, CAM_RES, z0)
    mapu2, mapv2 = _cam_to_proj_map(K2, R, T, K1, I3, z3, CAM_RES, z0)
    pats, _, _ = graycode_patterns(PROJ_RES)
    caps1 = [_capture(p, mapu1, mapv1) for p in pats]
    caps2 = [_capture(p, mapu2, mapv2) for p in pats]
    gd = GrayCodeDouble(rig, PROJ_RES)
    pts = gd.getCloud(caps1, caps2).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    assert len(pts) > 1000
    assert np.abs(np.median(pts[:, 2]) - z0) < 0.1 * z0


# --------------------------------------------------------------------------
# FTP on a synthetic plane
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ftp_scene():
    rig = _make_rig()
    period = 16.0
    fringe = buildFringe(period, dims=PROJ_RES, stripeColor="red")
    z0 = 520.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    # bilinear sample of the BGR fringe
    from simplestereo_jax import warp
    import jax.numpy as jnp
    cam_img = np.asarray(warp.remap(
        jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
        jnp.asarray(mapv, jnp.float32), interpolation="linear"))
    return dict(rig=rig, period=period, fringe=fringe, z0=z0,
                cam_img=cam_img)


def test_ftp_recovers_plane(ftp_scene):
    ftp = StereoFTP(ftp_scene["rig"], ftp_scene["fringe"],
                    ftp_scene["period"])
    cloud = ftp.getCloud(ftp_scene["cam_img"])
    assert cloud.shape == (CAM_RES[1], CAM_RES[0], 3)
    z = cloud[..., 2]
    z = z[np.isfinite(z)]
    assert len(z) > 0.8 * z.size or len(z) > 5000
    # the object IS the reference plane -> z should match everywhere
    center = cloud[20:-20, 20:-20, 2]
    center = center[np.isfinite(center)]
    assert abs(np.median(center) - ftp_scene["z0"]) < 0.02 * ftp_scene["z0"]
    assert np.percentile(np.abs(center - ftp_scene["z0"]), 80) \
        < 0.05 * ftp_scene["z0"]


def test_ftp_out_dtype_f16(ftp_scene):
    """out_dtype=np.float16 casts the cloud ON DEVICE (halving the
    device->host transfer, the fused path's largest cost on a remote
    link) — values must match the f64 path within f16 quantization."""
    ftp = StereoFTP(ftp_scene["rig"], ftp_scene["fringe"],
                    ftp_scene["period"])
    c64 = ftp.getCloud(ftp_scene["cam_img"])
    c16 = ftp.getCloud(ftp_scene["cam_img"], out_dtype=np.float16)
    assert c16.dtype == np.float16
    both = np.isfinite(c64[..., 2]) & np.isfinite(
        c16[..., 2].astype(np.float64))
    assert both.mean() > 0.95
    dz = np.abs(c64[..., 2] - c16[..., 2].astype(np.float64))[both]
    # f16 ulp at z ~ 520 is 0.5; allow 2 ulps
    assert dz.max() <= 1.0, dz.max()


def test_ftp_cloud_batch_matches_single(ftp_scene):
    """getCloudBatch (dense work of the whole stack in one device
    program) must match per-frame getCloud. vmap can change FFT batching
    and reduction order, so allow float-associativity slack."""
    ftp = StereoFTP(ftp_scene["rig"], ftp_scene["fringe"],
                    ftp_scene["period"])
    rng = np.random.default_rng(3)
    cam = ftp_scene["cam_img"]
    imgs = np.stack([
        cam,
        np.clip(cam.astype(np.int16)
                + rng.integers(-2, 3, cam.shape), 0, 255).astype(cam.dtype),
    ])
    batch = ftp.getCloudBatch(imgs)
    assert batch.shape == (2, CAM_RES[1], CAM_RES[0], 3)
    for b in range(2):
        single = ftp.getCloud(imgs[b])
        both = np.isfinite(single[..., 2]) & np.isfinite(batch[b, ..., 2])
        assert both.mean() > 0.95
        dz = np.abs(single[..., 2] - batch[b, ..., 2])[both]
        assert dz.max() < 1e-2, dz.max()

    with pytest.raises(ValueError):
        ftp.getCloudBatch(cam)  # not a stack

    from simplestereo_jax.active import StereoFTP_Mapping
    mapping = StereoFTP_Mapping(ftp_scene["rig"], ftp_scene["fringe"],
                                ftp_scene["period"])
    with pytest.raises(TypeError):
        # the classic no-virtual-reference pipeline must not silently
        # run the base fused pipeline (wrong geometry)
        mapping.getCloudBatch(imgs)


def test_ftp_cloud_batch_roi_matches_single(ftp_scene):
    """getCloudBatch with a non-trivial ROI: the batched preamble's crop
    and the per-frame stripe/carrier control plane must use the same
    roi_x/roi_y offset math as the single-frame path."""
    ftp = StereoFTP(ftp_scene["rig"], ftp_scene["fringe"],
                    ftp_scene["period"])
    cam = ftp_scene["cam_img"]
    roi = (6, 4, CAM_RES[0] - 14, CAM_RES[1] - 10)
    imgs = np.stack([cam, np.roll(cam, 1, axis=0)])
    batch = ftp.getCloudBatch(imgs, roi=roi)
    assert batch.shape == (2, roi[3], roi[2], 3)
    for b in range(2):
        single = ftp.getCloud(imgs[b], roi=roi)
        both = np.isfinite(single[..., 2]) & np.isfinite(batch[b, ..., 2])
        assert both.mean() > 0.95
        dz = np.abs(single[..., 2] - batch[b, ..., 2])[both]
        assert dz.max() < 1e-2, dz.max()


def test_ftp_rejects_gray_image(ftp_scene):
    ftp = StereoFTP(ftp_scene["rig"], ftp_scene["fringe"],
                    ftp_scene["period"])
    with pytest.raises(ValueError):
        ftp.getCloud(ftp_scene["cam_img"][:, :, 0])


def test_ftp_anaglyph_recovers_plane():
    from simplestereo_jax.active import StereoFTPAnaglyph
    from simplestereo_jax import warp
    import jax.numpy as jnp
    rig = _make_rig()
    period = 16.0
    fringe = buildAnaglyphFringe(period, dims=PROJ_RES)
    z0 = 520.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    cam_img = np.asarray(warp.remap(
        jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
        jnp.asarray(mapv, jnp.float32), interpolation="linear"))
    ftp = StereoFTPAnaglyph(rig, fringe, period, stripeColor="green")
    cloud = ftp.getCloud(cam_img)
    center = cloud[20:-20, 20:-20, 2]
    center = center[np.isfinite(center)]
    assert abs(np.median(center) - z0) < 0.03 * z0


def test_ftp_subclass_overriding_only_convertGrayscale():
    """The reference documents convertGrayscale as the customization
    point (its StereoFTPAnaglyph overrides exactly that). A downstream
    subclass overriding ONLY the host convertGrayscale must get its
    grayscale definition honored by the fused pipeline too."""
    from simplestereo_jax.active import StereoFTPAnaglyph
    from simplestereo_jax.active.ftp import StereoFTP
    from simplestereo_jax import warp
    import jax.numpy as jnp

    class UserAnaglyph(StereoFTP):
        # same math as StereoFTPAnaglyph.convertGrayscale, but declared
        # the way the reference's docs suggest: host-side only
        @staticmethod
        def convertGrayscale(img):
            img = np.asarray(img)
            if img.ndim == 2:
                return img.astype(np.float64)
            d = (img[:, :, 0].astype(np.float64)
                 - img[:, :, 2].astype(np.float64))
            ptp = np.ptp(d)
            return (d - d.min()) / (ptp if ptp > 0 else 1.0)

    rig = _make_rig()
    period = 16.0
    fringe = buildAnaglyphFringe(period, dims=PROJ_RES)
    z0 = 520.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    cam_img = np.asarray(warp.remap(
        jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
        jnp.asarray(mapv, jnp.float32), interpolation="linear"))

    builtin = StereoFTPAnaglyph(rig, fringe, period, stripeColor="green")
    user = UserAnaglyph(rig, fringe, period, stripeColor="green")
    assert user._customGrayscale() and not builtin._customGrayscale()
    c_builtin = builtin.getCloud(cam_img)
    c_user = user.getCloud(cam_img)
    s = np.s_[20:-20, 20:-20, 2]
    a, b = c_builtin[s], c_user[s]
    ok = np.isfinite(a) & np.isfinite(b)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(a[ok], b[ok], rtol=1e-3)


def test_ftp_mapping_variant(ftp_scene):
    from simplestereo_jax.active import StereoFTP_Mapping
    ftp = StereoFTP_Mapping(ftp_scene["rig"], ftp_scene["fringe"],
                            ftp_scene["period"])
    cloud = ftp.getCloud(ftp_scene["cam_img"])
    assert cloud.shape == (CAM_RES[1], CAM_RES[0], 3)
    center = cloud[30:-30, 30:-30, 2]
    center = center[np.isfinite(center)]
    # classic FTP (no virtual reference) is cruder; accept 10%
    assert abs(np.median(center) - ftp_scene["z0"]) < 0.1 * ftp_scene["z0"]


def test_ftp_debug_dump_and_plot(ftp_scene, tmp_path):
    """getCloud debug introspection (reference parity: the plot=True
    spectrum/phase windows, active.py:688-714): dump= fills a dict with
    the row-FFT spectra, wrapped/unwrapped phase, band edges and fringe
    order; plot=<path> saves the panels headlessly."""
    ftp = StereoFTP(ftp_scene["rig"], ftp_scene["fringe"],
                    ftp_scene["period"])
    W, H = CAM_RES
    dump = {}
    cloud = ftp.getCloud(ftp_scene["cam_img"], dump=dump)
    assert set(dump) >= {"spectrum", "spectrum_ref", "phase",
                         "phase_unwrapped", "fmin", "fmax", "k"}
    for key in ("spectrum", "spectrum_ref", "phase", "phase_unwrapped"):
        assert dump[key].shape == (H, W), key
    assert np.isfinite(dump["phase_unwrapped"]).all()
    assert np.abs(dump["phase"]).max() <= np.pi + 1e-5
    assert float(dump["k"]) == float(int(dump["k"]))  # integer fringe order
    # the carrier peak of the object spectrum lies inside the band
    row = H // 2
    freqs = np.fft.fftfreq(W)
    sp = dump["spectrum"][row].copy()
    sp[(freqs <= 0) | (freqs < 0.5 * dump["fmin"][row])] = 0  # drop DC
    f_peak = freqs[np.argmax(sp)]
    assert dump["fmin"][row] <= f_peak <= dump["fmax"][row]
    # instrumentation must not change the cloud
    plain = ftp.getCloud(ftp_scene["cam_img"])
    ok = np.isfinite(plain)
    assert (np.isfinite(cloud) == ok).all()
    np.testing.assert_allclose(cloud[ok], plain[ok], rtol=1e-5, atol=1e-3)
    # plot=<path> renders headlessly
    p = tmp_path / "ftp_debug.png"
    ftp.getCloud(ftp_scene["cam_img"], plot=str(p))
    assert p.exists() and p.stat().st_size > 0
    # the staged (custom unwrapping) path fills the same dump
    dump2 = {}
    ftp.getCloud(ftp_scene["cam_img"], dump=dump2,
                 unwrappingMethod=lambda ph: np.unwrap(
                     np.unwrap(ph, axis=1), axis=0))
    assert dump2["phase_unwrapped"].shape == (H, W)
    np.testing.assert_allclose(dump2["phase"], dump["phase"],
                               rtol=1e-4, atol=1e-4)
    # the Mapping variant exposes its object spectrum + phase too
    from simplestereo_jax.active import StereoFTP_Mapping
    ftpm = StereoFTP_Mapping(ftp_scene["rig"], ftp_scene["fringe"],
                             ftp_scene["period"])
    dump3 = {}
    ftpm.getCloud(ftp_scene["cam_img"], dump=dump3)
    assert dump3["spectrum"].shape == (H, W)
    assert dump3["phase_unwrapped"].shape == (H, W)


def test_ftp_phase_only(ftp_scene):
    from simplestereo_jax.active import StereoFTP_PhaseOnly
    ftp = StereoFTP_PhaseOnly(ftp_scene["rig"], ftp_scene["fringe"],
                              ftp_scene["period"])
    phase = ftp.getPhase(ftp_scene["cam_img"])
    assert phase.shape == (CAM_RES[1], CAM_RES[0])
    # object == reference plane -> phase difference ~ constant (~0)
    inner = phase[20:-20, 20:-20]
    assert np.nanstd(inner) < 0.5


def test_ftp_custom_unwrapping_method(ftp_scene):
    """The staged path with a host unwrapping callback must agree with
    the fused default path (same algorithm, different plumbing)."""
    ftp = StereoFTP(ftp_scene["rig"], ftp_scene["fringe"],
                    ftp_scene["period"])
    fused = np.asarray(ftp.getCloud(ftp_scene["cam_img"]))

    def unwrap_np(phase):
        return np.unwrap(np.unwrap(phase, axis=1), axis=0)

    staged = np.asarray(ftp.getCloud(ftp_scene["cam_img"],
                                     unwrappingMethod=unwrap_np))
    c = np.s_[20:-20, 20:-20, 2]
    a, b = fused[c], staged[c]
    ok = np.isfinite(a) & np.isfinite(b)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(a[ok], b[ok], rtol=5e-3)


def test_graycode_shadow_masking():
    """black_thr semantics (reference active.py:1143-1147): pixels whose
    white-black difference is under the threshold are shadowed (not
    reached by projector light) and must be rejected even when pattern
    noise passes the per-bit white threshold."""
    rig = _make_rig()
    z0 = 500.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    pats, nx, ny = graycode_patterns(PROJ_RES)
    rng = np.random.default_rng(3)
    W, H = CAM_RES
    sx = slice(30, 50)  # shadowed columns (ambient noise, no projector)
    captures = []
    for p in pats:
        c = _capture(p, mapu, mapv)
        # ambient flicker in the shadow: exceeds white_thr randomly so
        # the per-bit check alone cannot reject it
        c[:, sx] = rng.integers(0, 120, (H, 20), np.uint8)
        captures.append(c)
    white = _capture(np.full(PROJ_RES[::-1], 255, np.uint8), mapu, mapv)
    black = _capture(np.zeros(PROJ_RES[::-1], np.uint8), mapu, mapv)
    white[:, sx] = 60   # ambient level only, no projector light
    black[:, sx] = 55

    gc = GrayCode(rig, black_thr=40, white_thr=5)
    _, _, v_nomask = gc.decode(captures)
    _, _, v_mask = gc.decode(captures, black=black, white=white)
    # noise leaks through the per-bit threshold somewhere in the shadow
    assert v_nomask[:, sx].any()
    # the shadow mask rejects the whole region and keeps the lit part
    assert not v_mask[:, sx].any()
    outside = np.ones_like(v_mask)
    outside[:, sx] = False
    assert (v_mask & outside).sum() >= 0.9 * (v_nomask & outside).sum()

    # getCloud plumbs the masks through: no 3D points from shadow pixels
    pts = gc.getCloud(captures, black=black, white=white)
    assert len(pts) > 0
    # reproject: all returned points must come from lit camera columns
    K1 = np.asarray(rig.intrinsic1, float)
    p = pts.reshape(-1, 3) @ K1.T
    xs = p[:, 0] / p[:, 2]
    # depth quantization shifts reprojected columns by ~1 px
    assert ((xs < 29.0) | (xs > 50.0)).mean() > 0.98


def test_ftp_subclass_overriding_only_device_grayscale():
    """A subclass overriding ONLY convertGrayscaleDevice (without a
    matching _GRAY_MODE) must have it honored by the fused path instead
    of silently falling back to the base max-channel mode."""
    from simplestereo_jax.active import StereoFTPAnaglyph
    from simplestereo_jax.active.ftp import StereoFTP
    from simplestereo_jax import warp
    import jax.numpy as jnp

    class UserDeviceAnaglyph(StereoFTP):
        @staticmethod
        def convertGrayscaleDevice(img):
            if img.ndim == 2:
                return img.astype(jnp.float32)
            d = (img[:, :, 0].astype(jnp.float32)
                 - img[:, :, 2].astype(jnp.float32))
            ptp = jnp.ptp(d)
            return (d - jnp.min(d)) / jnp.where(ptp > 0, ptp, 1.0)

    rig = _make_rig()
    period = 16.0
    fringe = buildAnaglyphFringe(period, dims=PROJ_RES)
    z0 = 520.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    cam_img = np.asarray(warp.remap(
        jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
        jnp.asarray(mapv, jnp.float32), interpolation="linear"))

    builtin = StereoFTPAnaglyph(rig, fringe, period, stripeColor="green")
    user = UserDeviceAnaglyph(rig, fringe, period, stripeColor="green")
    assert user._grayscale_plan() == "device"
    assert builtin._grayscale_plan() == "mode"
    c_builtin = builtin.getCloud(cam_img)
    c_user = user.getCloud(cam_img)
    s = np.s_[20:-20, 20:-20, 2]
    a, b = c_builtin[s], c_user[s]
    ok = np.isfinite(a) & np.isfinite(b)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(a[ok], b[ok], rtol=1e-3)


# --------------------------------------------------------------------------
# FTP geometry fuzz
# --------------------------------------------------------------------------

def test_ftp_random_geometries(rng):
    """Property fuzz: FTP must recover plane depth across randomized
    plausible camera-projector geometries (focal lengths, relative pose,
    fringe period, plane distance), not just the one fixture scene —
    the epipole position and carrier-frequency math are the fragile
    spots."""
    from simplestereo_jax import warp
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix
    import jax.numpy as jnp

    for trial in range(4):
        f = rng.uniform(120, 180)
        K = np.array([[f, 0, 63.5], [0, f, 47.5], [0, 0, 1]])
        R = rodrigues_to_matrix(np.array([rng.normal(0, 0.01),
                                          rng.normal(-0.05, 0.02),
                                          rng.normal(0, 0.01)]))
        T = np.array([[-rng.uniform(25, 55)],
                      [rng.normal(1, 0.5)],
                      [rng.uniform(4, 9)]])
        rig = ss.StereoRig(CAM_RES, PROJ_RES, K, K, None, None, R, T)
        period = float(rng.choice([12.0, 16.0, 20.0]))
        z0 = rng.uniform(400, 700)
        fringe = buildFringe(period, dims=PROJ_RES, stripeColor="red")
        mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
        cam_img = np.asarray(warp.remap(
            jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
            jnp.asarray(mapv, jnp.float32), interpolation="linear"))

        ftp = StereoFTP(rig, fringe, period)
        cloud = ftp.getCloud(cam_img)
        center = cloud[20:-20, 20:-20, 2]
        center = center[np.isfinite(center)]
        assert center.size > 2000, f"trial {trial}: too few points"
        err = abs(np.median(center) - z0) / z0
        assert err < 0.03, f"trial {trial}: median z err {err:.3%}"


def test_graycode_random_geometries(rng):
    """Property fuzz: Gray-code scanning recovers plane depth across
    randomized rig geometries (cf. the FTP fuzz; the re-distortion
    triangulation and rectifying transforms are shared fragile spots)."""
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix

    pats, nx, ny = graycode_patterns(PROJ_RES)
    for trial in range(3):
        f = rng.uniform(120, 180)
        K = np.array([[f, 0, 63.5], [0, f, 47.5], [0, 0, 1]])
        R = rodrigues_to_matrix(np.array([rng.normal(0, 0.01),
                                          rng.normal(-0.05, 0.02),
                                          rng.normal(0, 0.01)]))
        B = rng.uniform(30, 55)
        T = np.array([[-B], [rng.normal(1, 0.5)], [rng.uniform(4, 9)]])
        rig = ss.StereoRig(CAM_RES, PROJ_RES, K, K, None, None, R, T)
        z0 = rng.uniform(400, 650)
        mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
        captures = [_capture(p, mapu, mapv) for p in pats]
        pts = GrayCode(rig).getCloud(captures).reshape(-1, 3)
        pts = pts[np.isfinite(pts).all(axis=1)]
        assert len(pts) > 0.4 * CAM_RES[0] * CAM_RES[1], f"trial {trial}"
        quant = z0 * z0 / (B * f)   # depth per projector-pixel disparity
        zerr = np.abs(pts[:, 2] - z0)
        assert np.median(zerr) < 0.5 * quant, f"trial {trial}"


def test_graycode_float_black_threshold_not_truncated():
    """Review regression: a float black_thr (e.g. 40.5) must be honored
    by the shadow mask, not silently truncated to int (a white-black
    difference of 40.3 must stay shadowed)."""
    rig = _make_rig()
    gc = GrayCode(rig, black_thr=40.5)
    pats, nx, ny = graycode_patterns(rig.res2)
    caps = [p for p in pats]
    h, w = pats.shape[1:]
    black = np.zeros((h, w), np.float32)
    white = np.full((h, w), 40.3, np.float32)
    _, _, valid = gc.decode([c.astype(np.float32) for c in caps],
                            black=black, white=white)
    assert not valid.any()  # 40.3 > 40.5 is False everywhere
    white2 = np.full((h, w), 40.7, np.float32)
    _, _, valid2 = gc.decode([c.astype(np.float32) for c in caps],
                             black=black, white=white2)
    assert valid2.all()
