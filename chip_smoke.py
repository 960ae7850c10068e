"""Compiled smoke run of the stereo pipeline on a GPU.

Drives the main path once through the public entry points, at the
deployment sizes users run (1280x720 rectified pairs and structured-light
captures), on seeded scenes of known geometry, and checks every phase
against its reference:

  (a) device       the platform must be ``gpu``
  (b) rectify      directRectify + rectifyImages; maps vs a float64 numpy
                   build within 0.01 px
  (c) ASW          the GPU kernel vs the XLA form (<= 1 % of pixels
                   differ, each a near-tie) and bad-2.0 on the known scene;
                   also step=2, subpixel and computeBatch; both forms
                   timed at 384x288, 1280x720 and a batch of 8 at 384x288
  (d) SGM          D=128, census and BT, and computeBatch: bad-2.0
  (e) GSW          sd, normalize and mi at the tuned point: bad-2.0
  (f) points       get3DPoints -> exportPLY -> importPLY round trip
  (g) FTP          getCloud and getCloudBatch: depth error on a plane
  (h) Gray code    getCloud: depth error on a plane

Each phase prints one record line (its second-call wall time, the
tolerance it used, the card's name and power limit); the last line is
the JSON result. Any failure raises, so the exit code is non-zero and no
result line is printed. Without a GPU the script stops before any phase.

Usage:
    python chip_smoke.py                # every phase, one card
    python chip_smoke.py --four-cards   # only the sharded paths, 4 cards
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

W, H = 1280, 720


def _card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _twice(fn):
    """Run ``fn`` twice (the first call compiles); return the second
    call's result, fully read back, and its wall time in seconds."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _record(card, phase, seconds, tol, **extra):
    fields = " ".join(f"{k}={v}" for k, v in extra.items())
    print(f"[{phase}] second_call_s={seconds:.6f} tol={tol} {fields} "
          f"card={card}", flush=True)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _bad2(disp, gt, mask, scale=1.0):
    from simplestereo_jax.evaluation import evaluate_disparity

    return evaluate_disparity(np.asarray(disp), gt, mask,
                              bad_thresholds=(2.0,),
                              disp_scale=scale)["bad2"]


def _stereo_rig(size, seed):
    """A plausible seeded rig with lens distortion on both cameras."""
    import simplestereo_jax as ss
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix

    rng = np.random.default_rng(seed)
    w, h = size
    f = 1.1 * w
    K1 = np.array([[f, 0, w / 2 + 8], [0, f, h / 2 - 5], [0, 0, 1.0]])
    K2 = np.array([[1.02 * f, 0, w / 2 - 6], [0, 1.02 * f, h / 2 + 4],
                   [0, 0, 1.0]])
    R = rodrigues_to_matrix(rng.normal(0, 0.03, 3))
    T = np.array([[-120.0], [2.0], [-3.0]])
    d1 = np.array([-0.12, 0.05, 0.001, -0.0005, 0.0])
    d2 = np.array([-0.10, 0.04, -0.0008, 0.0006, 0.0])
    return ss.StereoRig(size, size, K1, K2, d1, d2, R, T)


def _np_rectify_map(K, dist, R, newK, size):
    """float64 numpy twin of ``warp.init_undistort_rectify_map``."""
    from simplestereo_jax.geometry import npgeom

    w, h = size
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    p = np.stack([uu, vv, np.ones_like(uu)], -1) @ np.linalg.inv(
        np.asarray(newK) @ np.asarray(R)).T
    d = npgeom.distort_normalized(p[..., :2] / p[..., 2:3], dist)
    K = np.asarray(K)
    return (K[0, 0] * d[..., 0] + K[0, 1] * d[..., 1] + K[0, 2],
            K[1, 1] * d[..., 1] + K[1, 2])


def phase_rectify(card, scene, size=(W, H), seed=0):
    """(b): returns the rectified rig (its Q matrix serves phase f)."""
    import simplestereo_jax as ss

    rig = _stereo_rig(size, seed)
    rect = ss.rectification.directRectify(rig)
    rect.computeRectificationMaps()
    err = 0.0
    for K, dist, R, newK, mx, my in (
            (rect.intrinsic1, rect.distCoeffs1, rect.Rcommon, rect.K1,
             rect.mapx1, rect.mapy1),
            (rect.intrinsic2, rect.distCoeffs2, rect.Rcommon @ rect.R.T,
             rect.K2, rect.mapx2, rect.mapy2)):
        rx, ry = _np_rectify_map(K, dist, R, newK, size)
        inside = (rx >= 0) & (rx <= size[0] - 1) & (ry >= 0) \
            & (ry <= size[1] - 1)
        _check(inside.mean() > 0.5, "rectified view mostly off-image")
        err = max(err, float(np.abs(np.asarray(mx) - rx)[inside].max()),
                  float(np.abs(np.asarray(my) - ry)[inside].max()))
    _check(err < 0.01, f"rectification maps off by {err} px")
    left, right = scene[0], scene[1]
    (r1, r2), dt = _twice(lambda: rect.rectifyImages(left, right))
    _check(r1.shape == left.shape and r2.dtype == np.uint8,
           "rectifyImages output")
    _record(card, "b rectify", dt, "0.01px", map_err_px=f"{err:.2e}")
    return rect


def phase_asw(card, scene, batch=4):
    """(c): returns the ASW disparity of the scene (for phase f)."""
    import jax.numpy as jnp
    from simplestereo_jax.passive import StereoASW, asw

    left, right, gt, nonocc = scene
    kw = dict(winSize=35, minDisparity=4, maxDisparity=14, gammaC=15,
              consistent=True)
    m = StereoASW(**kw)
    disp, dt = _twice(lambda: m.compute(left, right))
    jkw = dict(win_size=35, min_disp=4, max_disp=14, step=1, context=False)
    gc, gp = jnp.float32(15.0), jnp.float32(17.5)
    L, R = jnp.asarray(left)[None], jnp.asarray(right)[None]

    def xla(step=1, subpixel=False):
        return np.asarray(asw._asw_disparity_jit(
            L, R, None, gc, gp, consistent=True, engine="xla",
            subpixel=subpixel, **dict(jkw, step=step)))[0]

    ref, dt_xla = _twice(xla)
    differ = float((disp != ref).mean())
    _check(differ <= 0.01, f"ASW kernel vs XLA form: {differ:.2%} differ")
    # every WTA disagreement of the two cost volumes must be a near-tie
    ck, cx = (np.asarray(asw._cost_jit(L, R, None, gc, gp, engine=e,
                                       **jkw))[0] for e in ("pallas", "xla"))
    xs = np.arange(left.shape[1])
    ds = np.arange(ck.shape[0])[:, None, None] + 4
    ok = xs >= ds
    ck, cx = np.where(ok, ck, np.inf), np.where(ok, cx, np.inf)
    wk, wx = ck.argmin(0), cx.argmin(0)
    sel = wk != wx
    cx_k = np.take_along_axis(cx, wk[None], 0)[0][sel]
    cx_x = np.take_along_axis(cx, wx[None], 0)[0][sel]
    gap = float(((cx_k - cx_x) / cx_x).max(initial=0.0))
    _check(gap < 1e-5, f"ASW WTA disagreement is no near-tie: gap {gap}")
    fin = np.isfinite(cx)
    rel = float((np.abs(ck[fin] - cx[fin]) / cx[fin]).max())
    bad = _bad2(disp, gt, nonocc)
    _check(bad < 0.10, f"ASW bad-2.0 {bad:.2%}")
    _record(card, "c asw", dt, "differ<=1%,gap<1e-5,bad2<10%",
            xla_s=f"{dt_xla:.6f}", differ=f"{differ:.5f}",
            wta_gap=f"{gap:.2e}", cost_rel=f"{rel:.2e}", bad2=f"{bad:.4f}")

    m2 = StereoASW(step=2, **kw)
    d2, dt2 = _twice(lambda: m2.compute(left, right))
    differ2 = float((d2 != xla(step=2)).mean())
    bad2 = _bad2(d2, gt, nonocc)
    _check(differ2 <= 0.01 and bad2 < 0.10,
           f"ASW step=2: {differ2:.2%} differ, bad-2.0 {bad2:.2%}")
    _record(card, "c asw step2", dt2, "differ<=1%,bad2<10%",
            differ=f"{differ2:.5f}", bad2=f"{bad2:.4f}")

    ms = StereoASW(subpixel=True, **kw)
    dsub, dts = _twice(lambda: ms.compute(left, right))
    _check(dsub.dtype == np.float32
           and np.abs(dsub - disp).max() <= 0.5 + 1e-6,
           "ASW subpixel strays from the integer map")
    far = float((np.abs(dsub - xla(subpixel=True)) > 1e-3).mean())
    _check(far <= 0.01, f"ASW subpixel vs XLA form: {far:.2%} differ")
    _record(card, "c asw subpixel", dts, "differ<=1%", differ=f"{far:.5f}")

    rng = np.random.default_rng(1)
    shifts = rng.integers(0, 40, batch)
    ls = np.stack([np.roll(left, s, axis=0) for s in shifts])
    rs = np.stack([np.roll(right, s, axis=0) for s in shifts])
    db, dtb = _twice(lambda: m.computeBatch(ls, rs))
    for i in range(batch):
        _check(np.array_equal(db[i], m.compute(ls[i], rs[i])),
               "ASW computeBatch differs from compute")
    _record(card, f"c asw batch{batch}", dtb, "bit-exact vs compute")
    return disp


def phase_asw_engines(card, reps=10):
    """(c), timings: the kernel and the XLA form, each one jitted program
    end to end (planes, cost volume, consistency check, occlusion fill),
    on device-resident inputs; median of ``reps`` calls after the first."""
    import jax
    import jax.numpy as jnp
    from simplestereo_jax.evaluation import layered_scene
    from simplestereo_jax.passive import asw

    kw = dict(win_size=35, min_disp=4, max_disp=14, consistent=True, step=1,
              subpixel=False, context=False)
    gc, gp = jnp.float32(15.0), jnp.float32(17.5)
    for h, w, b in ((288, 384, 1), (H, W, 1), (288, 384, 8)):
        scenes = [layered_scene(h, w, seed=s) for s in range(b)]
        L = jax.device_put(np.stack([s[0] for s in scenes]))
        R = jax.device_put(np.stack([s[1] for s in scenes]))
        outs, ms = {}, {}
        for engine in ("pallas", "xla"):
            def run():
                return asw._asw_disparity_jit(L, R, None, gc, gp,
                                              engine=engine, **kw)
            outs[engine] = np.asarray(jax.block_until_ready(run()))
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(run())
                ts.append(time.perf_counter() - t0)
            ms[engine] = float(np.median(ts)) * 1e3
        differ = float((outs["pallas"] != outs["xla"]).mean())
        _check(differ <= 0.01, f"ASW {b}x{w}x{h}: {differ:.2%} differ")
        _record(card, f"c asw engines {b}x{w}x{h}", ms["pallas"] / 1e3,
                "differ<=1%", kernel_ms=f"{ms['pallas']:.3f}",
                xla_ms=f"{ms['xla']:.3f}", reps=reps, differ=f"{differ:.5f}")


def phase_sgm(card, scene, num_disp=128, batch=4):
    """(d)"""
    from simplestereo_jax.passive import StereoSGM

    left, right, gt, nonocc = scene
    for name, kw in (
            ("census", dict(P1=120, P2=480, costMethod="census",
                            censusWindow=7)),
            ("bt", dict(P1=36, P2=144, preFilterCap=15))):
        m = StereoSGM(minDisparity=0, numDisparities=num_disp, blockSize=3,
                      uniquenessRatio=0, **kw)
        d, dt = _twice(lambda: m.compute(left, right))
        bad = _bad2(d, gt, nonocc, scale=1 / 16.0)
        _check(bad < 0.10, f"SGM {name} bad-2.0 {bad:.2%}")
        _record(card, f"d sgm {name}", dt, "bad2<10%", bad2=f"{bad:.4f}")
    ls = np.stack([left] * batch)
    rs = np.stack([right] * batch)
    db, dtb = _twice(lambda: m.computeBatch(ls, rs))
    _check(all(np.array_equal(x, d) for x in db),
           "SGM computeBatch differs from compute")
    _record(card, f"d sgm batch{batch}", dtb, "bit-exact vs compute")


def phase_gsw(card, scene):
    """(e)"""
    from simplestereo_jax.passive import StereoGSW

    left, right, gt, nonocc = scene
    kw = dict(winSize=23, minDisparity=4, maxDisparity=14, gamma=12.5,
              fMax=20, consistent=True)
    for name, extra in (("sd", {}), ("normalize", dict(normalize=True)),
                        ("mi", dict(costMethod="mi", bins=24,
                                    miIterations=3))):
        m = StereoGSW(**kw, **extra)
        d, dt = _twice(lambda: m.compute(left, right))
        bad = _bad2(d, gt, nonocc)
        _check(bad < 0.10, f"GSW {name} bad-2.0 {bad:.2%}")
        _record(card, f"e gsw {name}", dt, "bad2<10%", bad2=f"{bad:.4f}")


def phase_points(card, rect, disp):
    """(f)"""
    from simplestereo_jax import points

    pts, dt = _twice(lambda: rect.get3DPoints(disp))
    pts = np.asarray(pts, np.float64).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(1)]
    _check(len(pts) > 0.5 * disp.size, "get3DPoints: too few finite points")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.ply")
        points.exportPLY(pts, path)
        back = points.importPLY(path)
    err = float(np.abs(back - pts).max())
    _check(back.shape == pts.shape and err <= 1e-6,
           f"PLY round trip off by {err}")
    _record(card, "f points", dt, "ply<=1e-6", n=len(pts),
            ply_err=f"{err:.1e}")


def _plane_rig(res):
    import simplestereo_jax as ss
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix

    w, h = res
    K = np.array([[1.1 * w, 0, (w - 1) / 2], [0, 1.1 * w, (h - 1) / 2],
                  [0, 0, 1.0]])
    R = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
    T = np.array([[-200.0], [5.0], [30.0]])
    return ss.StereoRig(res, res, K, K, None, None, R, T), K, R, T


def _plane_map(K, R, T, res, z0):
    """Projector pixel seen by each camera pixel on the plane z = z0."""
    w, h = res
    gx, gy = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K).T
    q = (z0 * rays @ R.T + T.ravel()) @ K.T
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]


def _capture(pattern, mx, my):
    import jax.numpy as jnp
    from simplestereo_jax import warp

    return np.asarray(warp.remap(jnp.asarray(pattern),
                                 jnp.asarray(mx, jnp.float32),
                                 jnp.asarray(my, jnp.float32),
                                 interpolation="linear"))


def _z_err(cloud, z0, margin=40):
    z = np.asarray(cloud)[..., margin:-margin, margin:-margin, 2]
    fin = np.isfinite(z)
    return float(fin.mean()), float(np.median(np.abs(z[fin] - z0)) / z0)


def phase_ftp(card, res=(W, H), batch=4, z0=2600.0, period=16.0):
    """(g)"""
    from simplestereo_jax.active import StereoFTP, buildFringe

    rig, K, R, T = _plane_rig(res)
    fringe = buildFringe(period, dims=res, stripeColor="red")
    cam = _capture(fringe, *_plane_map(K, R, T, res, z0))
    ftp = StereoFTP(rig, fringe, period)
    cloud, dt = _twice(lambda: ftp.getCloud(cam))
    fin, err = _z_err(cloud, z0)
    _check(fin > 0.8 and err < 0.01,
           f"FTP plane: finite {fin:.2%}, median z error {err:.2%}")
    _record(card, "g ftp", dt, "z<1%,finite>80%", z_err=f"{err:.2e}",
            finite=f"{fin:.4f}")
    rng = np.random.default_rng(2)
    stack = np.stack([np.clip(cam.astype(np.int16)
                              + rng.integers(-2, 3, cam.shape), 0, 255)
                      .astype(np.uint8) for _ in range(batch)])
    clouds, dtb = _twice(lambda: ftp.getCloudBatch(stack))
    for c in clouds:
        fin, err = _z_err(c, z0)
        _check(fin > 0.8 and err < 0.01,
               f"FTP batch plane: finite {fin:.2%}, z error {err:.2%}")
    _record(card, f"g ftp batch{batch}", dtb, "z<1%,finite>80%")


def phase_graycode(card, res=(W, H), z0=2600.0):
    """(h)"""
    from simplestereo_jax.active import GrayCode
    from simplestereo_jax.active.patterns import graycode_patterns

    rig, K, R, T = _plane_rig(res)
    pats, _, _ = graycode_patterns(res)
    mx, my = _plane_map(K, R, T, res, z0)
    caps = [_capture(p, mx, my) for p in pats]
    gc = GrayCode(rig)
    pts, dt = _twice(lambda: gc.getCloud(caps))
    pts = np.asarray(pts).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(1)]
    _check(len(pts) > 0.5 * res[0] * res[1], "Gray code: too few points")
    # one projector pixel of disparity is ~z0^2 / (baseline * f) in depth
    quant = z0 * z0 / (200.0 * K[0, 0])
    zerr = np.abs(pts[:, 2] - z0)
    med, p90 = float(np.median(zerr)), float(np.percentile(zerr, 90))
    _check(med < 0.5 * quant and p90 < 3 * quant,
           f"Gray code plane: median {med:.3f}, p90 {p90:.3f}, "
           f"quantum {quant:.3f}")
    _record(card, "h graycode", dt, "median<0.5q,p90<3q",
            median=f"{med:.4f}", p90=f"{p90:.4f}", quantum=f"{quant:.4f}")


def single_card(card, size=(W, H)):
    from simplestereo_jax.evaluation import layered_scene

    scene = layered_scene(size[1], size[0], seed=0)
    rect = phase_rectify(card, scene, size)
    disp = phase_asw(card, scene)
    phase_asw_engines(card)
    phase_sgm(card, scene)
    phase_gsw(card, scene)
    phase_points(card, rect, disp)
    phase_ftp(card, size)
    phase_graycode(card, size)


def four_cards(card, devices, size=(W, H), num_disp=128):
    """The sharded paths on a 4-device mesh, each against one card."""
    import jax.numpy as jnp
    from simplestereo_jax import parallel
    from simplestereo_jax.active import StereoFTP, buildFringe
    from simplestereo_jax.calibration import ba
    from simplestereo_jax.calibration.sharded import calibrate_camera_sharded
    from simplestereo_jax.evaluation import layered_scene
    from simplestereo_jax.passive import (StereoSGM, asw_disparity,
                                          asw_disparity_batch)

    rows = parallel.make_mesh({"rows": 4}, devices)
    left, right, _, _ = layered_scene(size[1], size[0], seed=0)
    akw = dict(win_size=35, min_disp=4, max_disp=14, gamma_c=15.0,
               consistent=True)
    tiled, dt = _twice(lambda: parallel.tiled_asw_disparity(
        left, right, rows, **akw))
    single = np.asarray(asw_disparity(left, right, **akw))
    _check(np.array_equal(np.asarray(tiled), single),
           "tiled ASW differs from one card")
    _record(card, "4 tiled asw", dt, "bit-exact")

    m = StereoSGM(minDisparity=0, numDisparities=num_disp, blockSize=3,
                  uniquenessRatio=0, P1=120, P2=480, costMethod="census",
                  censusWindow=7)
    tiled, dt = _twice(lambda: parallel.tiled_sgm_disparity(
        left, right, rows, num_disp=num_disp, block_size=3, P1=120, P2=480,
        uniqueness=0.0, cost_method="census", census_window=7))
    _check(np.array_equal(np.asarray(tiled), m.compute(left, right)),
           "tiled SGM differs from one card")
    _record(card, "4 tiled sgm", dt, "bit-exact")

    batch = parallel.make_mesh({"batch": 4}, devices)
    rng = np.random.default_rng(3)
    shifts = rng.integers(0, 40, 8)
    ls = np.stack([np.roll(left, s, axis=0) for s in shifts])
    rs = np.stack([np.roll(right, s, axis=0) for s in shifts])
    run = parallel.batch_parallel(
        lambda a, b: asw_disparity(a, b, **akw), batch)
    out, dt = _twice(lambda: run(jnp.asarray(ls), jnp.asarray(rs)))
    _check(np.array_equal(np.asarray(out),
                          np.asarray(asw_disparity_batch(ls, rs, **akw))),
           "batch_parallel differs from one card")
    _record(card, "4 batch_parallel asw x8", dt, "bit-exact")

    rig, K, R, T = _plane_rig(size)
    fringe = buildFringe(16.0, dims=size, stripeColor="red")
    z0 = 2600.0
    cam = _capture(fringe, *_plane_map(K, R, T, size, z0))
    ftp = StereoFTP(rig, fringe, 16.0)
    cloud, dt = _twice(lambda: parallel.sharded_ftp_cloud(ftp, cam, rows))
    one = ftp.getCloud(cam)
    both = np.isfinite(one[..., 2]) & np.isfinite(cloud[..., 2])
    dz = float(np.abs(one[..., 2] - cloud[..., 2])[both].max()) / z0
    _check(both.mean() > 0.9 and dz < 1e-4, f"sharded FTP dz/z {dz}")
    _record(card, "4 sharded ftp", dt, "dz/z<1e-4", dz_rel=f"{dz:.2e}")

    views = parallel.make_mesh({"views": 4}, devices)
    rng = np.random.default_rng(1)
    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 30.0, yy.ravel() * 30.0, np.zeros(42)], 1)
    Kt = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]])
    img = []
    for _ in range(8):
        rvec = rng.normal(0, 0.2, 3)
        tvec = np.array([rng.normal(-90, 20), rng.normal(-75, 20),
                         rng.normal(600, 50)])
        p = ba.project_points(obj, rvec, tvec, Kt[0, 0], Kt[1, 1],
                              Kt[0, 2], Kt[1, 2], np.zeros(5))
        img.append(p + rng.normal(0, 0.05, p.shape))
    Hs = [ba._homography_dlt(obj[:, :2], v) for v in img[:4]]
    fx, fy, cx, cy = ba._zhang_intrinsics(Hs, (640, 480))
    K0 = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    (rms, Ke, _, _), dt = _twice(lambda: calibrate_camera_sharded(
        np.tile(obj[None], (8, 1, 1)), np.stack(img), K0, np.zeros(5),
        views, axis="views", iterations=15))
    kerr = float(np.abs(Ke - Kt).max())
    _check(rms < 0.2 and kerr < 5.0, f"sharded BA rms {rms}, K err {kerr}")
    _record(card, "4 sharded ba", dt, "rms<0.2,K<5px", rms=f"{rms:.4f}",
            k_err=f"{kerr:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-card mesh")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {devices}")
    from simplestereo_jax.utils import enable_compile_cache

    enable_compile_cache()
    card = _card()
    print(f"[a device] devices={devices} card={card}", flush=True)
    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {devices}")
        used = devices[:4]
        four_cards(card, used)
    else:
        single_card(card)
        used = devices[:1]
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": used[0].platform, "kind": used[0].device_kind,
        "count": len(used)}}))


if __name__ == "__main__":
    sys.exit(main())
