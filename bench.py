"""Benchmark: the dense matchers and structured-light pipelines on one GPU.

Prints ONE JSON line: the headline (consistent ASW throughput at the
reference's Tsukuba settings, Mpix*disp/s) and, per stage, the median and
interquartile range of single calls, with the device it ran on.

Method: one process on one card. Each stage compiles on its first input
(never timed), then times one call per remaining input; inputs vary from
call to call and every output is read back to the host, so a time covers
the whole call. Scenes come from a seed: a 384x288 pair shaped like
Tsukuba and a 1280x720 pair, both of known disparity
(:func:`simplestereo_jax.evaluation.layered_scene`), and planes seen by
synthetic FTP and Gray-code rigs. A stage that raises ends the run with a
non-zero exit code; without a GPU the run stops before any stage.

Baseline: the reference C++ thread-pool ASW at 384x288, 11 candidates,
winSize=35, consistent — BASELINE.md's conservative figure of 1.33
Mpix*disp/s ("<1 s on 4 CPU threads",
reference simplestereo/passive.py:53-56) — is ``vs_baseline``.
"""

import json
import subprocess
import sys
import time

import numpy as np

_N_TIMED = 9  # inputs per stage: 1 warm-only + 8 timed


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    from simplestereo_jax import StereoRig, warp
    from simplestereo_jax.active import GrayCode, StereoFTP, buildFringe
    from simplestereo_jax.active.graycode import decode_graycode
    from simplestereo_jax.active.patterns import graycode_patterns
    from simplestereo_jax.evaluation import (evaluate_disparity,
                                             layered_scene)
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix
    from simplestereo_jax.passive import (StereoASW, StereoGSW, StereoSGM,
                                          quality_disparity)
    from simplestereo_jax.utils import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    t_start = time.time()
    left, right, gt, nonocc = layered_scene(288, 384, seed=0)
    H, W = left.shape[:2]
    D = 11  # candidates 4..14

    def bad2(disp, scale=1.0):
        return round(evaluate_disparity(
            np.asarray(disp), gt, nonocc, bad_thresholds=(2.0,),
            disp_scale=scale)["bad2"], 4)

    stats, extra = {}, {}

    def timed(name, fn, inputs):
        """Median seconds of ``fn`` over inputs[1:] (inputs[0] compiles)."""
        np.asarray(fn(inputs[0]))
        ts = []
        for x in inputs[1:]:
            t0 = time.perf_counter()
            np.asarray(fn(x))
            ts.append(time.perf_counter() - t0)
        q1, med, q3 = np.percentile(ts, [25, 50, 75])
        stats[name] = {"ms": round(med * 1e3, 3), "n": len(ts),
                       "iqr_ms": round((q3 - q1) * 1e3, 3)}
        return med

    rightd = jnp.asarray(right)
    lefts = [jnp.asarray(np.roll(left, i, axis=0)) for i in range(_N_TIMED)]

    def batch_stacks(B=8):
        """_N_TIMED distinct device-resident (B, H, W, 3) stacks."""
        return [jnp.asarray(np.stack(
            [np.roll(left, i * B + j, axis=0) for j in range(B)]))
            for i in range(_N_TIMED)]

    # ---- ASW at the reference's example-010 settings --------------------
    asw = StereoASW(winSize=35, minDisparity=4, maxDisparity=14, gammaC=15,
                    gammaP=17.5, consistent=True)
    dt = timed("asw", lambda x: asw.compute(x, rightd), lefts)
    mpixdisp = H * W * D / dt / 1e6
    extra["bad2_nonocc"] = bad2(asw.compute(left, right))

    asw2 = StereoASW(winSize=35, minDisparity=4, maxDisparity=14,
                     gammaC=15, gammaP=17.5, consistent=True, step=2)
    dt = timed("asw_step2", lambda x: asw2.compute(x, rightd), lefts)
    extra["asw_step2_mpixdisp_per_s"] = round(H * W * D / dt / 1e6, 2)
    extra["asw_step2_bad2_nonocc"] = bad2(asw2.compute(left, right))

    B = 8
    rights = jnp.asarray(np.stack([right] * B))
    dt = timed("asw_batch8", lambda s: asw.computeBatch(s, rights),
               batch_stacks(B)) / B
    extra["asw_batch8_mpixdisp_per_s"] = round(H * W * D / dt / 1e6, 2)

    # ---- SGM --------------------------------------------------------------
    sgm = StereoSGM(minDisparity=0, numDisparities=16, blockSize=3, P1=120,
                    P2=480, uniquenessRatio=0, costMethod="census",
                    censusWindow=7)
    dt = timed("sgm", lambda x: sgm.compute(x, rightd), lefts)
    extra["sgm_mpixdisp_per_s"] = round(H * W * 16 / dt / 1e6, 2)
    extra["sgm_bad2_nonocc"] = bad2(sgm.compute(left, right), 1 / 16.0)

    sgm_bt = StereoSGM(minDisparity=0, numDisparities=16, blockSize=3,
                       P1=36, P2=144, preFilterCap=15, uniquenessRatio=0)
    dt = timed("sgm_bt", lambda x: sgm_bt.compute(x, rightd), lefts)
    extra["sgm_bt_mpixdisp_per_s"] = round(H * W * 16 / dt / 1e6, 2)
    extra["sgm_bt_bad2_nonocc"] = bad2(sgm_bt.compute(left, right),
                                       1 / 16.0)

    dt = timed("sgm_batch8", lambda s: sgm_bt.computeBatch(s, rights),
               batch_stacks(B)) / B
    extra["sgm_batch8_mpixdisp_per_s"] = round(H * W * 16 / dt / 1e6, 2)

    # ---- 1280x720 rows ------------------------------------------------------
    l7, r7, _, _ = layered_scene(720, 1280, seed=1)
    H7, W7 = l7.shape[:2]
    r7d = jnp.asarray(r7)
    l7s = [jnp.asarray(np.roll(l7, i, axis=0)) for i in range(5)]
    dt = timed("asw_720p", lambda x: asw.compute(x, r7d), l7s)
    extra["asw_720p_ms"] = round(dt * 1e3, 3)
    extra["asw_720p_mpixdisp_per_s"] = round(H7 * W7 * D / dt / 1e6, 1)

    sgm7 = StereoSGM(minDisparity=0, numDisparities=128, blockSize=3,
                     P1=36, P2=144, preFilterCap=15, uniquenessRatio=0)
    dt = timed("sgm_720p", lambda x: sgm7.compute(x, r7d), l7s)
    extra["sgm_720p_ms"] = round(dt * 1e3, 3)
    extra["sgm_720p_mpixdisp_per_s"] = round(H7 * W7 * 128 / dt / 1e6, 1)

    # ---- GSW at its tuned point --------------------------------------------
    gkw = dict(winSize=23, minDisparity=4, maxDisparity=14, gamma=12.5,
               fMax=20, iterations=1, consistent=True)
    gsw = StereoGSW(**gkw)
    dt = timed("gsw", lambda x: gsw.compute(np.asarray(x), right), lefts)
    extra["gsw_mpixdisp_per_s"] = round(H * W * D / dt / 1e6, 2)
    extra["gsw_bad2_nonocc"] = bad2(gsw.compute(left, right))

    dt = timed("gsw_batch8",
               lambda s: gsw.computeBatch(np.asarray(s), np.asarray(rights)),
               batch_stacks(B)) / B
    extra["gsw_batch8_mpixdisp_per_s"] = round(H * W * D / dt / 1e6, 2)

    gsw_mi = StereoGSW(costMethod="mi", bins=24, miIterations=3, **gkw)
    dt = timed("gsw_mi", lambda x: gsw_mi.compute(np.asarray(x), right),
               lefts)
    extra["gsw_mi_mpixdisp_per_s"] = round(H * W * D / dt / 1e6, 2)
    extra["gsw_mi_bad2_nonocc"] = bad2(gsw_mi.compute(left, right))

    # ---- quality preset: census SGM + LR/uniqueness + WLS fill --------------
    nlefts = [np.roll(left, i, axis=0) for i in range(_N_TIMED)]
    dt = timed("quality_sgm", lambda x: quality_disparity(
        x, right, 0, 15, matcher="sgm"), nlefts)
    extra["quality_sgm_ms"] = round(dt * 1e3, 3)
    ev = evaluate_disparity(quality_disparity(left, right, 0, 15,
                                              matcher="sgm"),
                            gt, nonocc, bad_thresholds=(2.0,))
    extra["quality_sgm_bad2_nonocc"] = round(ev["bad2"], 4)
    extra["quality_sgm_avgerr_px"] = round(ev["avgerr"], 3)

    # ---- structured light on a plane at z0 ----------------------------------
    res = (640, 480)
    K = np.array([[700.0, 0, 319.5], [0, 700.0, 239.5], [0, 0, 1]])
    R = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
    T = np.array([[-200.0], [5.0], [30.0]])
    rig = StereoRig(res, res, K, K, None, None, R, T)
    z0 = 2600.0
    gx, gy = np.meshgrid(np.arange(res[0], dtype=float),
                         np.arange(res[1], dtype=float))
    rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K).T
    q = (z0 * rays @ R.T + T.ravel()) @ K.T
    mx = jnp.asarray(q[..., 0] / q[..., 2], jnp.float32)
    my = jnp.asarray(q[..., 1] / q[..., 2], jnp.float32)
    rng = np.random.default_rng(0)

    def noisy(img):  # +-2 gray sensor noise: a distinct input per call
        return np.clip(img.astype(np.int16) + rng.integers(-2, 3, img.shape),
                       0, 255).astype(np.uint8)

    fringe = buildFringe(16.0, dims=res, stripeColor="red")
    cam = np.asarray(warp.remap(jnp.asarray(fringe), mx, my,
                                interpolation="linear"))
    ftp = StereoFTP(rig, fringe, 16.0)
    dt = timed("ftp_cloud", ftp.getCloud,
               [noisy(cam) for _ in range(_N_TIMED)])
    extra["ftp_cloud_640x480_ms"] = round(dt * 1e3, 3)
    extra["ftp_cloud_mpix_per_s"] = round(res[0] * res[1] / dt / 1e6, 2)
    cz = ftp.getCloud(cam)[40:-40, 40:-40, 2]
    cz = cz[np.isfinite(cz)]
    extra["ftp_plane_median_z_err_pct"] = round(
        abs(float(np.median(cz)) - z0) / z0 * 100, 4)

    Bf = 8
    dt = timed("ftp_cloud_batch8", ftp.getCloudBatch,
               [np.stack([noisy(cam) for _ in range(Bf)])
                for _ in range(5)]) / Bf
    extra["ftp_cloud_batch8_ms_per_frame"] = round(dt * 1e3, 3)
    extra["ftp_cloud_batch8_mpix_per_s"] = round(
        res[0] * res[1] / dt / 1e6, 2)

    gc = GrayCode(rig)
    pats, _, _ = graycode_patterns(res)

    def dec(s):
        px, py, ok = decode_graycode(s, nx=gc.nx, ny=gc.ny)
        return np.stack([np.asarray(px), np.asarray(py), np.asarray(ok)])

    dt = timed("graycode_decode", dec,
               [jnp.asarray(noisy(pats)) for _ in range(_N_TIMED)])
    extra["graycode_decode_mpix_per_s"] = round(
        pats.shape[0] * res[0] * res[1] / dt / 1e6, 1)
    cap = np.stack([np.asarray(warp.remap(jnp.asarray(p), mx, my,
                                          interpolation="linear"))
                    for p in pats])
    dt = timed("graycode_cloud", lambda c: gc.getCloud(list(c)),
               [noisy(cap) for _ in range(_N_TIMED)])
    extra["graycode_cloud_640x480_ms"] = round(dt * 1e3, 3)

    baseline = 1.33  # Mpix*disp/s (reference, 4 CPU threads)
    print(json.dumps({
        "metric": "asw_tsukuba_consistent_throughput",
        "value": round(mpixdisp, 2), "unit": "Mpix*disp/s",
        "vs_baseline": round(mpixdisp / baseline, 2),
        **extra, "stats": stats,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card, "elapsed_s": round(time.time() - t_start, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
