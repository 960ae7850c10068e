"""Multi-host (multi-process) worker for the sharded pipelines.

The standard JAX multi-host recipe (SURVEY.md §2.3 / BASELINE.md): every
process calls ``jax.distributed.initialize`` against a shared coordinator,
contributes its local devices to one global mesh, and runs the SAME SPMD
program; XLA hands the collectives to the device interconnect within a
host (NCCL on GPUs) and to the network across hosts. Here each process
exposes N virtual CPU devices so the recipe is testable without a
multi-host cluster (tests/test_multihost.py spawns 2+ of these workers);
on real hosts the identical code path runs with the GPU backend and no
``--xla_force_host_platform_device_count`` flag.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
          [local_devices] [consistent] [path]

``path`` selects ONE collective path so a failure names the collective it
belongs to (round-5, VERDICT r4 item 5):

- ``asw``: row-tiled ASW matching (halo ppermute) + the psum reduction
  pattern, checked against the single-device kernel;
- ``sgm``: row-tiled SGM — the wavefront pipeline's scan carries cross
  the process boundary (the DCN-analog leg of the ppermute chain);
- ``gsw``: row-tiled GSW under shard_map, halo ppermutes crossing the
  process boundary;
- ``ftp``: row-sharded FTP — distributed y-unwrap (boundary-row ppermute
  + all_gather of per-shard column totals) and psum'd fringe order;
- ``ba``: sharded Schur-complement bundle adjustment — psum'd intrinsic
  normal equations reduce across the process boundary;
- ``all``: every path in sequence (the pre-round-5 monolith, kept for
  ad-hoc runs).

Process 0 prints one ``MULTIHOST-OK path=<p> ...`` line per validated
path.
"""

import os
import sys

import numpy as np


def _frame_pair(n_dev):
    """Identical frame on every process (same seed) — the global array is
    assembled from each process's addressable shards."""
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 256, (4 * n_dev, 40, 3), np.uint8)
    img2 = np.roll(img1, -2, axis=1)
    return img1, img2


def _shard(img, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("rows"))
    return jax.make_array_from_callback(img.shape, sh, lambda i: img[i])


def run_asw(mesh, n_dev, consistent, check):
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P
    from simplestereo_jax import parallel
    from simplestereo_jax.passive import asw_disparity

    img1, img2 = _frame_pair(n_dev)
    tiled = parallel.tiled_asw_disparity(
        _shard(img1, mesh), _shard(img2, mesh), mesh,
        win_size=5, max_disp=4, consistent=consistent)
    out = np.asarray(multihost_utils.process_allgather(tiled, tiled=True))

    # Cross-host psum (the BA normal-equation reduction pattern) rides
    # along: it is the smallest possible DCN-analog collective check.
    s, c = np.asarray(parallel.psum_stats(
        jax.make_array_from_callback(
            (n_dev, 2), NamedSharding(mesh, P("rows")),
            lambda i: np.ones((n_dev, 2), np.float32)[i]),
        mesh, ("rows",)))
    assert s == 2 * n_dev and c == 2 * n_dev, (s, c)

    if check:
        single = np.asarray(asw_disparity(
            img1, img2, win_size=5, max_disp=4, consistent=consistent))
        mismatch = float((single != out).mean())
        assert mismatch <= 0.005, f"mismatch {mismatch:.2%}"
        return f"mismatch={mismatch:.4f}"
    return ""


def run_sgm(mesh, n_dev, consistent, check):
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from simplestereo_jax import parallel

    img1, img2 = _frame_pair(n_dev)
    sgm_tiled = parallel.tiled_sgm_disparity(
        _shard(img1, mesh), _shard(img2, mesh), mesh, num_disp=4)
    sgm_out = np.asarray(
        multihost_utils.process_allgather(sgm_tiled, tiled=True))
    if check:
        from simplestereo_jax.passive.sgm import _sgm_disparity
        sgm_single = np.asarray(_sgm_disparity(
            jnp.asarray(img1), jnp.asarray(img2), min_disp=0, num_disp=4,
            block_size=3, P1=72, P2=288, paths=8, prefilter_cap=63.0,
            uniqueness=10.0, disp12_max_diff=-1, subpixel=True))
        assert (sgm_single == sgm_out).all(), "tiled SGM multihost mismatch"
        return "sgm=bit-exact"
    return ""


def run_gsw(mesh, n_dev, consistent, check):
    from jax.experimental import multihost_utils
    from simplestereo_jax import parallel

    img1, img2 = _frame_pair(n_dev)
    gsw_tiled = parallel.tiled_gsw_disparity(
        _shard(img1, mesh), _shard(img2, mesh), mesh, win_size=5,
        max_disp=4, gamma=10.0, f_max=60.0, consistent=consistent)
    gsw_out = np.asarray(
        multihost_utils.process_allgather(gsw_tiled, tiled=True))
    if check:
        from simplestereo_jax.passive.gsw import gsw_disparity
        gsw_single = np.asarray(gsw_disparity(
            img1, img2, win_size=5, max_disp=4, gamma=10.0, f_max=60.0,
            consistent=consistent))
        assert (gsw_single == gsw_out).all(), "tiled GSW multihost mismatch"
        return "gsw=bit-exact"
    return ""


def run_ftp(mesh, n_dev, consistent, check):
    import jax.numpy as jnp
    from simplestereo_jax import StereoRig, warp, parallel
    from simplestereo_jax.active import buildFringe, StereoFTP
    from simplestereo_jax.geometry.npgeom import rodrigues_to_matrix

    CAM = (128, 96)
    K = np.array([[140.0, 0, 63.5], [0, 140.0, 47.5], [0, 0, 1]])
    Rr = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
    Tt = np.array([[-40.0], [1.0], [6.0]])
    ftp_rig = StereoRig(CAM, CAM, K, K, None, None, Rr, Tt)
    period, z0 = 16.0, 520.0
    fringe = buildFringe(period, dims=CAM, stripeColor="red")
    gx, gy = np.meshgrid(np.arange(CAM[0], dtype=float),
                         np.arange(CAM[1], dtype=float))
    rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K).T
    q = (z0 * rays @ Rr.T + Tt.ravel()) @ K.T
    cam_img = np.asarray(warp.remap(
        jnp.asarray(fringe), jnp.asarray(q[..., 0] / q[..., 2], jnp.float32),
        jnp.asarray(q[..., 1] / q[..., 2], jnp.float32),
        interpolation="linear"))
    ftp = StereoFTP(ftp_rig, fringe, period)
    ftp_out = parallel.sharded_ftp_cloud(ftp, cam_img, mesh)
    if check:
        ftp_single = ftp.getCloud(cam_img)
        both = np.isfinite(ftp_single[..., 2]) & np.isfinite(ftp_out[..., 2])
        assert both.mean() > 0.9, both.mean()
        dz = float(np.abs(ftp_single[..., 2] - ftp_out[..., 2])[both].max())
        assert dz < 1e-2, f"sharded FTP multihost dz {dz}"
        return f"ftp_dz={dz:.2e}"
    return ""


def run_ba(mesh, n_dev, consistent, check):
    from simplestereo_jax.calibration import ba
    from simplestereo_jax.calibration.sharded import calibrate_camera_sharded

    rng_ba = np.random.default_rng(1)
    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 30.0, yy.ravel() * 30.0,
                    np.zeros(42)], 1)
    Kt = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]])
    views = []
    # One view per device; every process generates the same set.
    for _ in range(n_dev):
        rvec = rng_ba.normal(0, 0.2, 3)
        tvec = np.array([rng_ba.normal(-90, 20), rng_ba.normal(-75, 20),
                         rng_ba.normal(600, 50)])
        pts = ba.project_points(obj, rvec, tvec, Kt[0, 0], Kt[1, 1],
                                Kt[0, 2], Kt[1, 2], np.zeros(5))
        views.append(pts + rng_ba.normal(0, 0.05, pts.shape))
    Hs = [ba._homography_dlt(obj[:, :2], v) for v in views[:4]]
    fx, fy, cx, cy = ba._zhang_intrinsics(Hs, (640, 480))
    K0 = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    rms, Ke, _, poses = calibrate_camera_sharded(
        np.tile(obj[None], (n_dev, 1, 1)), np.stack(views), K0,
        np.zeros(5), mesh, axis="rows", iterations=15)
    assert rms < 0.2, rms
    assert np.abs(Ke - Kt).max() < 5.0, Ke
    assert poses.shape == (n_dev, 6)
    return f"ba_rms={rms:.4f}" if check else ""


PATHS = {"asw": run_asw, "sgm": run_sgm, "gsw": run_gsw, "ftp": run_ftp,
         "ba": run_ba}


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    local = int(sys.argv[4]) if len(sys.argv) > 4 else 4
    consistent = (sys.argv[5] == "1") if len(sys.argv) > 5 else False
    path = sys.argv[6] if len(sys.argv) > 6 else "all"

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={local}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc, process_id=pid)

    from jax.experimental import multihost_utils
    from simplestereo_jax import parallel

    n_dev = len(jax.devices())
    assert n_dev == local * nproc, (n_dev, local, nproc)
    mesh = parallel.make_mesh({"rows": n_dev})

    names = list(PATHS) if path == "all" else [path]
    for name in names:
        detail = PATHS[name](mesh, n_dev, consistent, check=(pid == 0))
        if pid == 0:
            print(f"MULTIHOST-OK path={name} {detail} devices={n_dev} "
                  f"processes={nproc}", flush=True)

    multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
