"""
parallel.ftp
============

Row-sharded StereoFTP point-cloud pipeline — the SURVEY §5 analog for the
FTP family (the reference's pipeline, active.py:608-841, is a
single-process host program with no distribution story).

Every dense stage of the fused FTP program is per-row or per-pixel, so the
decomposition over a ``jax.sharding.Mesh`` rows axis is almost free:

- **grayscale / projector mapping / virtual reference** — per-pixel; each
  shard evaluates its own global row range (the anaglyph ``B - R``
  normalization needs one global min/max → ``pmin``/``pmax``).
- **row-FFT band-pass phase** — per-row (the FFT axis is x), fully local.
- **2-D unwrap** — x-unwrap is per-row; the y-unwrap is a prefix sum down
  columns of *locally computable* corrections (``np.unwrap``'s correction
  at a step depends only on that step's raw difference), so it distributes
  as local-cumsum + cross-shard offset: ONE ``ppermute`` for the boundary
  row and ONE ``all_gather`` of per-shard column totals.
- **fringe-order k** — a global mean over stripe pixels → masked local
  gathers + ``psum``.
- **dense epipolar triangulation** — per-pixel
  (:func:`simplestereo_jax.active.ftp._dense_cloud_rows` with the shard's
  global row offset), fully local.

Differences vs the single-device fused program are float-associativity
only (the y-unwrap offset sums per-shard totals instead of one long
cumsum); everything else is pointwise-identical (the sharded and
single-device clouds are compared in tests/test_parallel_sgm_ftp.py).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..active.ftp import (_phase_pipeline, _dense_cloud_rows,
                          StereoFTP_Mapping, StereoFTP_PhaseOnly)
from ..geometry.distortion import distort_normalized, pad_dist_coeffs
from .. import warp


def _projector_mapping_rows(z, M, T, K2, dist2, fringe_gray, xs, row0,
                            n_rows):
    """Row-band twin of ``active.ftp._projector_mapping_device``
    (active.py:432-492): projector coordinates + virtual reference for
    global image rows ``[row0, row0 + n_rows)`` and columns ``xs``.
    Pointwise-identical to slicing the full-grid version."""
    ys = row0 + jnp.arange(n_rows, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys)                       # (n_rows, w)
    h, w = gx.shape
    prec = jax.lax.Precision.HIGHEST

    def project(gx, gy):
        p = jnp.stack([gx, gy, jnp.ones_like(gx)], axis=-1)
        q = z * jnp.einsum("ij,hwj->hwi", M, p, precision=prec) \
            + T[None, None, :]
        xy = q[..., :2] / q[..., 2:3]
        xyd = distort_normalized(xy.reshape(-1, 2), dist2).reshape(h, w, 2)
        u = K2[0, 0] * xyd[..., 0] + K2[0, 1] * xyd[..., 1] + K2[0, 2]
        v = K2[1, 1] * xyd[..., 1] + K2[1, 2]
        return u, v

    uc, vc = project(gx + 0.5, gy + 0.5)
    proj_coords = jnp.stack([uc, vc], axis=-1)
    ui, vi = project(gx, gy)
    virtual_ref = warp.remap(fringe_gray, ui, vi, interpolation="cubic")
    return proj_coords, virtual_ref


def _unwrap_rows_sharded(p, axis_name):
    """``jnp.unwrap(p, axis=0)`` across a row-sharded (H_local, W) block.

    np.unwrap's correction at row j is a function of the raw difference
    ``p[j] - p[j-1]`` alone, so the unwrap is ``p + cumsum(corr)`` — a
    prefix sum that distributes as local cumsum + the sum of previous
    shards' totals."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    pi = jnp.float32(jnp.pi)

    if n > 1:
        prev_last = jax.lax.ppermute(
            p[-1], axis_name, [(s, s + 1) for s in range(n - 1)])
    else:
        prev_last = jnp.zeros_like(p[-1])
    pl = jnp.concatenate([prev_last[None], p], axis=0)
    dd = jnp.diff(pl, axis=0)                       # dd[j] = p[j] - p[j-1]
    ddmod = jnp.mod(dd + pi, 2 * pi) - pi
    ddmod = jnp.where((ddmod == -pi) & (dd > 0), pi, ddmod)
    corr = jnp.where(jnp.abs(dd) >= pi, ddmod - dd, 0.0)
    # shard 0's first row has no predecessor: out[0] == p[0]
    corr = corr.at[0].set(jnp.where(idx == 0, 0.0, corr[0]))
    cs = jnp.cumsum(corr, axis=0)
    if n > 1:
        totals = jax.lax.all_gather(cs[-1], axis_name)      # (n, W)
        offset = jnp.sum(
            jnp.where(jnp.arange(n)[:, None] < idx, totals, 0.0), axis=0)
    else:
        offset = 0.0
    return p + cs + offset


def sharded_ftp_cloud(ftp, imgObj, mesh, row_axis="rows", *,
                      radius_factor=0.5, roi=None):
    """Row-sharded :meth:`StereoFTP.getCloud` over a device mesh.

    The host preamble (undistortion, stripe carrier estimation) is shared
    with the single-device path (``StereoFTP._cloud_prep``); the fused
    device pipeline then runs under ``shard_map`` with image rows sharded
    over ``mesh[row_axis]``. Works for :class:`StereoFTP` and
    :class:`StereoFTPAnaglyph` (gray modes "max", "br", and pre-converted
    "host" frames). Returns the (roi_h, roi_w, 3) float64 cloud.
    """
    if isinstance(ftp, StereoFTP_PhaseOnly):
        raise TypeError("StereoFTP_PhaseOnly has no cloud output; "
                        "shard getPhase via parallel.batch_parallel")
    if isinstance(ftp, StereoFTP_Mapping):
        raise TypeError("StereoFTP_Mapping uses the classic no-virtual-"
                        "reference pipeline; only the fused StereoFTP/"
                        "StereoFTPAnaglyph path is row-sharded")
    rig = ftp.stereoRig
    prep = ftp._cloud_prep(imgObj, radius_factor, roi)
    roi = prep["roi"]
    roi_x, roi_y, roi_w, roi_h = (int(v) for v in roi)
    n = mesh.shape[row_axis]
    if roi_h % n:
        raise ValueError(f"ROI rows {roi_h} not divisible by mesh axis "
                         f"{row_axis}={n}")
    gray_mode = prep["gray_mode"]
    fc, radius = prep["fc"], prep["radius"]

    # Multi-process meshes: committed single-device arrays cannot be
    # resharded across processes, but host numpy inputs are device_put to
    # the shard_map's in_specs sharding on every process (each uploads
    # its addressable shards) — the standard multihost recipe. The host
    # preamble is deterministic, so every process holds identical values.
    multi = jax.process_count() > 1
    cast = (lambda x, dt: np.asarray(x, dt)) if multi \
        else (lambda x, dt: jnp.asarray(x, dt))
    img = cast(prep["imgObj"], np.float32)
    fmin = cast(fc - radius, np.float32)
    fmax = cast(fc + radius, np.float32)
    stripe_idx = cast(prep["stripe_idx"], np.int32)
    args = (
        img, fmin, fmax,
        cast(prep["z_plane"], np.float32),
        cast(prep["rigM"], np.float32),
        cast(np.asarray(rig.T, np.float64).ravel(), np.float32),
        cast(rig.intrinsic2, np.float32),
        cast(np.asarray(pad_dist_coeffs(rig.distCoeffs2)), None),
        cast(ftp.fringe, np.float32),
        stripe_idx,
        cast(ftp.stripeCentralPeak, np.float32),
        cast(ftp.fp, np.float32),
        cast(ftp.ep, np.float32),
        cast(ftp.Rectify1, np.float32),
        cast(ftp.Rectify2, np.float32),
        cast(ftp.R_inv[:3, :3], np.float32),
        cast(rig.getBaseline(), np.float32),
    )
    out = _sharded_ftp_program(mesh, row_axis, (roi_x, roi_y, roi_w),
                               gray_mode, len(args))(*args)
    if multi:
        # rows of the global cloud live on other processes: gather
        from jax.experimental import multihost_utils
        out = multihost_utils.process_allgather(out, tiled=True)
    return np.asarray(out, np.float64)


@functools.lru_cache(maxsize=None)
def _sharded_ftp_program(mesh, row_axis, roi, gray_mode, n_args):
    """The jitted row-sharded FTP program, built once per static
    configuration (``roi`` = (x, y, w) of the crop)."""
    roi_x, roi_y, roi_w = roi
    sh = P(row_axis)
    in_specs = (sh, sh, sh) + (P(),) * (n_args - 3)

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=in_specs, out_specs=sh,
        check_vma=False)
    def run(img_l, fmin_l, fmax_l, z, M, T, K2, dist2, fringe, sidx,
            peak, fp, ep, R1, R2, Ri3, baseline):
        i = jax.lax.axis_index(row_axis)
        Hl = img_l.shape[0]
        row0 = jnp.float32(roi_y) + (i * Hl).astype(jnp.float32)

        if gray_mode == "br":   # anaglyph: globally normalized B - R
            d = img_l[:, :, 0] - img_l[:, :, 2]
            dmin = jax.lax.pmin(jnp.min(d), row_axis)
            dmax = jax.lax.pmax(jnp.max(d), row_axis)
            ptp = dmax - dmin
            gray = (d - dmin) / jnp.where(ptp > 0, ptp, 1.0)
        elif gray_mode == "host":   # already a 2-D frame
            gray = img_l
        else:                       # "max": per-pixel channel max
            gray = jnp.max(img_l, axis=2)

        pc_l, vref_l = _projector_mapping_rows(
            z, M, T, K2, dist2, fringe,
            jnp.arange(roi_x, roi_x + roi_w, dtype=jnp.float32),
            row0, Hl)
        phase = _phase_pipeline(gray, vref_l, fmin_l, fmax_l)
        pu = _unwrap_rows_sharded(jnp.unwrap(phase, axis=1), row_axis)

        # fringe order k: global mean over stripe pixels (psum)
        r = sidx[:, 1] - i * Hl
        mask = (r >= 0) & (r < Hl)
        rc = jnp.clip(r, 0, Hl - 1)
        # stripe_idx is in ROI-cropped coordinates (the stripe is found on
        # the cropped frame) — rows offset by the shard, columns as-is
        xc = jnp.clip(sidx[:, 0], 0, roi_w - 1)
        theta = pu[rc, xc]
        u_A = pc_l[rc, xc, 0]
        kv = (peak - u_A) * fp - theta / (2 * jnp.pi)
        s = jax.lax.psum(jnp.sum(jnp.where(mask, kv, 0.0)), row_axis)
        c = jax.lax.psum(jnp.sum(mask.astype(jnp.float32)), row_axis)
        k = jnp.ceil(s / c - 0.5)

        return _dense_cloud_rows(pc_l, pu, k, ep, fp, K2, dist2,
                                 R1, R2, Ri3, baseline, roi_x, row0)

    return run


__all__ = ["sharded_ftp_cloud"]
