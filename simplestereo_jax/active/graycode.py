"""
graycode
========

Gray-code structured-light scanning.

Parity target: /root/reference/simplestereo/active.py:1130-1263 (GrayCode,
GrayCodeSingle) and :1463-1608 (GrayCodeDouble). The reference decodes
with a per-pixel Python loop over ``cv2.structured_light``'s
``getProjPixel`` (the SURVEY's clearest vectorization target); here the
whole decode is one jitted XLA program: threshold bit extraction,
Gray-to-binary conversion as an XOR prefix scan, and validity masking.

``GrayCodeDouble`` implements the *corrected* semantics of the
reference's latent bugs (active.py:1503-1506 uses an R_inv that is never
set; :1580 filters with .any instead of .all; :1583 adds 0.5 to an int
array): R_inv is computed, the filter requires all four coordinates, and
the half-pixel shift happens in float.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .patterns import graycode_patterns, graycode_num_bits
from ..geometry import npgeom
from .. import warp
from .. import rectification


@functools.partial(jax.jit, static_argnames=("nx", "ny", "white_thr"))
def decode_graycode(patterns, nx, ny, white_thr=5):
    """Vectorized Gray-code decode.

    patterns : (2*(nx+ny), H, W) captured images, ordered like
        :func:`simplestereo_jax.active.graycode_patterns` (bit, inverse,
        bit, inverse, ... columns first then rows).

    Returns (proj_x (H,W) i32, proj_y (H,W) i32, valid (H,W) bool) —
    valid requires every bit's |pattern - inverse| >= white_thr (the
    reference's white threshold semantics).
    """
    p = patterns.astype(jnp.float32)
    pos = p[0::2]
    neg = p[1::2]
    bits = (pos > neg)
    ok = jnp.abs(pos - neg) >= white_thr
    valid = jnp.all(ok, axis=0)

    def gray_to_index(gbits):
        # binary MSB-first prefix-XOR of gray bits
        out = jnp.zeros(gbits.shape[1:], jnp.int32)
        b = jnp.zeros(gbits.shape[1:], jnp.bool_)
        for i in range(gbits.shape[0]):
            b = jnp.logical_xor(b, gbits[i])
            out = out * 2 + b.astype(jnp.int32)
        return out

    proj_x = gray_to_index(bits[:nx])
    proj_y = gray_to_index(bits[nx:nx + ny])
    return proj_x, proj_y, valid


def _gray_host(img, res):
    """Host load + grayscale + size check for one capture (cheap numpy;
    the undistortion happens batched on device — see
    :func:`_undistort_stack`).

    uint8 in, uint8 out (BGR inputs are grayscaled and rounded back to
    uint8, cv2.cvtColor semantics — the reference's whole decode runs on
    uint8 grayscale captures): the stack upload is the scan's largest
    host->device transfer, and uint8 is 4x smaller than float. Any other
    dtype (float captures normalized to [0, 1], >8-bit sensors) keeps
    its VALUES and becomes float32 — quantizing to uint8 would crush it
    (e.g. a [0, 1] stack collapses to {0, 1} and decode returns
    garbage)."""
    if isinstance(img, (str, bytes)):
        from ..imgio import imread
        img = imread(img, grayscale=True)
    img = np.asarray(img)
    was_u8 = img.dtype == np.uint8
    if img.ndim == 3:
        g = (0.114 * img[..., 0] + 0.587 * img[..., 1]
             + 0.299 * img[..., 2])
        img = np.round(g).astype(np.uint8) if was_u8 else g
    w, h = res
    if img.shape != (h, w):
        raise ValueError("Image size mismatch!")
    if not was_u8 and img.dtype != np.float32:
        img = np.asarray(img, np.float32)
    return img


@functools.partial(jax.jit, static_argnames=("size",))
def _undistort_stack_device(imgs, K, dist, size):
    """Map construction + stack resample as ONE jitted device program
    (the unjitted form of this chain paid ~15 dispatches per scan)."""
    mapx, mapy = warp.init_undistort_rectify_map(K, dist, None, K, size)
    und = warp.remap(jnp.transpose(imgs, (1, 2, 0)), mapx, mapy)
    return jnp.transpose(und, (2, 0, 1))


def _undistort_stack(imgs_np, K, dist, res):
    """Undistort a whole (N, H, W) uint8 capture stack in ONE device
    resample.

    The reference undistorts each pattern capture separately
    (active.py:1197-1205 via cv2.undistort per image — ~40 calls per
    scan); here the stack rides the channel axis of a single remap
    (identical per-plane math), turning N host-device round-trips into
    one, and the upload stays uint8 (the 38-pattern 640x480 stack is
    11.7 MB vs 46.7 MB as f32 — the transfer dominated the scan).
    Returns a device-resident (N, H, W) stack in the input dtype family
    (uint8 stays uint8 — remap rounds integer inputs, cv2 semantics;
    float stacks stay float). A rig with no distortion skips the
    resample entirely."""
    from ..geometry.distortion import pad_dist_coeffs

    if dist is None or not np.any(np.asarray(dist)):
        return jnp.asarray(imgs_np)
    w, h = res
    return _undistort_stack_device(
        jnp.asarray(imgs_np), jnp.asarray(K, jnp.float32),
        jnp.asarray(pad_dist_coeffs(dist)), (w, h))


def _load_stack(images, black, white, K, dist, res, num_patterns):
    """Host load + grayscale of a capture list, optional black/white
    shadow captures appended (so ``und[-2]`` = black, ``und[-1]`` =
    white), then the whole stack undistorted in one device resample.
    Returns ``(und, shadow)`` — the device-resident stack and whether
    shadow captures are present. Shared by :meth:`GrayCode.decode`,
    :meth:`GrayCode.getCloud` and :meth:`GrayCodeDouble._decode_cam`."""
    imgs = [_gray_host(i, res) for i in images[:num_patterns]]
    shadow = black is not None and white is not None
    if shadow:
        imgs += [_gray_host(black, res), _gray_host(white, res)]
    und = _undistort_stack(np.stack(imgs), K, dist, res)
    return und, shadow


def _decode_validity(und, *, nx, ny, white_thr, res2, black_thr, shadow):
    """Traced decode + projector-range + shadow validity (the shared
    front half of the jitted decode and cloud programs)."""
    px, py, valid = decode_graycode(und[: 2 * (nx + ny)], nx=nx, ny=ny,
                                    white_thr=white_thr)
    w2, h2 = res2
    valid = valid & (px < w2) & (py < h2)
    if shadow:
        # strict >, cv2 computeShadowMasks semantics (f32: a uint8
        # difference would wrap where black > white; exact for 8-bit
        # values and correct for float captures)
        valid = valid & ((und[-1].astype(jnp.float32)
                          - und[-2].astype(jnp.float32)) > black_thr)
    return px, py, valid


@functools.partial(
    jax.jit,
    static_argnames=("nx", "ny", "white_thr", "res2", "black_thr",
                     "shadow"))
def _decode_device(und, *, nx, ny, white_thr, res2, black_thr, shadow):
    """Decode + validity as ONE jitted device program."""
    return _decode_validity(und, nx=nx, ny=ny, white_thr=white_thr,
                            res2=res2, black_thr=black_thr, shadow=shadow)


@functools.partial(
    jax.jit,
    static_argnames=("nx", "ny", "white_thr", "res2", "black_thr",
                     "shadow", "roi", "out_dtype"))
def _graycode_cloud_device(und, K2, dist2, Rect1, Rect2, R_inv3, baseline,
                           *, nx, ny, white_thr, res2, black_thr, shadow,
                           roi, out_dtype=None):
    """Decode + validity + dense epipolar triangulation as ONE device
    program: returns ((H, W, 3) f32 cloud, (H, W) bool valid). Mirrors
    the host path of the reference (active.py:1227-1260) and the FTP
    dense tail (:func:`simplestereo_jax.active.ftp._dense_cloud_rows` —
    projector re-distortion via iterative ``undistort_points``,
    rectification of both grids, disparity → depth). ``shadow``: the
    last two planes of ``und`` are the black/white captures."""
    from ..geometry import projection as gproj
    from ..geometry import distortion as gdist

    px, py, valid = _decode_validity(und, nx=nx, ny=ny,
                                     white_thr=white_thr, res2=res2,
                                     black_thr=black_thr, shadow=shadow)
    H, W = px.shape
    if roi is not None:
        rx, ry, rw, rh = roi
        gxi = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        gyi = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        valid = valid & (gxi >= rx) & (gxi < rx + rw) \
            & (gyi >= ry) & (gyi < ry + rh)

    # full-f32 matmuls: reduced precision (TF32) costs whole pixels here
    with jax.default_matmul_precision("highest"):
        gx, gy = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                              jnp.arange(H, dtype=jnp.float32))
        pc = jnp.stack([gx + 0.5, gy + 0.5], -1).reshape(-1, 2)
        pp = jnp.stack([px.astype(jnp.float32) + 0.5,
                        py.astype(jnp.float32) + 0.5], -1).reshape(-1, 2)
        # Projector re-distortion trick (inverse pinhole camera):
        # active.py:1239-1246.
        pp = gdist.undistort_points(pp, K2, dist2, P=K2)
        pc = gproj.perspective_transform(pc, Rect1)
        pp = gproj.perspective_transform(pp, Rect2)
        disparity = jnp.abs(pp[:, :1] - pc[:, :1])
        pch = jnp.concatenate([pc, jnp.ones((pc.shape[0], 1), pc.dtype)],
                              1)
        pw = baseline * pch / jnp.where(disparity > 1e-12, disparity,
                                        jnp.nan)
        out = pw @ R_inv3.T
    out = out.reshape(H, W, 3)
    if out_dtype is not None:
        # cast ON DEVICE: the dense-cloud readback dominates on a slow
        # host link (same lever as StereoFTP.getCloud's out_dtype)
        out = out.astype(out_dtype)
    return out, valid


class GrayCode:
    """Camera-projector Gray-code scanner (parity: active.py:1130-1263).

    Parameters
    ----------
    rig : StereoRig
        Camera in position 1 (world origin), projector in position 2.
    black_thr : int
        Shadow mask threshold: minimum brightness difference between the
        fully-illuminated (white) and non-illuminated (black) captures
        for a pixel to be considered lit by the projector (parity:
        active.py:1143-1147, the cv2 ``setBlackThreshold`` shadow-mask
        semantics). Applied when ``black``/``white`` captures are passed
        to :meth:`decode`/:meth:`getCloud` —
        :func:`simplestereo_jax.active.generateGrayCodeImgs` emits both.
    white_thr : int
        Minimum pattern-inverse difference per bit.
    """

    def __init__(self, rig, black_thr=40, white_thr=5):
        self.rig = rig
        self.black_thr = black_thr
        self.white_thr = white_thr
        self.nx = graycode_num_bits(rig.res2[0])
        self.ny = graycode_num_bits(rig.res2[1])
        self.num_patterns = 2 * (self.nx + self.ny)
        self.Rectify1, self.Rectify2, commonR = \
            rectification._lowLevelRectify(rig)
        R_inv = np.eye(4)
        R_inv[:3, :3] = np.linalg.inv(commonR)
        self.R_inv = R_inv

    def decode(self, images, black=None, white=None):
        """Decode captured pattern images to per-pixel projector coords.

        black, white : optional captures of the all-black / all-white
            projector frames. When both are given, pixels with
            ``white - black <= black_thr`` are rejected as shadowed
            (unreached by projector light — the reference's
            ``computeShadowMasks`` semantics, active.py:1143-1147).

        Returns (proj_x, proj_y, valid) numpy arrays (H, W).
        """
        rig = self.rig
        und, shadow = _load_stack(images, black, white, rig.intrinsic1,
                                  rig.distCoeffs1, rig.res1,
                                  self.num_patterns)
        px, py, valid = _decode_device(
            und, nx=self.nx, ny=self.ny, white_thr=self.white_thr,
            res2=tuple(rig.res2), black_thr=float(self.black_thr),
            shadow=shadow)
        return tuple(map(np.asarray, (px, py, valid)))

    def getCloud(self, images, roi=None, black=None, white=None,
                 out_dtype=None):
        """Triangulate a scan to 3D points, (n, 1, 3) in camera frame.

        ``images``: list of camera captures (paths or arrays) ordered like
        the generated patterns; extra trailing images are ignored.
        ``black``/``white``: optional shadow-mask captures (see
        :meth:`decode`).

        The whole decode → validity → dense epipolar triangulation runs
        as ONE device program (the reference triangulates per valid
        pixel on the host, active.py:1227-1260; the host here only
        gathers the valid points from the dense (H, W, 3) cloud).

        out_dtype : optional numpy dtype for the returned points (same
            lever as :meth:`StereoFTP.getCloud`): ``np.float16`` halves
            the dense-cloud device→host transfer by casting on device —
            worthwhile on slow links; z quantizes to 1-2 mm at 2-4 m.
            Default keeps float64 output.
        """
        from ..geometry.distortion import pad_dist_coeffs

        rig = self.rig
        und, shadow = _load_stack(images, black, white, rig.intrinsic1,
                                  rig.distCoeffs1, rig.res1,
                                  self.num_patterns)
        cloud, valid = _graycode_cloud_device(
            und, jnp.asarray(rig.intrinsic2, jnp.float32),
            jnp.asarray(pad_dist_coeffs(rig.distCoeffs2)),
            jnp.asarray(self.Rectify1, jnp.float32),
            jnp.asarray(self.Rectify2, jnp.float32),
            jnp.asarray(self.R_inv[:3, :3], jnp.float32),
            jnp.float32(rig.getBaseline()),
            nx=self.nx, ny=self.ny, white_thr=self.white_thr,
            res2=tuple(rig.res2), black_thr=float(self.black_thr),
            shadow=shadow,
            roi=None if roi is None else tuple(int(v) for v in roi),
            out_dtype=(None if out_dtype is None
                       else np.dtype(out_dtype).name))
        valid = np.asarray(valid)
        cloud = np.asarray(cloud, np.float64 if out_dtype is None else None)
        ys, xs = np.nonzero(valid)
        return cloud[ys, xs].reshape(-1, 1, 3)


# Alias, parity: active.py:1461.
GrayCodeSingle = GrayCode


class GrayCodeDouble:
    """Two cameras + uncalibrated projector (parity: active.py:1463-1608,
    with the reference's latent bugs fixed — see module docstring).

    The projector is only a correspondence oracle: each camera decodes the
    projector pixel seen at every image pixel; camera-camera
    correspondences meeting at the same projector pixel are triangulated
    with the calibrated stereo rig.
    """

    def __init__(self, rig, projRes, black_thr=40, white_thr=5):
        self.rig = rig
        self.projRes = projRes
        self.black_thr = black_thr
        self.white_thr = white_thr
        self.nx = graycode_num_bits(projRes[0])
        self.ny = graycode_num_bits(projRes[1])
        self.num_patterns = 2 * (self.nx + self.ny)
        self.Rectify1, self.Rectify2, commonR = \
            rectification._lowLevelRectify(rig)
        R_inv = np.eye(4)
        R_inv[:3, :3] = np.linalg.inv(commonR)
        self.R_inv = R_inv

    def _decode_cam(self, images, K, dist, res, black=None, white=None):
        und, shadow = _load_stack(images, black, white, K, dist, res,
                                  self.num_patterns)
        px, py, valid = _decode_device(
            und, nx=self.nx, ny=self.ny, white_thr=self.white_thr,
            res2=tuple(self.projRes), black_thr=float(self.black_thr),
            shadow=shadow)
        return tuple(map(np.asarray, (px, py, valid)))

    def getCloud(self, images1, images2, roi=None, black1=None, white1=None,
                 black2=None, white2=None):
        """Triangulate; images1/images2 are the two cameras' captures.

        ``black1``/``white1`` (and ``black2``/``white2``): optional
        per-camera all-black / all-white captures for shadow-mask
        rejection (pixels with white-black < black_thr are not lit by the
        projector and are excluded; parity: active.py:1143-1147).
        """
        px1, py1, v1 = self._decode_cam(
            images1, self.rig.intrinsic1, self.rig.distCoeffs1,
            self.rig.res1, black=black1, white=white1)
        px2, py2, v2 = self._decode_cam(
            images2, self.rig.intrinsic2, self.rig.distCoeffs2,
            self.rig.res2, black=black2, white=white2)

        projW, projH = self.projRes
        # Correspondence volume: mean camera pixel per projector pixel.
        acc = np.zeros((projH, projW, 4))
        cnt = np.zeros((projH, projW, 2))
        for (px, py, v, k) in ((px1, py1, v1, 0), (px2, py2, v2, 1)):
            ys, xs = np.nonzero(v)
            np.add.at(acc[..., 2 * k], (py[ys, xs], px[ys, xs]),
                      xs + 0.5)
            np.add.at(acc[..., 2 * k + 1], (py[ys, xs], px[ys, xs]),
                      ys + 0.5)
            np.add.at(cnt[..., k], (py[ys, xs], px[ys, xs]), 1.0)
        both = (cnt[..., 0] > 0) & (cnt[..., 1] > 0)
        if roi is not None:
            pass  # roi filtering happens on camera-1 coordinates below
        c1 = acc[..., 0:2][both] / cnt[..., 0][both][:, None]
        c2 = acc[..., 2:4][both] / cnt[..., 1][both][:, None]
        if roi is not None:
            roi_x, roi_y, roi_w, roi_h = roi
            keep = ((c1[:, 0] >= roi_x) & (c1[:, 0] < roi_x + roi_w)
                    & (c1[:, 1] >= roi_y) & (c1[:, 1] < roi_y + roi_h))
            c1, c2 = c1[keep], c2[keep]

        p1 = npgeom.perspective_transform(c1, self.Rectify1)
        p2 = npgeom.perspective_transform(c2, self.Rectify2)
        p1 = np.hstack([p1, np.ones((len(p1), 1))])
        disparity = np.abs(p2[:, [0]] - p1[:, [0]])
        disparity[disparity < 1e-12] = np.nan
        pw = self.rig.getBaseline() * (p1 / disparity)
        out = npgeom.perspective_transform(pw.reshape(-1, 1, 3), self.R_inv)
        return out.reshape(-1, 1, 3)
