"""
ftp
===

Stereo Fourier Transform Profilometry (modified FTP with a virtual
reference plane) and its variants.

Parity target: /root/reference/simplestereo/active.py:351-841 (StereoFTP),
:844-1128 (StereoFTPAnaglyph), :1266-1450 (StereoFTP_Mapping),
:1703-2074 (StereoFTP_PhaseOnly). Method: P. Lafiosca et al., "Automated
Aircraft Dent Inspection via a Modified Fourier Transform Profilometry
Algorithm", Sensors 22(2):433, 2022.

Device/host split:

- dense work — camera undistortion, the projector-mapping grid, cubic
  remap of the virtual reference, the per-row FFT / band-pass / inverse
  FFT / phase pipeline — runs as jitted XLA programs;
- small control-plane geometry (stripe triangulation, per-row carrier
  frequency, the k-offset estimate) stays host-side float64 numpy.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .patterns import _getCentralPeak
from .stripe import findCentralStripe
from ..geometry import npgeom
from ..geometry.distortion import distort_normalized, pad_dist_coeffs
from .. import warp
from .. import rectification
from .. import unwrapping


@functools.partial(jax.jit, static_argnames=("res", "row_inv"))
def _projector_mapping_device(z, M, T, K2, dist2, fringe_gray, res,
                              row_inv=False):
    """Dense camera-grid -> projector mapping + virtual reference image.

    Implements the reference's double-grid trick (active.py:432-492): the
    linear map M = R @ K1^-1 sends camera pixel homogeneous coords to rays;
    scaling by z puts them on the reference plane; projecting through the
    projector (with its distortion) gives, for the half-pixel-centered
    grid, the exact projector coordinates, and for the integer grid, the
    sampling map of the virtual reference image.
    """
    w, h = res
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys)            # (h, w)

    # f32 matmuls may run at reduced precision (TF32 on a GPU); the pixel
    # coordinates here need full f32 (a 2e-3 relative error is pixels).
    prec = jax.lax.Precision.HIGHEST

    def project(gx, gy):
        p = jnp.stack([gx, gy, jnp.ones_like(gx)], axis=-1)   # (h, w, 3)
        q = z * jnp.einsum("ij,hwj->hwi", M, p, precision=prec) \
            + T[None, None, :]
        xy = q[..., :2] / q[..., 2:3]
        xyd = distort_normalized(xy.reshape(-1, 2), dist2).reshape(h, w, 2)
        u = K2[0, 0] * xyd[..., 0] + K2[0, 1] * xyd[..., 1] + K2[0, 2]
        v = K2[1, 1] * xyd[..., 1] + K2[1, 2]
        return u, v

    # half-pixel grid -> exact projector coordinates
    uc, vc = project(gx + 0.5, gy + 0.5)
    proj_coords = jnp.stack([uc, vc], axis=-1)
    # integer grid -> virtual reference image resampling map
    ui, vi = project(gx, gy)
    if row_inv:
        # Fringe rows are identical (checked host-side at init —
        # buildFringe patterns and the reference's committed fringe8.png
        # both are): sample ONE padded row with 4 cubic taps instead of
        # the 16-tap 2-D gather. Identical semantics incl. y-border
        # blending (f32-ulp agreement) — warp.remap_row_invariant.
        virtual_ref = warp.remap_row_invariant(fringe_gray, ui, vi,
                                               interpolation="cubic")
    else:
        virtual_ref = warp.remap(fringe_gray, ui, vi,
                                 interpolation="cubic")
    return proj_coords, virtual_ref


@jax.jit
def _phase_pipeline(img_obj, img_ref, fmin, fmax):
    """Row-FFT band-pass phase extraction (active.py:679-737).

    img_obj, img_ref : (H, W) float grayscale; fmin, fmax: (H,) per-row
    band edges in cycles/pixel. Returns the wrapped phase difference.
    """
    G0 = jnp.fft.fft(img_ref.astype(jnp.complex64), axis=1)
    G = jnp.fft.fft(img_obj.astype(jnp.complex64), axis=1)
    freqs = jnp.fft.fftfreq(img_obj.shape[1]).astype(jnp.float32)
    keep = ((freqs[None, :] - fmin[:, None] >= 0)
            & (freqs[None, :] - fmax[:, None] <= 0))
    G0 = jnp.where(keep, G0, 0)
    G = jnp.where(keep, G, 0)
    g0hat = jnp.fft.ifft(G0, axis=1)
    ghat = jnp.fft.ifft(G, axis=1)
    return jnp.angle(ghat * jnp.conjugate(g0hat))


@jax.jit
def _unwrap2d(phase):
    """np.unwrap along x then along y (active.py:739-743)."""
    p = unwrapping.unwrap(phase, axis=1)
    return unwrapping.unwrap(p, axis=0)


@functools.partial(jax.jit, static_argnames=("roi", "channel"))
def _prep_undistort_centroids(img, K1, dist1, thr, *, roi, channel):
    """Fused getCloud preamble: camera undistortion, static ROI crop and
    the per-row stripe-centroid reduction in ONE dispatch (one device
    round-trip instead of two). Returns the
    device-resident cropped frame and the (roi_h,) centroid vector — only
    the latter crosses to the host (NaN fill + stripe triangulation)."""
    from .stripe import _stripe_centroids_jit

    und = warp.undistort_image(img, K1, dist1)
    rx, ry, rw, rh = roi
    und = und[ry:ry + rh, rx:rx + rw]
    cents = _stripe_centroids_jit()(und, thr, channel)
    return und, cents


def _dense_cloud_rows(projCoords, phaseUnwrapped, k, ep, fp, K2, dist2,
                      Rect1, Rect2, R_inv3, baseline, roi_x, row0):
    """Dense epipolar triangulation over a row band (active.py:793-838).

    Every operation is per-pixel, so the band may be any contiguous row
    range of the ROI: ``row0`` is the *global* image row of the band's
    first row (traced — the row-sharded path passes ``roi_y + shard *
    rows_local``). Projector H points from phase, projector-optics
    re-distortion (iterative ``undistort_points``), rectification of both
    grids, disparity and depth. The reference runs this hottest stage on
    the host with cv2.undistortPoints over the full pixel grid; here the
    whole O(rows * roi_w) tail is jitted f32 XLA (the ~1e-3 px f32
    rounding is orders below the phase noise)."""
    from ..geometry import projection as gproj
    from ..geometry import distortion as gdist

    rows, roi_w = phaseUnwrapped.shape
    # full-f32 matmuls: reduced precision (TF32) costs whole pixels here
    with jax.default_matmul_precision("highest"):
        two_pi = 2 * jnp.pi
        phase = phaseUnwrapped + k * two_pi
        Xa = projCoords[..., 0]
        Ya = projCoords[..., 1]
        Xh = Xa + phase / (two_pi * fp)
        Yh = ((Xh - ep[0]) / (Xa - ep[0])) * (Ya - ep[1]) + ep[1]
        H = jnp.stack([Xh, Yh], -1).reshape(-1, 2)
        H = gdist.undistort_points(H, K2, dist2, P=K2)

        gx, gy = jnp.meshgrid(jnp.arange(roi_w, dtype=jnp.float32),
                              jnp.arange(rows, dtype=jnp.float32))
        pc = jnp.stack([gx + roi_x + 0.5, gy + row0 + 0.5],
                       -1).reshape(-1, 2)
        pc = gproj.perspective_transform(pc, Rect1)
        pp = gproj.perspective_transform(H, Rect2)
        disparity = jnp.abs(pp[:, :1] - pc[:, :1])
        pch = jnp.concatenate([pc, jnp.ones((pc.shape[0], 1), pc.dtype)], 1)
        pw = baseline * pch / jnp.where(disparity > 1e-12, disparity,
                                        jnp.nan)
        out = pw @ R_inv3.T
    return out.reshape(rows, roi_w, 3)


def _render_ftp_debug(dump, plot):
    """Render the getCloud debug dump (reference parity: the plot=True
    spectrum/phase windows at active.py:688-714, :747-755). ``plot`` may
    be True (interactive ``plt.show()``) or a path to save the figure to
    (headless-friendly extension)."""
    import matplotlib
    if plot is not True:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H, W = np.asarray(dump["phase_unwrapped"]).shape
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    row = H // 2
    freqs = np.fft.fftfreq(W)[: W // 2]
    for key, ax in (("spectrum", axes[0, 0]), ("spectrum_ref", axes[0, 1])):
        if key in dump:
            ax.plot(freqs, np.asarray(dump[key])[row, : W // 2])
            if "fmin" in dump and "fmax" in dump:
                ax.axvline(float(np.asarray(dump["fmin"])[row]), ls="--")
                ax.axvline(float(np.asarray(dump["fmax"])[row]), ls="--")
            ax.set_title(f"{key} (row {row})")
            ax.set_xlabel("cycles/pixel")
    im = axes[1, 0].imshow(np.asarray(dump["phase"]), cmap="twilight")
    axes[1, 0].set_title("wrapped phase")
    fig.colorbar(im, ax=axes[1, 0])
    im = axes[1, 1].imshow(np.asarray(dump["phase_unwrapped"]))
    axes[1, 1].set_title("unwrapped phase")
    fig.colorbar(im, ax=axes[1, 1])
    fig.tight_layout()
    if plot is True:
        plt.show()
    else:
        fig.savefig(plot, dpi=100)
        plt.close(fig)


@functools.partial(jax.jit, static_argnames=("roi",))
def _dense_cloud_device(projCoords, phaseUnwrapped, k, ep, fp, K2, dist2,
                        Rect1, Rect2, R_inv3, baseline, roi):
    """Whole-ROI wrapper of :func:`_dense_cloud_rows` (one device
    program)."""
    roi_x, roi_y, roi_w, roi_h = roi
    return _dense_cloud_rows(projCoords, phaseUnwrapped, k, ep, fp, K2,
                             dist2, Rect1, Rect2, R_inv3, baseline,
                             roi_x, jnp.float32(roi_y))


@functools.partial(jax.jit,
                   static_argnames=("res", "roi", "gray_mode", "debug",
                                    "out_dtype", "row_inv"))
def _ftp_cloud_fused(img_obj, z, M, T, K2, dist2, fringe_gray, fmin, fmax,
                     stripe_idx, peak, fp, ep, Rect1, Rect2, R_inv3,
                     baseline, *, res, roi, gray_mode, debug=False,
                     out_dtype=None, row_inv=False):
    """The whole post-stripe FTP pipeline as ONE device program:
    grayscale conversion, projector mapping + virtual reference, row-FFT
    band-pass phase, 2-D unwrap, fringe-order k from the stripe, dense
    epipolar triangulation. One dispatch instead of six."""
    roi_x, roi_y, roi_w, roi_h = roi
    if gray_mode == "br":  # StereoFTPAnaglyph: normalized B - R [Guo 1990]
        d = (img_obj[:, :, 0].astype(jnp.float32)
             - img_obj[:, :, 2].astype(jnp.float32))
        ptp = jnp.ptp(d)
        gray_obj = (d - jnp.min(d)) / jnp.where(ptp > 0, ptp, 1.0)
    elif gray_mode == "host":  # subclass-custom convertGrayscale, done on
        gray_obj = img_obj.astype(jnp.float32)    # the host; already 2-D
    else:                  # per-pixel max keeps the stripe white
        gray_obj = jnp.max(img_obj, axis=2).astype(jnp.float32)
    # nested jitted calls inline into this trace — still one dispatch
    proj_coords, virtual_ref = _projector_mapping_device(
        z, M, T, K2, dist2, fringe_gray, res=res, row_inv=row_inv)
    proj_coords = proj_coords[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
    virtual_ref = virtual_ref[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]

    phase = _phase_pipeline(gray_obj, virtual_ref, fmin, fmax)
    pu = _unwrap2d(phase)

    theta = pu[stripe_idx[:, 1], stripe_idx[:, 0]]
    u_A = proj_coords[stripe_idx[:, 1], stripe_idx[:, 0], 0]
    k = (peak - u_A) * fp - theta / (2 * jnp.pi)
    k = jnp.ceil(jnp.mean(k) - 0.5)

    cloud = _dense_cloud_device(
        proj_coords, pu, k, ep, fp, K2, dist2, Rect1, Rect2, R_inv3,
        baseline, roi=roi)
    if out_dtype is not None:
        # cast ON DEVICE: the cloud readback's bytes halve before the
        # transfer, not after.
        cloud = cloud.astype(out_dtype)
    if not debug:
        return cloud
    # Debug introspection (the reference's only FTP instrumentation is
    # its plot=True spectrum/phase windows, active.py:688-714, :747-755):
    # the row-FFT magnitudes recompute here, but XLA CSEs them against
    # the pipeline's own FFTs inside this single trace.
    dbg = dict(
        spectrum=jnp.abs(jnp.fft.fft(gray_obj.astype(jnp.complex64),
                                     axis=1)),
        spectrum_ref=jnp.abs(jnp.fft.fft(virtual_ref.astype(jnp.complex64),
                                         axis=1)),
        phase=phase, phase_unwrapped=pu, k=k)
    return cloud, dbg


@functools.partial(jax.jit,
                   static_argnames=("res", "roi", "gray_mode", "out_dtype",
                                    "row_inv"))
def _ftp_cloud_fused_batch(imgs, zs, M, T, K2, dist2, fringe_gray, fmins,
                           fmaxs, stripe_idxs, peak, fp, ep, Rect1, Rect2,
                           R_inv3, baseline, *, res, roi, gray_mode,
                           out_dtype=None, row_inv=False):
    """Frame-batched :func:`_ftp_cloud_fused`: the dense work of the
    whole (B, ...) stack is ONE device program. The FTP pipeline is pure
    XLA (FFTs, gathers, scans — no Pallas), so ``vmap`` is the correct
    batching transform here, unlike the matcher kernels where the frame
    axis must ride the Pallas grid. Per-frame inputs: the captures, the
    reference-plane depth, the band edges and the stripe indices; the
    rig geometry is shared."""
    def one(im, z, fmn, fmx, sidx):
        return _ftp_cloud_fused(
            im, z, M, T, K2, dist2, fringe_gray, fmn, fmx, sidx, peak,
            fp, ep, Rect1, Rect2, R_inv3, baseline, res=res, roi=roi,
            gray_mode=gray_mode, debug=False, out_dtype=out_dtype,
            row_inv=row_inv)

    return jax.vmap(one)(imgs, zs, fmins, fmaxs, stripe_idxs)


@functools.partial(jax.jit, static_argnames=("roi", "channel"))
def _prep_undistort_centroids_batch(imgs, K1, dist1, thr, *, roi,
                                    channel):
    """Batched :func:`_prep_undistort_centroids` (one dispatch for the
    whole frame stack)."""
    return jax.vmap(
        lambda im: _prep_undistort_centroids(im, K1, dist1, thr, roi=roi,
                                             channel=channel))(imgs)


class StereoFTP:
    """Stereo Fourier Transform Profilometry manager.

    Parameters (parity: active.py:379-401)
    ----------
    stereoRig : StereoRig
        Camera in position 1 (world origin), projector in position 2.
    fringe : numpy.ndarray
        The projected BGR fringe image (built by
        :func:`simplestereo_jax.active.buildFringe` with a central stripe).
    period : float
        Fringe period on the projector, in pixels.
    shift, stripeColor, stripeSensitivity : see the reference.
    """

    _GRAY_MODE = "max"  # fused-path grayscale (see convertGrayscale)

    def __init__(self, stereoRig, fringe, period, shift=0,
                 stripeColor="red", stripeSensitivity=0.5):
        self.stereoRig = stereoRig
        fringe = np.asarray(fringe)
        # The reference fringe must be grayscaled by the SAME hook that
        # will grayscale the camera captures (see _grayscale_plan) —
        # mixing hooks would mismatch the object and reference phases.
        if self._grayscale_plan() == "device":
            self.fringe = np.asarray(
                self.convertGrayscaleDevice(jnp.asarray(fringe)),
                np.float64)
        else:
            self.fringe = self.convertGrayscale(fringe)
        self.fringeDims = fringe.shape[:2][::-1]
        # Row-invariant fringe (every grayscale row identical — true for
        # buildFringe patterns and the reference's committed fringe8.png)
        # unlocks the 1-D virtual-reference resample fast path in the
        # fused pipeline (warp.remap_row_invariant: 4 1-D taps in place of
        # the 16-tap 2-D cubic gather).
        fg = np.asarray(self.fringe)
        self._fringe_row_inv = bool(
            fg.ndim == 2 and np.array_equal(
                fg, np.broadcast_to(fg[0:1], fg.shape)))
        self.fp = 1.0 / period
        self.stripeColor = stripeColor
        self.stripeSensitivity = stripeSensitivity
        self.stripeCentralPeak = _getCentralPeak(
            self.fringeDims[0], period, shift)
        self.F = np.asarray(stereoRig.getFundamentalMatrix(), np.float64)
        self.Rectify1, self.Rectify2, commonR = \
            rectification._lowLevelRectify(stereoRig)
        # epipole on the projector: camera center projected to it
        ep = np.asarray(stereoRig.intrinsic2, np.float64) @ \
            np.asarray(stereoRig.T, np.float64).reshape(3, 1)
        self.ep = (ep / ep[2]).ravel()
        R_inv = np.eye(4)
        R_inv[:3, :3] = np.linalg.inv(commonR)
        self.R_inv = R_inv

    @staticmethod
    def convertGrayscale(img):
        """Max over channels: keeps the stripe white (active.py:404-429)."""
        img = np.asarray(img)
        if img.ndim == 2:
            return img.astype(np.float64)
        return np.max(img, axis=2).astype(np.float64)

    @staticmethod
    def convertGrayscaleDevice(img):
        """Device twin of :meth:`convertGrayscale` (jnp, stays on device)."""
        if img.ndim == 2:
            return img.astype(jnp.float32)
        return jnp.max(img, axis=2).astype(jnp.float32)

    # -- internals ---------------------------------------------------------

    def _grayscale_plan(self):
        """Which grayscale hook governs the fused path.

        The fused pipeline's fast path keys off the static ``_GRAY_MODE``
        string. A subclass may instead override :meth:`convertGrayscale`
        (the reference's documented customization point, active.py:404-429
        — exactly how the reference's ``StereoFTPAnaglyph`` works) and/or
        its device twin :meth:`convertGrayscaleDevice` WITHOUT declaring a
        matching ``_GRAY_MODE``; both overrides must be honored, not
        silently dropped. Returns:

        - ``"mode"`` — ``_GRAY_MODE`` is declared at least as deep in the
          MRO as any function override: use the fast fused branch;
        - ``"device"`` — ``convertGrayscaleDevice`` is the deepest
          override: apply it on device and feed the 2-D gray frame in;
        - ``"host"`` — only ``convertGrayscale`` is overridden: apply it
          on the host.
        """
        mro = type(self).__mro__

        def depth(name):
            for i, c in enumerate(mro):
                if name in c.__dict__:
                    return i
            return len(mro)

        dm = depth("_GRAY_MODE")
        ddev = depth("convertGrayscaleDevice")
        dhost = depth("convertGrayscale")
        if dm <= min(ddev, dhost):
            return "mode"
        return "device" if ddev <= dhost else "host"

    def _customGrayscale(self):
        """True when a grayscale override bypasses the ``_GRAY_MODE``
        fast path (see :meth:`_grayscale_plan`)."""
        return self._grayscale_plan() != "mode"

    def _getProjectorMapping(self, z):
        rig = self.stereoRig
        M = (np.asarray(rig.R, np.float64)
             @ np.linalg.inv(np.asarray(rig.intrinsic1, np.float64)))
        proj_coords, virtual_ref = _projector_mapping_device(
            jnp.float32(z), jnp.asarray(M, jnp.float32),
            jnp.asarray(np.asarray(rig.T, np.float64).ravel(), jnp.float32),
            jnp.asarray(rig.intrinsic2, jnp.float32),
            jnp.asarray(pad_dist_coeffs(rig.distCoeffs2)),
            jnp.asarray(self.fringe, jnp.float32),
            res=tuple(rig.res1), row_inv=self._fringe_row_inv)
        return proj_coords, virtual_ref  # device-resident (h, w, 2)/(h, w)

    def _calculateCameraFrequency(self, objPoints):
        """Per-point carrier frequency on the camera (active.py:495-559)."""
        rig = self.stereoRig
        Ac = np.asarray(rig.intrinsic1, np.float64)
        Dc = rig.distCoeffs1
        Ap = np.asarray(rig.intrinsic2, np.float64)
        R = np.asarray(rig.R, np.float64)
        T = np.asarray(rig.T, np.float64).reshape(3, 1)
        Dp = rig.distCoeffs2

        Op = (-np.linalg.inv(R) @ T).ravel()
        objPoints = np.asarray(objPoints, np.float64).reshape(-1, 3)
        n = len(objPoints)

        pCenter = npgeom.project_points(
            objPoints, npgeom.matrix_to_rodrigues(R), T.ravel(), Ap, Dp)
        half = (1.0 / self.fp) / 2.0
        pts = np.vstack([
            np.stack([pCenter[:, 0] - half, pCenter[:, 1]], 1),
            np.stack([pCenter[:, 0] + half, pCenter[:, 1]], 1)])
        # "undistort" = apply inverse-pinhole projector optics
        pts = npgeom.undistort_points(pts, Ap, Dp, P=Ap)
        invARp = np.linalg.inv(Ap @ R)
        pp = np.hstack([pts, np.ones((2 * n, 1))])
        z = np.tile(objPoints[:, 2].reshape(-1, 1), (2, 1))
        hvec = (invARp @ pp.T).T
        s = (z - Op[2]) / hvec[:, [2]]
        pw = s * hvec + Op.reshape(1, 3)
        pc = npgeom.project_points(
            pw, np.zeros(3), np.zeros(3), Ac, Dc)
        a, b = pc[:n], pc[n:]
        Tc = (((a[:, 0] - b[:, 0]) ** 2 + (a[:, 1] - b[:, 1]) ** 2)
              / np.abs(a[:, 0] - b[:, 0]))
        return 1.0 / Tc

    def _triangulate(self, camPoints, p_x, roi):
        """Stripe triangulation via the epipolar line (active.py:561-605)."""
        rig = self.stereoRig
        camPoints = np.asarray(camPoints, np.float64).reshape(-1, 2).copy()
        n = len(camPoints)
        camPoints[:, 0] += roi[0]
        camPoints[:, 1] += roi[1]
        lines = np.hstack([camPoints, np.ones((n, 1))]) @ self.F.T
        if np.isscalar(p_x):
            p_x = np.full(n, float(p_x))
        p_x = np.asarray(p_x, np.float64).ravel()
        p_y = -(lines[:, 0] * p_x + lines[:, 2]) / lines[:, 1]
        projPoints = np.stack([p_x, p_y], 1)

        pc = npgeom.perspective_transform(camPoints, self.Rectify1)
        pp = npgeom.undistort_points(
            projPoints, rig.intrinsic2, rig.distCoeffs2, P=rig.intrinsic2)
        pp = npgeom.perspective_transform(pp, self.Rectify2)
        disparity = np.abs(pp[:, [0]] - pc[:, [0]])
        pc = np.hstack([pc, np.ones((n, 1))])
        pw = rig.getBaseline() * (pc / np.where(disparity > 1e-12,
                                                disparity, np.nan))
        return npgeom.perspective_transform(
            pw.reshape(-1, 1, 3), self.R_inv).reshape(-1, 3)

    # -- main entry --------------------------------------------------------

    def _cloud_prep(self, imgObj, radius_factor, roi):
        """Host preamble shared by :meth:`getCloud` and the row-sharded
        :func:`simplestereo_jax.parallel.sharded_ftp_cloud`: undistort,
        ROI crop, central-stripe carrier estimation, grayscale plan.
        Returns a dict of everything the fused device pipeline needs."""
        from .stripe import _CHANNEL, _centroids_to_stripe

        imgObj = np.asarray(imgObj)
        if imgObj.ndim != 3:
            raise ValueError("image must be a BGR color image!")
        if not 0 <= self.stripeSensitivity <= 1:
            raise ValueError("Threshold must be in the interval [0,1]!")
        if self.stripeColor not in _CHANNEL:
            raise ValueError("Color value not permitted!")
        rig = self.stereoRig
        widthC, heightC = rig.res1
        if roi is None:
            roi = (0, 0, widthC, heightC)
        roi_x, roi_y, roi_w, roi_h = roi

        # Device-resident from here: the undistorted frame never crosses
        # back to the host (the reference round-trips every dense stage).
        # Undistort + ROI crop + stripe centroids are ONE dispatch; only
        # the (roi_h,) centroid vector crosses for the host fill.
        dt = np.dtype(imgObj.dtype)
        max_value = np.iinfo(dt).max if dt.kind in "iu" else 1.0
        imgObj, cents = _prep_undistort_centroids(
            jnp.asarray(imgObj), jnp.asarray(rig.intrinsic1, jnp.float32),
            None if rig.distCoeffs1 is None
            else jnp.asarray(np.asarray(rig.distCoeffs1, np.float64).ravel()),
            jnp.float32(max_value * self.stripeSensitivity),
            roi=tuple(int(v) for v in roi),
            channel=_CHANNEL[self.stripeColor])
        stripe_cam = _centroids_to_stripe(np.asarray(cents, np.float64),
                                          roi_h)
        if stripe_cam is None:
            raise ValueError("Central stripe not found in image!")
        stripe_cam = stripe_cam.reshape(-1, 2)
        stripe_idx = np.ceil(stripe_cam - 0.5).astype(np.int64)
        stripe_world = self._triangulate(
            stripe_cam.copy(), self.stripeCentralPeak, roi)
        z_plane = float(np.nanmean(stripe_world[:, 2]))
        fc = self._calculateCameraFrequency(stripe_world)

        radius = radius_factor * fc
        rigM = (np.asarray(rig.R, np.float64)
                @ np.linalg.inv(np.asarray(rig.intrinsic1, np.float64)))

        # Subclass with a custom grayscale (the reference's documented
        # customization point): honor it by converting up front (device
        # twin preferred, host fallback) and feeding the 2-D frame in.
        plan = self._grayscale_plan()
        if plan == "device":
            gray_mode = "host"  # fused path consumes the 2-D frame as-is
            imgObj = self.convertGrayscaleDevice(
                jnp.asarray(imgObj)).astype(jnp.float32)
        elif plan == "host":
            gray_mode = "host"
            imgObj = jnp.asarray(np.asarray(
                self.convertGrayscale(np.asarray(imgObj)), np.float32))
        else:
            gray_mode = self._GRAY_MODE

        return dict(imgObj=imgObj, roi=roi, stripe_idx=stripe_idx,
                    z_plane=z_plane, fc=fc, radius=radius, rigM=rigM,
                    gray_mode=gray_mode)

    def getCloud(self, imgObj, radius_factor=0.5, roi=None,
                 unwrappingMethod=None, plot=False, dump=None,
                 out_dtype=None):
        """Process one camera image into a point cloud
        (roi_h, roi_w, 3). Parity: active.py:608-841.

        Debug introspection (the reference's ``plot=True`` spectrum/phase
        windows, active.py:688-714): pass a dict as ``dump`` to receive
        the row-FFT magnitude spectra of the object and virtual-reference
        frames, the wrapped and unwrapped phase maps, the per-row band
        edges and the fringe order k; ``plot=True`` shows the same
        panels interactively, ``plot="path.png"`` saves them (headless).

        out_dtype : optional numpy dtype for the returned cloud. Default
            (None) keeps the reference's float64. ``np.float16`` halves
            the device->host transfer by casting on device; at typical
            scan depths (z ~ 2-4 m in mm units) f16 quantizes z to 1-2 mm,
            comparable to the phase noise floor.
        """
        rig = self.stereoRig
        debug = bool(plot) or dump is not None
        prep = self._cloud_prep(imgObj, radius_factor, roi)
        imgObj, roi, stripe_idx = (prep["imgObj"], prep["roi"],
                                   prep["stripe_idx"])
        z_plane, fc, radius = prep["z_plane"], prep["fc"], prep["radius"]
        rigM, gray_mode = prep["rigM"], prep["gray_mode"]
        roi_x, roi_y, roi_w, roi_h = roi

        if unwrappingMethod is None:
            # whole post-stripe pipeline in one device dispatch
            out = _ftp_cloud_fused(
                jnp.asarray(imgObj),
                jnp.float32(z_plane), jnp.asarray(rigM, jnp.float32),
                jnp.asarray(np.asarray(rig.T, np.float64).ravel(),
                            jnp.float32),
                jnp.asarray(rig.intrinsic2, jnp.float32),
                jnp.asarray(pad_dist_coeffs(rig.distCoeffs2)),
                jnp.asarray(self.fringe, jnp.float32),
                jnp.asarray(fc - radius, jnp.float32),
                jnp.asarray(fc + radius, jnp.float32),
                jnp.asarray(stripe_idx, jnp.int32),
                jnp.float32(self.stripeCentralPeak), jnp.float32(self.fp),
                jnp.asarray(self.ep, jnp.float32),
                jnp.asarray(self.Rectify1, jnp.float32),
                jnp.asarray(self.Rectify2, jnp.float32),
                jnp.asarray(self.R_inv[:3, :3], jnp.float32),
                jnp.float32(rig.getBaseline()),
                res=tuple(rig.res1), roi=tuple(int(v) for v in roi),
                gray_mode=gray_mode, debug=debug,
                out_dtype=(None if out_dtype is None
                           else np.dtype(out_dtype).name),
                row_inv=self._fringe_row_inv)
            if debug:
                finalPoints, dbg = out
                dbg = {kk: np.asarray(v) for kk, v in dbg.items()}
                dbg["fmin"] = np.asarray(fc - radius)
                dbg["fmax"] = np.asarray(fc + radius)
                if dump is not None:
                    dump.update(dbg)
                if plot:
                    _render_ftp_debug(dbg, plot)
            else:
                finalPoints = out
            return np.asarray(finalPoints,
                              np.float64 if out_dtype is None else None)

        # custom unwrapping callback: staged path with a host round-trip
        imgObj_gray = self.convertGrayscaleDevice(imgObj)
        projCoords, imgR_gray = self._getProjectorMapping(z_plane)
        imgR_gray = imgR_gray[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        projCoords = projCoords[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]

        phase = _phase_pipeline(
            jnp.asarray(imgObj_gray, jnp.float32),
            jnp.asarray(imgR_gray, jnp.float32),
            jnp.asarray(fc - radius, jnp.float32),
            jnp.asarray(fc + radius, jnp.float32))

        phaseUnwrapped = jnp.asarray(
            unwrappingMethod(np.asarray(phase)), jnp.float32)

        # integer fringe order k from the stripe (active.py:779-791);
        # small gathers -> host scalars
        theta = np.asarray(
            phaseUnwrapped[stripe_idx[:, 1], stripe_idx[:, 0]], np.float64)
        u_A = np.asarray(
            projCoords[stripe_idx[:, 1], stripe_idx[:, 0], 0], np.float64)
        k = (self.stripeCentralPeak - u_A) * self.fp - theta / (2 * np.pi)
        k = float(np.ceil(np.mean(k) - 0.5))

        if debug:
            dbg = dict(
                spectrum=np.abs(np.fft.fft(np.asarray(imgObj_gray),
                                           axis=1)),
                spectrum_ref=np.abs(np.fft.fft(np.asarray(imgR_gray),
                                               axis=1)),
                phase=np.asarray(phase),
                phase_unwrapped=np.asarray(phaseUnwrapped),
                k=np.float32(k), fmin=np.asarray(fc - radius),
                fmax=np.asarray(fc + radius))
            if dump is not None:
                dump.update(dbg)
            if plot:
                _render_ftp_debug(dbg, plot)

        # projector H points + dense epipolar triangulation
        # (active.py:793-838) fused into one device program
        finalPoints = _dense_cloud_device(
            projCoords, phaseUnwrapped, jnp.float32(k),
            jnp.asarray(self.ep, jnp.float32), jnp.float32(self.fp),
            jnp.asarray(rig.intrinsic2, jnp.float32),
            jnp.asarray(pad_dist_coeffs(rig.distCoeffs2)),
            jnp.asarray(self.Rectify1, jnp.float32),
            jnp.asarray(self.Rectify2, jnp.float32),
            jnp.asarray(self.R_inv[:3, :3], jnp.float32),
            jnp.float32(rig.getBaseline()), roi=tuple(int(v) for v in roi))
        if out_dtype is not None:
            return np.asarray(jax.device_get(
                finalPoints.astype(np.dtype(out_dtype).name)))
        return np.asarray(finalPoints, np.float64)

    def getCloudBatch(self, imgs, radius_factor=0.5, roi=None,
                      out_dtype=None):
        """Throughput form of :meth:`getCloud`: a (B, H, W, 3) capture
        stack → (B, roi_h, roi_w, 3) clouds.

        The dense work of the whole stack runs as TWO device programs
        regardless of B (batched undistort+stripe-centroids, then the
        batched fused pipeline — the FTP stages are pure XLA, so the
        frame axis is a plain ``vmap``); per-call dispatch latency is
        paid once per batch. The per-frame host control plane (stripe
        fill, triangulation, carrier frequency) runs between them. No
        reference analog (active.py's pipeline is strictly one frame per
        call)."""
        from .stripe import _CHANNEL, _centroids_to_stripe

        imgs = np.asarray(imgs)
        if imgs.ndim != 4 or imgs.shape[-1] != 3:
            raise ValueError("imgs must be a (B, H, W, 3) BGR stack!")
        # same stripe-parameter contract as the single-frame _cloud_prep
        if not 0 <= self.stripeSensitivity <= 1:
            raise ValueError("Threshold must be in the interval [0,1]!")
        if self.stripeColor not in _CHANNEL:
            raise ValueError("Color value not permitted!")
        if isinstance(self, StereoFTP_Mapping):
            # the classic no-virtual-reference pipeline (its getCloud
            # maps phase straight to projector x) — silently running the
            # base fused pipeline here would triangulate wrong geometry
            raise TypeError(
                "StereoFTP_Mapping uses the classic no-virtual-reference "
                "pipeline; getCloudBatch covers StereoFTP/"
                "StereoFTPAnaglyph — loop getCloud per frame instead")
        if self._customGrayscale():
            # custom-grayscale subclasses take the per-frame path (their
            # hooks are host/device functions of a single frame)
            return np.stack([
                self.getCloud(im, radius_factor=radius_factor, roi=roi,
                              out_dtype=out_dtype) for im in imgs])
        rig = self.stereoRig
        widthC, heightC = rig.res1
        if roi is None:
            roi = (0, 0, widthC, heightC)
        roi_h = int(roi[3])

        dt = np.dtype(imgs.dtype)
        max_value = np.iinfo(dt).max if dt.kind in "iu" else 1.0
        und, cents = _prep_undistort_centroids_batch(
            jnp.asarray(imgs), jnp.asarray(rig.intrinsic1, jnp.float32),
            None if rig.distCoeffs1 is None
            else jnp.asarray(np.asarray(rig.distCoeffs1,
                                        np.float64).ravel()),
            jnp.float32(max_value * self.stripeSensitivity),
            roi=tuple(int(v) for v in roi),
            channel=_CHANNEL[self.stripeColor])
        cents = np.asarray(cents, np.float64)

        zs, fmins, fmaxs, sidxs = [], [], [], []
        for b in range(imgs.shape[0]):
            stripe_cam = _centroids_to_stripe(cents[b], roi_h)
            if stripe_cam is None:
                raise ValueError(
                    f"Central stripe not found in image {b}!")
            stripe_cam = stripe_cam.reshape(-1, 2)
            sidxs.append(np.ceil(stripe_cam - 0.5).astype(np.int64))
            stripe_world = self._triangulate(
                stripe_cam.copy(), self.stripeCentralPeak, roi)
            zs.append(float(np.nanmean(stripe_world[:, 2])))
            fc = self._calculateCameraFrequency(stripe_world)
            radius = radius_factor * fc
            fmins.append(fc - radius)
            fmaxs.append(fc + radius)

        rigM = (np.asarray(rig.R, np.float64)
                @ np.linalg.inv(np.asarray(rig.intrinsic1, np.float64)))
        clouds = _ftp_cloud_fused_batch(
            und, jnp.asarray(np.asarray(zs), jnp.float32),
            jnp.asarray(rigM, jnp.float32),
            jnp.asarray(np.asarray(rig.T, np.float64).ravel(),
                        jnp.float32),
            jnp.asarray(rig.intrinsic2, jnp.float32),
            jnp.asarray(pad_dist_coeffs(rig.distCoeffs2)),
            jnp.asarray(self.fringe, jnp.float32),
            jnp.asarray(np.stack(fmins), jnp.float32),
            jnp.asarray(np.stack(fmaxs), jnp.float32),
            jnp.asarray(np.stack(sidxs), jnp.int32),
            jnp.float32(self.stripeCentralPeak), jnp.float32(self.fp),
            jnp.asarray(self.ep, jnp.float32),
            jnp.asarray(self.Rectify1, jnp.float32),
            jnp.asarray(self.Rectify2, jnp.float32),
            jnp.asarray(self.R_inv[:3, :3], jnp.float32),
            jnp.float32(rig.getBaseline()),
            res=tuple(rig.res1), roi=tuple(int(v) for v in roi),
            gray_mode=self._GRAY_MODE,
            out_dtype=(None if out_dtype is None
                       else np.dtype(out_dtype).name),
            row_inv=self._fringe_row_inv)
        return np.asarray(clouds,
                          np.float64 if out_dtype is None else None)


class StereoFTPAnaglyph(StereoFTP):
    """FTP with the anaglyph fringe of :func:`buildAnaglyphFringe`
    (parity: active.py:844-1128): grayscale is the normalized B - R
    difference [Guo 1990], which suppresses the DC term."""

    _GRAY_MODE = "br"

    @staticmethod
    def convertGrayscale(img):
        img = np.asarray(img)
        if img.ndim == 2:
            return img.astype(np.float64)
        d = img[:, :, 0].astype(np.float64) - img[:, :, 2].astype(np.float64)
        ptp = np.ptp(d)
        return (d - d.min()) / (ptp if ptp > 0 else 1.0)

    @staticmethod
    def convertGrayscaleDevice(img):
        if img.ndim == 2:
            return img.astype(jnp.float32)
        d = img[:, :, 0].astype(jnp.float32) - img[:, :, 2].astype(jnp.float32)
        ptp = jnp.ptp(d)
        return (d - jnp.min(d)) / jnp.where(ptp > 0, ptp, 1.0)


class StereoFTP_Mapping(StereoFTP):
    """Classic (no virtual reference) FTP mapping variant
    (parity: active.py:1266-1450): band-passes the object image only,
    derives the absolute phase offset from the stripe, and maps phase
    directly to projector x coordinates."""

    def getCloud(self, imgObj, radius_factor=0.5, roi=None,
                 unwrappingMethod=None, plot=False, dump=None,
                 out_dtype=None):
        imgObj = np.asarray(imgObj)
        if imgObj.ndim != 3:
            raise ValueError("image must be a BGR color image!")
        rig = self.stereoRig
        widthC, heightC = rig.res1
        debug = bool(plot) or dump is not None
        imgObj = np.asarray(warp.undistort_image(
            imgObj, rig.intrinsic1, rig.distCoeffs1))
        if roi is not None:
            roi_x, roi_y, roi_w, roi_h = roi
            imgObj = imgObj[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        else:
            roi = (0, 0, widthC, heightC)
            roi_x, roi_y, roi_w, roi_h = roi

        stripe_cam = findCentralStripe(imgObj, self.stripeColor,
                                       self.stripeSensitivity)
        if stripe_cam is None:
            raise ValueError("Central stripe not found in image!")
        stripe_cam = stripe_cam.reshape(-1, 2)
        stripe_idx = np.ceil(stripe_cam - 0.5).astype(np.int64)
        stripe_world = self._triangulate(
            stripe_cam.copy(), self.stripeCentralPeak, roi)
        fc = self._calculateCameraFrequency(stripe_world)

        imgObj_gray = self.convertGrayscale(imgObj)
        # object-only band-pass: reference phase is the pure carrier
        radius = radius_factor * fc
        G = np.fft.fft(imgObj_gray, axis=1)
        spectrum = np.abs(G) if debug else None
        freqs = np.fft.fftfreq(roi_w)
        keep = ((freqs[None, :] - (fc - radius)[:, None] >= 0)
                & (freqs[None, :] - (fc + radius)[:, None] <= 0))
        G[~keep] = 0
        ghat = np.fft.ifft(G, axis=1)
        phase_w = np.angle(ghat)
        if unwrappingMethod is None:
            phase = np.unwrap(phase_w, axis=1)
            phase = np.unwrap(phase, axis=0)
        else:
            phase = unwrappingMethod(phase_w)
        if debug:
            dbg = dict(spectrum=spectrum, phase=phase_w,
                       phase_unwrapped=phase, fmin=fc - radius,
                       fmax=fc + radius)
            if dump is not None:
                dump.update(dbg)
            if plot:
                _render_ftp_debug(dbg, plot)

        # absolute phase via the mean phase at the stripe
        theta = phase[stripe_idx[:, 1], stripe_idx[:, 0]]
        phase = phase - np.mean(theta)
        # projector x coordinate from phase (active.py:1441)
        Xp = phase.reshape(-1, 1) / (2 * np.pi * self.fp) \
            + self.stripeCentralPeak

        gx, gy = np.meshgrid(np.arange(roi_w), np.arange(roi_h))
        cam = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float64) + 0.5
        pts = self._triangulate(cam, Xp.ravel(), roi)
        pts = pts.reshape(roi_h, roi_w, 3)
        # keep the base-class getCloud contract (polymorphic callers)
        return pts if out_dtype is None else pts.astype(out_dtype)


class StereoFTP_PhaseOnly(StereoFTP):
    """Phase-map-only variant (parity: active.py:1703-2074, experimental
    in the reference): same pipeline as :class:`StereoFTP` but stops
    after unwrapping, returning the phase map."""

    def getPhase(self, imgObj, radius_factor=0.5, roi=None,
                 unwrappingMethod=None, plot=False):
        imgObj = np.asarray(imgObj)
        if imgObj.ndim != 3:
            raise ValueError("image must be a BGR color image!")
        rig = self.stereoRig
        widthC, heightC = rig.res1
        imgObj = np.asarray(warp.undistort_image(
            imgObj, rig.intrinsic1, rig.distCoeffs1))
        if roi is not None:
            roi_x, roi_y, roi_w, roi_h = roi
            imgObj = imgObj[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        else:
            roi = (0, 0, widthC, heightC)
            roi_x, roi_y, roi_w, roi_h = roi

        stripe_cam = findCentralStripe(imgObj, self.stripeColor,
                                       self.stripeSensitivity)
        if stripe_cam is None:
            raise ValueError("Central stripe not found in image!")
        stripe_world = self._triangulate(
            stripe_cam.reshape(-1, 2).copy(), self.stripeCentralPeak, roi)
        z_plane = float(np.nanmean(stripe_world[:, 2]))
        fc = self._calculateCameraFrequency(stripe_world)

        projCoords, imgR_gray = self._getProjectorMapping(z_plane)
        imgR_gray = imgR_gray[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        imgObj_gray = self.convertGrayscale(imgObj)
        radius = radius_factor * fc
        phase = np.asarray(_phase_pipeline(
            jnp.asarray(imgObj_gray, jnp.float32),
            jnp.asarray(imgR_gray, jnp.float32),
            jnp.asarray(fc - radius, jnp.float32),
            jnp.asarray(fc + radius, jnp.float32)))
        if unwrappingMethod is None:
            return np.asarray(_unwrap2d(jnp.asarray(phase, jnp.float32)))
        return unwrappingMethod(phase)
