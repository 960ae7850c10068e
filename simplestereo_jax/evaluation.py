"""
evaluation
==========

Middlebury-style disparity-map quality metrics.

The reference ships the ingredients for this — Tsukuba ground truth and
the non-occluded mask (``examples/res/tsukuba/{groundtruth,nonocc}.png``,
consumed visually by ``/root/reference/examples/010
StereoMatchingTsukuba.py:43-53``) — but never the evaluation itself.
This module packages the standard metric family (bad-pixel rates, average
absolute error, RMS, density) as the single source of truth used by
``bench.py``, ``chip_smoke.py`` and the golden tests, plus
:func:`layered_scene`, a seeded stereo pair of known disparity for
accuracy gates that need no external data.

All of it is host-side numpy: evaluation is not a hot path, and the
inputs are final (already read back) disparity maps.
"""

import numpy as np

__all__ = ["evaluate_disparity", "tsukuba_scale", "layered_scene"]

# The Tsukuba ground-truth PNG stores disparity * 16 (like the golden
# disparityASW.png it ships next to); pass gt_scale=tsukuba_scale for it.
tsukuba_scale = 1.0 / 16.0


def evaluate_disparity(disp, gt, mask=None, *, bad_thresholds=(0.5, 1.0, 2.0, 4.0),
                       invalid=None, disp_scale=1.0, gt_scale=1.0,
                       count_invalid_as_bad=True):
    """Evaluate a disparity map against ground truth.

    Parameters
    ----------
    disp : array_like (H, W)
        Estimated disparity. Fixed-point maps (e.g. :class:`StereoSGM`'s
        OpenCV-convention output, disparity*16) are rescaled by
        ``disp_scale`` (1/16 for SGM output).
    gt : array_like (H, W)
        Ground-truth disparity, rescaled by ``gt_scale``
        (:data:`tsukuba_scale` for the reference's Tsukuba PNG).
    mask : array_like (H, W) of bool, optional
        Evaluation domain (e.g. the non-occluded mask). Default: all
        pixels where ``gt > 0``.
    bad_thresholds : sequence of float
        Thresholds t for the ``bad{t}`` fraction |disp - gt| > t
        (Middlebury bad-0.5/1.0/2.0/4.0 convention).
    invalid : float, optional
        Marker value for invalid pixels in ``disp`` *before* rescaling
        (e.g. ``(minDisparity - 1) * 16`` for SGM, ``-1`` for consistent
        ASW). ``None`` treats every pixel as valid.
    disp_scale, gt_scale : float
        Multipliers applied to ``disp`` / ``gt`` before comparison.
    count_invalid_as_bad : bool
        If True (Middlebury "dense" semantics) invalid pixels inside the
        mask count as bad at every threshold and enter no error average;
        if False they are excluded from all metrics (sparse semantics).

    Returns
    -------
    dict
        ``density`` (valid fraction of the mask), ``bad{t}`` per
        threshold, ``avgerr`` (mean |err| over valid), ``rms``, and
        ``n`` (mask pixel count). Error stats are NaN when nothing is
        valid.
    """
    disp = np.asarray(disp)
    gt = np.asarray(gt)
    if disp.shape != gt.shape:
        raise ValueError(
            f"disp {disp.shape} and gt {gt.shape} shapes differ!")
    if mask is None:
        mask = np.asarray(gt, np.float64) * gt_scale > 0
    else:
        mask = np.asarray(mask).astype(bool)
        if mask.shape != disp.shape:
            raise ValueError(
                f"mask {mask.shape} and disp {disp.shape} shapes differ!")

    valid = np.ones(disp.shape, bool) if invalid is None \
        else disp != invalid
    d = disp.astype(np.float64) * disp_scale
    g = gt.astype(np.float64) * gt_scale
    err = np.abs(d - g)

    n = int(mask.sum())
    vm = valid & mask
    nv = int(vm.sum())
    out = {"n": n, "density": nv / n if n else float("nan")}
    denom = n if count_invalid_as_bad else nv
    for t in bad_thresholds:
        bad = int(((err > t) & vm).sum())
        if count_invalid_as_bad:
            bad += n - nv
        key = f"bad{t:g}"
        out[key] = bad / denom if denom else float("nan")
    out["avgerr"] = float(err[vm].mean()) if nv else float("nan")
    out["rms"] = float(np.sqrt((err[vm] ** 2).mean())) if nv else float("nan")
    return out


def layered_scene(height, width, seed=0, background=(5.0, 8.0),
                  foreground=(10.0, 13.0), n_rects=3):
    """Seeded rectified stereo pair with known, piecewise-planar disparity.

    The scene is a background plane whose left-view disparity runs
    linearly from ``background[0]`` (left edge) to ``background[1]``
    (right edge) and ``n_rects`` rectangles in front of it, each a plane
    of constant disparity drawn from ``foreground``. Every layer carries
    its own smoothed random color texture. The right view is rendered by
    sampling each layer at ``x_left = x_right + d`` (linear
    interpolation), the nearest layer winning.

    Returns
    -------
    left, right : (height, width, 3) uint8 BGR
    gt : (height, width) float64 disparity of the left view
    nonocc : (height, width) bool — left pixels also visible in the right
        view at their ground-truth position
    """
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    H, W = height, width
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    # (a, b, rows, cols): disparity a + b * x_left on the left-view box
    layers = [(background[0],
               (background[1] - background[0]) / max(W - 1, 1),
               (0, H), (0, W))]
    for d in np.sort(rng.uniform(*foreground, n_rects)):
        h = int(rng.uniform(0.2, 0.4) * H)
        w = int(rng.uniform(0.15, 0.3) * W)
        y0 = int(rng.integers(0, H - h))
        x0 = int(rng.integers(0, W - w))
        layers.append((float(d), 0.0, (y0, y0 + h), (x0, x0 + w)))

    def texture():
        t = gaussian_filter(rng.uniform(0, 255, (H, W, 3)), (1.0, 1.0, 0))
        t = (t - t.mean()) / (t.std() + 1e-9)
        return np.clip(128 + 45 * t + rng.uniform(-40, 40, 3), 0, 255)

    left = np.zeros((H, W, 3))
    right = np.zeros((H, W, 3))
    gt = np.zeros((H, W))
    id_l = np.zeros((H, W), int)
    id_r = np.full((H, W), -1)
    for k, (a, b, (y0, y1), (x0, x1)) in enumerate(layers):
        tex = texture()
        inside_l = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
        left[inside_l] = tex[inside_l]
        gt[inside_l] = a + b * xs[inside_l]
        id_l[inside_l] = k
        u = (xs + a) / (1.0 - b)  # left column seen at right column xs
        inside_r = (ys >= y0) & (ys < y1) & (u >= x0) & (u <= x1 - 1)
        for c in range(3):
            samp = map_coordinates(tex[..., c], [ys, u], order=1,
                                   mode="nearest")
            right[..., c] = np.where(inside_r, samp, right[..., c])
        id_r[inside_r] = k
    xr = xs - gt
    ok = (xr >= 0) & (xr <= W - 1)
    lo = np.clip(np.floor(xr).astype(int), 0, W - 1)
    hi = np.clip(np.ceil(xr).astype(int), 0, W - 1)
    rows = ys.astype(int)
    nonocc = ok & (id_r[rows, lo] == id_l) & (id_r[rows, hi] == id_l)
    return (np.round(left).astype(np.uint8),
            np.round(right).astype(np.uint8), gt, nonocc)
