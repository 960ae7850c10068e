"""
presets
=======

Best-quality composite operating points, one call.

The framework ships several quality levers that compose — consistent
matching, tuned weight bandwidths, sub-pixel refinement, census cost,
WLS edge-aware post filtering — but each lives on its own knob.
:func:`quality_disparity` bundles the measured-best composition so users
get the framework's best answer without re-deriving the tuning (the
reference has no analog: its matchers are single-shot with stock
defaults, /root/reference/simplestereo/passive.py:59-69).

Tsukuba accuracy record (nonocc ground truth; the ground truth is
INTEGER disparity, so fractional output cannot win there — see the
sub-pixel note):

| operating point                     | bad1   | bad2   | avgerr | rms  |
|-------------------------------------|--------|--------|--------|------|
| ASW consistent, gammaC 15 (default) | 2.11%  | 1.73%  | 0.29px | 0.82 |
| + WLS lambda 4, sigma_color 2       | 5.51%  | 1.76%  | 0.29px | 0.77 |
| + subpixel                          | 2.94%  | 1.80%  | 0.37px | 0.81 |
| + subpixel + WLS 4/2                | 5.02%  | 1.77%  | 0.37px | 0.77 |
| SGM census + LR/uniq + WLS fill     | —      | 2.83%  | 0.44px | —    |

The default is therefore the *plain* tuned consistent matcher — the WLS
and sub-pixel levers are off unless asked for: WLS trades ~6% lower RMS
for a bad1 increase (it blurs integer disparity steps at region edges),
and sub-pixel refinement only helps scenes with true fractional
disparity (on integer ground truth it adds the fractional residual to
avgerr by construction). This negative result is recorded here so the
composition isn't "re-tuned" blind later.
"""

import numpy as np

from .wls import wls_filter_disparity


def _gray_guide(img):
    """Channel-mean guide for the WLS filter (float32, 0..255)."""
    img = np.asarray(img)
    return (img.mean(-1) if img.ndim == 3 else img).astype(np.float32)


def quality_disparity(img1, img2, min_disp=0, max_disp=16, *,
                      matcher="asw", win_size=35, gamma_c=15.0,
                      gamma_p=17.5, subpixel=False, block_size=3,
                      p1=120, p2=480, wls_lambda=None,
                      wls_sigma_color=None):
    """Best-quality disparity in one call: tuned matcher (+ optional
    sub-pixel / WLS levers with measured trade-offs — see the module
    docstring's Tsukuba table).

    Parameters
    ----------
    img1, img2 : (H, W, 3) uint8 BGR pair (rectified).
    min_disp, max_disp : int
        Inclusive disparity search range (like StereoASW; for
        ``matcher="sgm"`` the range is widened up to the next multiple
        of 16 candidates, cv2-style).
    matcher : "asw" | "sgm"
        "asw": consistent ASW at the tuned bandwidths — the accuracy
        champion (Tsukuba bad-2.0 1.73%). "sgm": census SGM with LR
        check + uniqueness, WLS confidence-weighted filling of the
        invalidated pixels — cheaper, 2.83% dense.
    subpixel : bool
        Equiangular sub-pixel refinement (ASW leg). Use on scenes with
        true fractional disparity; on integer ground truth it can only
        add error.
    wls_lambda : float or None
        None (default): no WLS pass on the ASW leg (measured best on
        bad-N/avgerr). A float (4.0 recommended) enables RMS-optimized
        edge-aware smoothing. The SGM leg always WLS-fills its
        invalidated pixels (lambda 2 unless overridden).
    wls_sigma_color : float or None
        WLS guide-gradient falloff (smaller = stricter edges). None
        (default) uses the measured-best value per leg: 2.0 on the ASW
        leg (when WLS is enabled via ``wls_lambda``), 8.0 for the SGM
        leg's confidence-weighted fill.

    Returns
    -------
    (H, W) float32 disparity in pixel units, dense (no invalid markers —
    occlusions filled by the consistent pass or WLS-propagated).
    """
    img1 = np.ascontiguousarray(img1)
    img2 = np.ascontiguousarray(img2)
    if img1.ndim != 3 or img1.shape[2] != 3 or img1.shape != img2.shape:
        raise ValueError(
            "Images must be 3-channel BGR with identical shapes!")

    if matcher == "asw":
        from .asw import asw_disparity

        disp = np.asarray(asw_disparity(
            img1, img2, win_size=win_size, min_disp=min_disp,
            max_disp=max_disp, gamma_c=float(gamma_c),
            gamma_p=float(gamma_p), consistent=True,
            subpixel=bool(subpixel))).astype(np.float32)
        if wls_lambda is None:
            return disp
        # consistent ASW is already dense (occlusion fill); WLS smooths
        return wls_filter_disparity(
            disp, _gray_guide(img1), lambda_=float(wls_lambda),
            sigma_color=(2.0 if wls_sigma_color is None
                         else float(wls_sigma_color)))
    if matcher == "sgm":
        from .sgm import StereoSGM

        num = -(-(max_disp - min_disp + 1) // 16) * 16
        m = StereoSGM(minDisparity=min_disp, numDisparities=num,
                      blockSize=block_size, P1=p1, P2=p2,
                      uniquenessRatio=10, disp12MaxDiff=1,
                      costMethod="census", censusWindow=7)
        d16 = m.compute(img1, img2)
        lam = 2.0 if wls_lambda is None else float(wls_lambda)
        return wls_filter_disparity(
            d16, _gray_guide(img1), lambda_=lam,
            sigma_color=(8.0 if wls_sigma_color is None
                         else float(wls_sigma_color)),
            invalid=(min_disp - 1) * 16, disp_scale=1 / 16.0)
    raise ValueError("matcher must be 'asw' or 'sgm'!")


__all__ = ["quality_disparity"]
