"""
passive
=======

Dense passive stereo matching (disparity map construction).

Parity target: /root/reference/simplestereo/passive.py + _passive.cpp.
The matcher classes mirror the reference API (``StereoASW``, ``StereoGSW``)
and add ``StereoSGM`` (the JAX replacement for the ``cv2.StereoSGBM``
usage in the reference's examples 008/010/011).

ASW runs a fused Pallas kernel on the GPU (:mod:`.asw_pallas`) and its
XLA form on the CPU (:mod:`.asw`); the pure-jnp oracle
(:mod:`.asw_ref`) validates both.
"""

import numpy as np

from .lab import bgr_to_lab
from .asw_ref import asw_disparity_ref, occlusion_fill
from .asw import asw_disparity, asw_disparity_batch
from .sgm import StereoSGM, StereoSGBM_create, filter_speckles
from .postfilter import median_disparity
from .wls import fast_global_smoother, wls_filter_disparity
from .gsw import StereoGSW, gsw_disparity
from .presets import quality_disparity


class StereoASW:
    """Adaptive Support-Weight block matcher (Yoon & Kweon 2006).

    API parity: reference simplestereo/passive.py:16-92. Runs
    :func:`asw_disparity`.

    Parameters
    ----------
    winSize : int
        Side of the square support window (odd). Default 35.
    maxDisparity, minDisparity : int
        Inclusive disparity search range. Defaults 16, 0.
    gammaC, gammaP : float
        Color and proximity weight bandwidths. Defaults 5, 17.5.
    consistent : bool
        Left-right consistency check + occlusion filling (from the same
        cost volume: no second pass).
    step : int
        Window-offset lattice stride. 1 (default) = the reference's exact
        semantics (every window pixel); 2 = the subsampled scan the
        reference proposed as "40-50% faster, no significant quality
        decrease" (passive.py:43-46) but never implemented: support
        weights and costs are accumulated on a step-lattice of window
        offsets anchored at the center pixel.
    subpixel : bool
        Equiangular sub-pixel refinement of the winner from its cost
        neighborhood (beyond the reference's integer-only ASW; the
        V-shaped fit matches the SAD-class cost profile). ``compute``
        returns float32 disparity then.

    ..note::
        Differently from the reference C++ implementation, which warns it is
        "EXTREMELY SLOW" above small resolutions, full-resolution images
        need no pre-downscaling.
    """

    def __init__(self, winSize=35, maxDisparity=16, minDisparity=0,
                 gammaC=5, gammaP=17.5, consistent=False, step=1,
                 subpixel=False):
        if winSize <= 0 or winSize % 2 == 0:
            raise ValueError("winSize must be a positive odd number!")
        if step < 1:
            raise ValueError("step must be >= 1!")
        self.winSize = winSize
        self.maxDisparity = maxDisparity
        self.minDisparity = minDisparity
        self.gammaC = gammaC
        self.gammaP = gammaP
        self.consistent = consistent
        self.step = step
        self.subpixel = subpixel

    def compute(self, img1, img2):
        """Compute the disparity map of the pair.

        Returns (H, W) int16 disparity referred to img1
        (parity: passive.py:72-92).
        """
        img1 = np.ascontiguousarray(img1)
        img2 = np.ascontiguousarray(img2)
        if img1.ndim != 3 or img1.shape[2] != 3 or img1.shape != img2.shape:
            raise ValueError(
                "Images must be 3-channel BGR with identical shapes!")
        out = asw_disparity(
            img1, img2, win_size=self.winSize,
            max_disp=self.maxDisparity, min_disp=self.minDisparity,
            gamma_c=float(self.gammaC), gamma_p=float(self.gammaP),
            consistent=self.consistent, step=self.step,
            subpixel=self.subpixel)
        return np.asarray(out)

    def computeBatch(self, imgs1, imgs2):
        """Batched :meth:`compute` over leading-axis frame stacks.

        (B, H, W, 3) pairs -> (B, H, W) int16 disparity (float32
        when ``subpixel``), one device program for the whole stack
        (:func:`asw_disparity_batch`). For multi-device batches shard
        frames with
        :func:`simplestereo_jax.parallel.batch_parallel`.
        Bit-identical to per-frame :meth:`compute`.
        """
        imgs1 = np.ascontiguousarray(imgs1)
        imgs2 = np.ascontiguousarray(imgs2)
        if imgs1.ndim != 4 or imgs1.shape[3] != 3 \
                or imgs1.shape != imgs2.shape:
            raise ValueError(
                "Batches must be (B, H, W, 3) BGR with identical shapes!")
        out = asw_disparity_batch(
            imgs1, imgs2, win_size=self.winSize,
            max_disp=self.maxDisparity, min_disp=self.minDisparity,
            gamma_c=float(self.gammaC), gamma_p=float(self.gammaP),
            consistent=self.consistent, step=self.step,
            subpixel=self.subpixel)
        return np.asarray(out)


__all__ = [
    "bgr_to_lab",
    "asw_disparity",
    "asw_disparity_batch",
    "asw_disparity_ref",
    "occlusion_fill",
    "StereoASW",
    "StereoSGM",
    "StereoGSW",
    "gsw_disparity",
    "StereoSGBM_create",
    "filter_speckles",
    "median_disparity",
    "fast_global_smoother",
    "wls_filter_disparity",
    "quality_disparity",
]
