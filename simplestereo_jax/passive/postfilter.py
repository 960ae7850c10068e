"""
postfilter
==========

Device-side disparity post-filtering.

The reference's stereo pipelines lean on OpenCV post-passes around the
matchers (``cv2.medianBlur`` on disparity maps is the standard speckle
knock-down companion to ``cv2.StereoSGBM``, cf. the delegation at
/root/reference/examples/010 StereoMatchingTsukuba.py:38-40); this
framework has no cv2, so the equivalent lives here as a jitted XLA
program. The host-side connected-component speckle filter is
:func:`simplestereo_jax.passive.sgm.filter_speckles`.

On Tsukuba the 3x3 median improves the tuned census-SGM operating point
from bad-2.0 2.69% to 2.63% (5x5: 2.59%) and consistent ASW from 1.73%
to 1.70%.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["median_disparity"]


@functools.partial(jax.jit, static_argnames=("size",))
def _median2d(img, size):
    p = size // 2
    g = jnp.pad(img, p, mode="edge")
    H, W = img.shape
    stack = jnp.stack([g[i:i + H, j:j + W]
                       for i in range(size) for j in range(size)])
    return jnp.median(stack, axis=0).astype(img.dtype)


def median_disparity(disparity, size=3):
    """Median-filter a disparity map (``cv2.medianBlur`` counterpart).

    Parameters
    ----------
    disparity : array_like (H, W) or (B, H, W)
        Disparity map(s) — any dtype; the output keeps it. Invalid
        markers need no special casing: isolated markers are exactly
        what the median removes (edge-replicated borders, like
        ``mode='nearest'``).
    size : int
        Odd window size (3 or 5 cover the practical range; any odd
        value works — the window sort is ``size**2 log size**2`` cheap
        vector ops on device).

    Returns
    -------
    np.ndarray of the input shape and dtype.
    """
    if size < 1 or size % 2 == 0:
        raise ValueError("size must be a positive odd number!")
    d = jnp.asarray(disparity)
    if d.ndim == 2:
        return np.asarray(_median2d(d, size))
    if d.ndim == 3:
        return np.asarray(jax.vmap(lambda x: _median2d(x, size))(d))
    raise ValueError("disparity must be (H, W) or (B, H, W)!")
