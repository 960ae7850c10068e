"""
wls
===

Edge-aware disparity smoothing: the Fast Global Smoother of Min et al.
2014 ("Fast Global Image Smoothing Based on Weighted Least Squares"),
the algorithm behind OpenCV's ``cv2.ximgproc.DisparityWLSFilter`` /
``createFastGlobalSmootherFilter`` that production SGBM pipelines apply
after matching. The reference delegates matching to cv2 and leaves
post-filtering to the user (examples/010); this framework owns the
matchers, so it owns the standard post-filter too.

The WLS objective ``min_u sum (u - d)^2 + lambda * sum w_ij (u_i-u_j)^2``
(weights from guide-image color gradients) is solved by alternating
exact 1-D tridiagonal solves along rows and columns with the paper's
iteration-varying ``lambda_t = 1.5 * lambda * 4^(T-t) / (4^T - 1)``
schedule. Each 1-D solve is a Thomas algorithm — a forward and a
backward ``lax.scan`` with a per-line carry, vmapped across lines —
the same sequential-recurrence-as-scan pattern as the SGM aggregation
and the IIR unwrapper.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fast_global_smoother", "wls_filter_disparity"]


def _thomas_rows(d, lo, up, rhs):
    """Solve per-row tridiagonal systems.

    d, rhs : (H, W) diagonals / right-hand sides; lo, up : (H, W-1)
    sub/super-diagonals. Returns (H, W) solutions. Pure scans (the
    classic Thomas forward elimination + back substitution), vmapped
    over rows via batched carries.
    """
    H, W = d.shape

    # forward sweep: c'_i = up_i / (d_i - lo_{i-1} c'_{i-1}),
    #                r'_i = (rhs_i - lo_{i-1} r'_{i-1}) / (...)
    def fwd(carry, x):
        c_prev, r_prev = carry
        di, ui, li, ri = x
        denom = di - li * c_prev
        c = ui / denom
        r = (ri - li * r_prev) / denom
        return (c, r), (c, r)

    up_p = jnp.concatenate([up, jnp.zeros((H, 1), up.dtype)], axis=1)
    lo_p = jnp.concatenate([jnp.zeros((H, 1), lo.dtype), lo], axis=1)
    xs = (d.T, up_p.T, lo_p.T, rhs.T)   # scan over columns, carry (H,)
    init = (jnp.zeros(H, d.dtype), jnp.zeros(H, d.dtype))
    _, (cs, rs) = jax.lax.scan(fwd, init, xs)

    # back substitution: u_i = r'_i - c'_i u_{i+1}
    def bwd(u_next, x):
        c, r = x
        u = r - c * u_next
        return u, u

    _, us = jax.lax.scan(bwd, jnp.zeros(H, d.dtype), (cs, rs),
                         reverse=True)
    return us.T


def _edge_weights(guide, sigma_color):
    """w(p, q) = exp(-||I(p) - I(q)||_1 / sigma) for horizontal and
    vertical neighbor pairs; guide (H, W[, C]) float."""
    g = jnp.asarray(guide, jnp.float32)
    if g.ndim == 2:
        g = g[..., None]
    dx = jnp.abs(g[:, 1:] - g[:, :-1]).sum(-1)
    dy = jnp.abs(g[1:, :] - g[:-1, :]).sum(-1)
    return jnp.exp(-dx / sigma_color), jnp.exp(-dy / sigma_color)


@functools.partial(jax.jit, static_argnames=("num_iter",))
def _fgs(src, conf, wx, wy, lam, num_iter):
    """Alternating 1-D WLS solves of (C + lam_t L) u = C u_prev.

    conf is the per-pixel data-term weight (1 = trust the source, 0 =
    fill purely from neighbors); eps keeps zero-confidence lines
    non-singular."""
    eps = 1e-5
    u = src
    for t in range(1, num_iter + 1):
        lam_t = 1.5 * lam * 4.0 ** (num_iter - t) / (4.0 ** num_iter - 1.0)
        lo = -lam_t * wx                              # (H, W-1)
        d = conf + eps + lam_t * (
            jnp.pad(wx, ((0, 0), (1, 0))) + jnp.pad(wx, ((0, 0), (0, 1))))
        u = _thomas_rows(d, lo, lo, conf * u + eps * u)
        lo_c = -lam_t * wy.T                          # (W, H-1)
        d_c = (conf + eps + lam_t * (
            jnp.pad(wy, ((1, 0), (0, 0)))
            + jnp.pad(wy, ((0, 1), (0, 0))))).T
        u = _thomas_rows(d_c, lo_c, lo_c, (conf * u + eps * u).T).T
    return u


@functools.partial(jax.jit, static_argnames=("num_iter", "has_invalid"))
def _wls_one(d, guide, lam, sigma, invalid, disp_scale, *, num_iter,
             has_invalid):
    """One frame, fully on device (weights + confidence inside the jit,
    no eager op round trips)."""
    d = d.astype(jnp.float32)
    conf = (d != invalid).astype(jnp.float32) if has_invalid \
        else jnp.ones_like(d)
    d = d * disp_scale
    wx, wy = _edge_weights(guide, sigma)
    return _fgs(d * conf, conf, wx, wy, lam, num_iter)


def _wls_dispatch(disparity, guide, lambda_, sigma_color, num_iter,
                  invalid, disp_scale):
    d = jnp.asarray(disparity)
    g = jnp.asarray(guide)
    if d.ndim not in (2, 3) or g.ndim - d.ndim not in (0, 1) \
            or g.shape[:d.ndim] != d.shape:
        raise ValueError(
            "disparity must be (H, W) or (B, H, W) with a guide of "
            "matching leading shape (plus an optional channel axis)!")
    args = (jnp.float32(lambda_), jnp.float32(sigma_color),
            jnp.float32(0.0 if invalid is None else invalid),
            jnp.float32(disp_scale))
    kw = dict(num_iter=int(num_iter), has_invalid=invalid is not None)
    if d.ndim == 2:
        return np.asarray(_wls_one(d, g, *args, **kw))
    return np.asarray(jax.vmap(
        lambda dd, gg: _wls_one(dd, gg, *args, **kw))(d, g))


def fast_global_smoother(src, guide, lambda_=128.0, sigma_color=8.0,
                         num_iter=3):
    """Edge-aware WLS smoothing of ``src`` guided by ``guide``.

    Min et al. 2014 / cv2.ximgproc.createFastGlobalSmootherFilter
    semantics: alternating exact 1-D WLS solves with the paper's
    lambda schedule. ``lambda_`` is the smoothing strength at the
    SOURCE value scale; ``sigma_color`` the guide-gradient falloff
    (L1 over channels, 0..255 scale). ``src`` may be (H, W) or a
    (B, H, W) batch (guide batched alike, optional channel axis).

    Returns a float32 array of ``src``'s shape.
    """
    return _wls_dispatch(src, guide, lambda_, sigma_color, num_iter,
                         None, 1.0)


def wls_filter_disparity(disparity, guide, lambda_=128.0, sigma_color=8.0,
                         num_iter=3, invalid=None, disp_scale=1.0):
    """WLS post-filter for a disparity map (DisparityWLSFilter analog).

    Invalid pixels (marker ``invalid``, before ``disp_scale``) get zero
    data-term confidence: they receive purely propagated values from
    their neighborhood, like the confidence-weighted cv2 filter with
    zero confidence there. ``disparity`` may be (H, W) or a (B, H, W)
    batch (guide batched alike, optional channel axis).

    Returns float32 disparity at the ``disp_scale``-applied scale.
    """
    return _wls_dispatch(disparity, guide, lambda_, sigma_color,
                         num_iter, invalid, disp_scale)
