"""
asw_ref
=======

Pure-jnp reference implementation of the Adaptive Support-Weight matcher
(Yoon & Kweon 2006, as modified by the reference implementation).

Semantics parity target: /root/reference/simplestereo/_passive.cpp
(workerASW :16-105, workerASWconsistent :108-289):

- support weight  w1*w2 = exp(-2*sqrt(di^2+dj^2)/gammaP)
  * exp(-(||dLab1|| + ||dLab2||)/gammaC), with window pixels outside the
  image excluded from both numerator and denominator;
- matching cost   sum(w * min(40, SAD_BGR)) / sum(w), SAD over raw uint8;
- candidate right-center columns x-d for d(isparity) in [minD, maxD],
  requiring x-d >= 0; ties broken toward the smallest disparity
  (the reference's reverse-d scan with strict '<');
- pixels with an empty candidate range output their own column index
  (dBest stays 0 in the reference);
- consistent mode: a second pass with the right image as reference; every
  right pixel's best left match L is checked against the left pass and
  invalidated to -1 on disagreement; -1 runs are filled per row with the
  min of the nearest valid neighbors (the nearest single one at borders).

This module is the *oracle*: simple, obviously-correct XLA code used to
validate the Pallas kernel and to run on platforms without Mosaic support.
The production path is :mod:`simplestereo_jax.passive.asw_pallas`.
"""

import functools

import jax
import jax.numpy as jnp

from .lab import bgr_to_lab

TAD_CAP = 40.0


def _shift_x(a, s, fill=0.0):
    """a shifted so that out[..., x] = a[..., x+s] (constant fill)."""
    if s == 0:
        return a
    pad = [(0, 0)] * a.ndim
    if s > 0:
        pad[1] = (0, s)
        return jnp.pad(a, pad, constant_values=fill)[:, s:]
    pad[1] = (-s, 0)
    return jnp.pad(a, pad, constant_values=fill)[:, : a.shape[1]]


def _shift_y(a, s, fill=0.0):
    if s == 0:
        return a
    pad = [(0, 0)] * a.ndim
    if s > 0:
        pad[0] = (0, s)
        return jnp.pad(a, pad, constant_values=fill)[s:]
    pad[0] = (-s, 0)
    return jnp.pad(a, pad, constant_values=fill)[: a.shape[0]]


def _cost_volume(img_ref, img_tgt, lab_ref, lab_tgt, win_size, gamma_c,
                 gamma_p, min_disp, max_disp, direction, step=1):
    """ASW cost volume (H, W, D) for one matching direction.

    direction=+1: reference is the left image, target column = x - d.
    direction=-1: reference is the right image, target column = x + d.
    step: window-offset lattice stride (1 = every window pixel, the
    reference's semantics; 2 = the subsampled scan the reference
    suggested as "40-50% faster, no significant quality decrease",
    passive.py:43-46 — offsets on a step-lattice anchored at the center).
    """
    H, W = img_ref.shape[:2]
    pad = win_size // 2
    D = max_disp - min_disp + 1
    xs = jnp.arange(W)

    num = jnp.zeros((H, W, D), jnp.float32)
    den = jnp.zeros((H, W, D), jnp.float32)

    disps = jnp.arange(min_disp, max_disp + 1)
    # Target-center validity: x -/+ d must be inside the image.
    if direction > 0:
        cand_ok = (xs[None, :, None] - disps[None, None, :]) >= 0
    else:
        cand_ok = (xs[None, :, None] + disps[None, None, :]) <= W - 1

    # Per-disparity TAD maps on the reference grid:
    # tad[d](y, x) = min(40, SAD(ref(y,x), tgt(y, x -/+ d))).
    def tad_for(d):
        shifted = _shift_x(img_tgt, -direction * d)
        sad = jnp.abs(img_ref - shifted).sum(-1)
        ok = (xs - direction * d >= 0) & (xs - direction * d <= W - 1)
        return jnp.minimum(sad, TAD_CAP), ok[None, :]

    tads = []
    tad_oks = []
    for d in range(min_disp, max_disp + 1):
        t, ok = tad_for(d)
        tads.append(t)
        tad_oks.append(ok)
    tad = jnp.stack(tads, -1)          # (H, W, D)
    tad_col_ok = jnp.stack(tad_oks, -1)  # (1, W, D)

    ys_ok = jnp.ones((H,), bool)

    for di in range(-pad, pad + 1):
        if di % step:
            continue
        row_ok = jnp.zeros((H,), bool).at[:].set(
            (jnp.arange(H) + di >= 0) & (jnp.arange(H) + di <= H - 1))
        for dj in range(-pad, pad + 1):
            if dj % step:
                continue
            prox = jnp.exp(
                -2.0 * jnp.sqrt(jnp.float32(di * di + dj * dj)) / gamma_p)
            col_ok = (xs + dj >= 0) & (xs + dj <= W - 1)

            # ||Lab(y+di, x+dj) - Lab(y, x)|| on both images.
            dl_ref = jnp.sqrt(
                ((_shift_y(_shift_x(lab_ref, dj), di) - lab_ref) ** 2).sum(-1))
            dl_tgt = jnp.sqrt(
                ((_shift_y(_shift_x(lab_tgt, dj), di) - lab_tgt) ** 2).sum(-1))

            # dl_tgt evaluated at the target center x -/+ d.
            dl_tgt_d = jnp.stack(
                [_shift_x(dl_tgt, -direction * d)
                 for d in range(min_disp, max_disp + 1)], -1)  # (H, W, D)

            w = prox * jnp.exp(-(dl_ref[..., None] + dl_tgt_d) / gamma_c)

            # Window-pixel validity: row, ref column, and target column
            # x+dj -/+ d >= 0 (the reference's jj >= 0 check; the upper
            # bound is implied by col_ok when d >= 0).
            if direction > 0:
                tgt_col_ok = (xs[None, :, None] + dj
                              - disps[None, None, :]) >= 0
            else:
                tgt_col_ok = (xs[None, :, None] + dj
                              + disps[None, None, :]) <= W - 1
            valid = (row_ok[:, None, None] & col_ok[None, :, None]
                     & tgt_col_ok)
            w = jnp.where(valid, w, 0.0)

            # TAD at the window pixel: tad[d](y+di, x+dj).
            t = _shift_y(_shift_x(tad, dj), di)
            num = num + w * t
            den = den + w

    cost = num / den
    cost = jnp.where(cand_ok, cost, jnp.inf)
    return cost, cand_ok


def _argmin_disp(cost, cand_ok, min_disp, fallback):
    """Disparity with smallest-d tie-break; `fallback` where no candidate."""
    best = jnp.argmin(cost, axis=-1).astype(jnp.int32) + min_disp
    any_ok = cand_ok.any(-1)
    return jnp.where(any_ok, best, fallback)


def occlusion_fill(disp, invalid=-1):
    """Fill invalid runs per row with min(nearest valid left/right value).

    Border runs take the single available side. Rows with no valid pixel
    stay ``invalid`` (the reference reads out of bounds there,
    _passive.cpp:272-283; we define it instead). Parity:
    _passive.cpp:258-285 with its -1 marker; ``invalid`` is settable
    because -1 is a LEGAL disparity when minDisparity < 0 (consistent
    mode then marks with minDisparity - 1 instead).
    """
    H, W = disp.shape
    valid = disp != invalid
    xs = jnp.broadcast_to(jnp.arange(W), (H, W))

    idx_left = jnp.where(valid, xs, -1)
    last_valid = jax.lax.associative_scan(jnp.maximum, idx_left, axis=1)
    left_val = jnp.take_along_axis(disp, jnp.maximum(last_valid, 0), axis=1)
    has_left = last_valid >= 0

    idx_right = jnp.where(valid, xs, W)
    next_valid = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(idx_right, 1), axis=1), 1)
    right_val = jnp.take_along_axis(
        disp, jnp.minimum(next_valid, W - 1), axis=1)
    has_right = next_valid <= W - 1

    both = jnp.minimum(left_val, right_val)
    fill = jnp.where(has_left & has_right, both,
                     jnp.where(has_left, left_val,
                               jnp.where(has_right, right_val, invalid)))
    return jnp.where(valid, disp, fill)


@functools.partial(
    jax.jit,
    static_argnames=("win_size", "min_disp", "max_disp", "consistent",
                     "step"),
)
def asw_disparity_ref(img1, img2, win_size=35, max_disp=16, min_disp=0,
                      gamma_c=5.0, gamma_p=17.5, consistent=False, step=1):
    """Reference-semantics ASW disparity (pure jnp oracle).

    Parameters mirror ``StereoASW`` (/root/reference/simplestereo/passive.py:59).

    Returns
    -------
    jnp.ndarray
        (H, W) int16 disparity.
    """
    img1 = jnp.asarray(img1)
    img2 = jnp.asarray(img2)
    H, W = img1.shape[:2]
    xs = jnp.arange(W)

    f1 = img1.astype(jnp.float32)
    f2 = img2.astype(jnp.float32)
    lab1 = bgr_to_lab(img1)
    lab2 = bgr_to_lab(img2)

    costL, okL = _cost_volume(f1, f2, lab1, lab2, win_size, gamma_c, gamma_p,
                              min_disp, max_disp, +1, step)
    dispL = _argmin_disp(costL, okL, min_disp,
                         jnp.broadcast_to(xs, (H, W)).astype(jnp.int32))

    if not consistent:
        return dispL.astype(jnp.int16)

    costR, okR = _cost_volume(f2, f1, lab2, lab1, win_size, gamma_c, gamma_p,
                              min_disp, max_disp, -1, step)
    # Empty candidate range on the right pass: the reference leaves dBest=0,
    # i.e. matched left column 0 and implied disparity -x.
    dispR = _argmin_disp(costR, okR, min_disp, -jnp.broadcast_to(xs, (H, W)))

    # Invalidate left pixels whose right-pass match disagrees. The
    # reference's -1 marker collides with legal disparities when
    # minDisparity < 0; use minDisparity - 1 there (reference parity is
    # unaffected: its API semantics assume minDisparity >= 0).
    marker = -1 if min_disp >= 0 else min_disp - 1
    L = jnp.clip(xs[None, :] + dispR, 0, W - 1)
    agree = jnp.take_along_axis(dispL, L, axis=1) == dispR
    disagree_flag = jnp.zeros((H, W), bool)
    disagree_flag = jax.vmap(
        lambda f, l, a: f.at[l].max(~a))(disagree_flag, L, agree)
    dispI = jnp.where(disagree_flag, marker, dispL)

    return occlusion_fill(dispI, invalid=marker).astype(jnp.int16)
