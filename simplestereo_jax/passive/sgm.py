"""
sgm
===

Semi-Global Matching (Hirschmuller 2008) — the JAX replacement for
the reference's use of ``cv2.StereoSGBM`` (examples 008/010/011, e.g.
/root/reference/examples/010 StereoMatchingTsukuba.py:37-39). The
reference delegates this matcher entirely to OpenCV; here it is built
from scratch as XLA programs:

- **Cost**: Birchfield-Tomasi sampling-insensitive dissimilarity on the
  x-Sobel-filtered image (clipped to ±preFilterCap, like OpenCV's
  prefilter), box-summed over the blockSize window. Fully vectorized
  (H, W, D) tensor ops. ``costMethod="census"`` instead uses the census
  transform (Zabih-Woodfill) + Hamming distance — invariant to monotonic
  radiometric changes (gain/offset/gamma between the two cameras), which
  the BT-on-Sobel cost is not; ``"bt+census"`` sums both (census scaled
  into BT's range). Census bit-planes pack into uint32 words and the
  Hamming distance is a single ``lax.population_count`` per word — both
  costs stay pure (H, W, D) tensor programs.
- **Aggregation**: the SGM recurrence
  ``Lr(p,d) = C(p,d) + min(Lr(p-r,d), Lr(p-r,d∓1)+P1, min_d' Lr(p-r)+P2)
  - min_d' Lr(p-r)`` as ``lax.scan`` along each path direction: horizontal
  scans carry an (H, D) state, vertical scans carry (W, D), diagonal scans
  carry (W, D) with a per-step lane roll. 4 or 8 paths.
- **Post**: winner-take-all argmin, OpenCV-convention fixed-point output
  (disparity * 16) with quadratic subpixel interpolation, uniqueness-ratio
  test, left-right (disp12MaxDiff) check reusing the same aggregated
  volume, and an optional host-side speckle filter
  (:func:`filter_speckles`).

Semantic parity is with SGM-class matchers, not bit-parity with OpenCV's
implementation (which the reference does not own either).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

INVALID_SHIFT = 4  # output = disparity * 16 (OpenCV DISP_SHIFT convention)


def bgr_to_gray(img):
    """BGR -> single-channel luminance (ITU-R 601, cv2.cvtColor parity)."""
    img = jnp.asarray(img)
    if img.ndim == 2:
        return img.astype(jnp.float32)
    b, g, r = (img[..., 0].astype(jnp.float32),
               img[..., 1].astype(jnp.float32),
               img[..., 2].astype(jnp.float32))
    return 0.299 * r + 0.587 * g + 0.114 * b


def _xsobel(gray, cap):
    """Horizontal Sobel derivative clipped to [-cap, cap] (prefilter)."""
    g = jnp.pad(gray, 1, mode="edge")
    dx = (g[:-2, 2:] + 2 * g[1:-1, 2:] + g[2:, 2:]
          - g[:-2, :-2] - 2 * g[1:-1, :-2] - g[2:, :-2])
    return jnp.clip(dx / 4.0, -cap, cap)


def _shift_edge(a, d):
    """Shift (H, W) columns by d with edge fill.

    Off-image candidates are masked to invalid in _sgm_post, so the fill
    only needs to keep shapes static for any d (|d| may exceed W,
    minDisparity may be negative — cv2.StereoSGBM accepts both).
    """
    H, W = a.shape
    if d == 0:
        return a
    if d > 0:
        d = min(d, W)
        return jnp.concatenate(
            [jnp.broadcast_to(a[:, :1], (H, d)), a[:, :W - d]], axis=1)
    d = min(-d, W)
    return jnp.concatenate(
        [a[:, d:], jnp.broadcast_to(a[:, -1:], (H, d))], axis=1)


def _bt_cost(ref, tgt, min_disp, num_disp):
    """Birchfield-Tomasi cost volume (H, W, D); tgt column = x - d."""
    H, W = ref.shape
    # Half-pixel interpolants of the target row signal.
    tgt_m = 0.5 * (tgt + jnp.concatenate([tgt[:, :1], tgt[:, :-1]], axis=1))
    tgt_p = 0.5 * (tgt + jnp.concatenate([tgt[:, 1:], tgt[:, -1:]], axis=1))
    t_min = jnp.minimum(jnp.minimum(tgt_m, tgt_p), tgt)
    t_max = jnp.maximum(jnp.maximum(tgt_m, tgt_p), tgt)
    ref_m = 0.5 * (ref + jnp.concatenate([ref[:, :1], ref[:, :-1]], axis=1))
    ref_p = 0.5 * (ref + jnp.concatenate([ref[:, 1:], ref[:, -1:]], axis=1))
    r_min = jnp.minimum(jnp.minimum(ref_m, ref_p), ref)
    r_max = jnp.maximum(jnp.maximum(ref_m, ref_p), ref)

    costs = []
    for dd in range(num_disp):
        d = min_disp + dd
        c_rt = jnp.maximum(0.0, jnp.maximum(
            ref - _shift_edge(t_max, d), _shift_edge(t_min, d) - ref))
        c_tr = jnp.maximum(0.0, jnp.maximum(
            _shift_edge(tgt, d) - r_max, r_min - _shift_edge(tgt, d)))
        costs.append(jnp.minimum(c_rt, c_tr))
    return jnp.stack(costs, axis=-1)


def _census_words(gray, win):
    """Census transform of (H, W) gray: bit k of word w is 1 iff the k-th
    window neighbor is brighter than the center (Zabih-Woodfill 1994).
    Bit-planes pack into uint32 words (win=3 -> 8 bits in 1 word, win=5 ->
    24 bits in 1, win=7 -> 48 bits in 2); returns the list of words."""
    H, W = gray.shape
    p = win // 2
    g = jnp.pad(gray, p, mode="edge")
    bits = [g[p + di:p + di + H, p + dj:p + dj + W] > gray
            for di in range(-p, p + 1) for dj in range(-p, p + 1)
            if not (di == 0 and dj == 0)]
    words = []
    for w0 in range(0, len(bits), 24):
        acc = jnp.zeros((H, W), jnp.uint32)
        for k, b in enumerate(bits[w0:w0 + 24]):
            acc = acc | (b.astype(jnp.uint32) << np.uint32(k))
        words.append(acc)
    return words


def _census_cost(ref, tgt, min_disp, num_disp, win):
    """Hamming-distance cost volume (H, W, D) between census codes;
    tgt column = x - d. float32, range [0, win*win - 1]."""
    rw = _census_words(ref, win)
    tw = _census_words(tgt, win)
    costs = []
    for dd in range(num_disp):
        d = min_disp + dd
        h = sum(jax.lax.population_count(r ^ _shift_edge(t, d))
                for r, t in zip(rw, tw))
        costs.append(h)
    return jnp.stack(costs, axis=-1).astype(jnp.float32)


def _box_sum(vol, k):
    """Sum over a k x k spatial window (edge-padded), axis 0/1 of (H,W,D).

    Direct k-fold shifted adds, NOT a cumsum difference: the result at a
    pixel is then a pure function of its k x k neighborhood in a fixed
    summation order, independent of absolute image position. That keeps
    the row-sharded pipeline (parallel.sgm) bit-identical to the
    single-device one and avoids f32 prefix-magnitude error on tall
    frames; at blockSize <= 7 the k extra adds per axis are cheaper than
    the two cumsums they replace.
    """
    if k <= 1:
        return vol
    p = k // 2
    H, W = vol.shape[:2]
    v = jnp.pad(vol, ((p, p), (p, p), (0, 0)), mode="edge")
    s = v[0:H]
    for di in range(1, k):
        s = s + v[di:di + H]
    out = s[:, 0:W]
    for dj in range(1, k):
        out = out + s[:, dj:dj + W]
    return out


def _sgm_step(L_prev, C_cur, P1, P2):
    """One SGM recurrence step, vectorized over (..., D)."""
    m = jnp.min(L_prev, axis=-1, keepdims=True)
    up = jnp.concatenate([L_prev[..., 1:], L_prev[..., -1:]], axis=-1)
    dn = jnp.concatenate([L_prev[..., :1], L_prev[..., :-1]], axis=-1)
    best = jnp.minimum(jnp.minimum(L_prev, jnp.minimum(up, dn) + P1), m + P2)
    return C_cur + best - m


def _roll_cols(a, dx):
    """Shift (.., W, D) along W with zero fill (predecessor off-image)."""
    if dx > 0:
        return jnp.concatenate(
            [jnp.zeros_like(a[..., :dx, :]), a[..., :-dx, :]], axis=-2)
    if dx < 0:
        return jnp.concatenate(
            [a[..., -dx:, :], jnp.zeros_like(a[..., :-dx, :])], axis=-2)
    return a


def _aggregate(C, P1, P2, paths):
    """Sum of SGM path aggregations over 4 or 8 directions.

    Scheduling: all directions along an axis are *stacked into
    one lax.scan* (a forward and a flipped copy run in the same step), so
    the whole aggregation is exactly two sequential scans — one over
    columns with a (2, H, D) carry, one over rows with a (2 or 6, W, D)
    carry (verticals + the four diagonals expressed as vertical scans with
    a per-step column roll). Sequential-step count is W + H regardless of
    path count; unroll amortizes loop overhead.
    """
    H, W, D = C.shape

    # --- horizontal: forward on C, forward on x-flipped C (== backward).
    Ch = jnp.stack([C, C[:, ::-1]], axis=0)          # (2, H, W, D)
    Ch = jnp.moveaxis(Ch, 2, 0)                      # (W, 2, H, D)

    def hstep(carry, c):
        out = _sgm_step(carry, c, P1, P2)
        return out, out

    init = jnp.zeros((2, H, D), C.dtype)
    _, oh = jax.lax.scan(hstep, init, Ch, unroll=4)  # (W, 2, H, D)
    oh = jnp.moveaxis(oh, 0, 2)                      # (2, H, W, D)
    S = oh[0] + oh[1][:, ::-1]

    # --- vertical (+ diagonals): forward scans over rows of C and of the
    # vertically flipped C, with per-component column rolls for diagonals.
    rolls = (0, 1, -1) if paths >= 8 else (0,)
    k = len(rolls)
    Cv = jnp.stack([C] * k + [C[::-1]] * k, axis=0)  # (2k, H, W, D)
    Cv = jnp.moveaxis(Cv, 1, 0)                      # (H, 2k, W, D)

    def vstep(carry, c):
        rolled = jnp.stack(
            [_roll_cols(carry[i], rolls[i % k]) for i in range(2 * k)],
            axis=0)
        out = _sgm_step(rolled, c, P1, P2)
        return out, out

    init = jnp.zeros((2 * k, W, D), C.dtype)
    _, ov = jax.lax.scan(vstep, init, Cv, unroll=4)  # (H, 2k, W, D)
    ov = jnp.moveaxis(ov, 0, 1)                      # (2k, H, W, D)
    for i in range(k):
        S = S + ov[i]
        S = S + ov[k + i][::-1]
    return S


def _edge_fill_rows(ext, valid, row_axis=0):
    """Replace invalid rows (beyond the true image boundary in a
    row-sharded halo block) with the nearest valid row along ``row_axis``
    — the sharded twin of ``mode="edge"`` padding."""
    n = valid.shape[0]
    first = jnp.argmax(valid)
    last = n - 1 - jnp.argmax(valid[::-1])
    idx = jnp.clip(jnp.arange(n), first, last)
    return jnp.take(ext, idx, axis=row_axis)


def _sgm_cost(img1, img2, *, min_disp, num_disp, block_size,
              prefilter_cap, cost_method="bt", census_window=5,
              row_valid=None):
    """Cost volume for one frame (pure jnp, vmappable).

    "bt": Sobel prefilter + Birchfield-Tomasi; "census": census/Hamming
    on raw luminance; "bt+census": their sum with census scaled to BT's
    range (max 2*prefilter_cap over max win*win-1 bits).

    ``row_valid`` (row-sharded path): bool mask of rows inside the true
    image. The pre-box cost at invalid rows is replaced by the nearest
    valid row's cost so the box filter sees exactly the edge padding the
    single-device path applies to the *cost volume* (padding the raw
    image instead changes the Sobel/census values at the duplicated rows
    and breaks bit-parity at the global boundary)."""
    gray1, gray2 = bgr_to_gray(img1), bgr_to_gray(img2)
    C = None
    if cost_method in ("bt", "bt+census"):
        g1 = _xsobel(gray1, prefilter_cap)
        g2 = _xsobel(gray2, prefilter_cap)
        C = _bt_cost(g1, g2, min_disp, num_disp)
    if cost_method in ("census", "bt+census"):
        Cc = _census_cost(gray1, gray2, min_disp, num_disp, census_window)
        if C is None:
            C = Cc
        else:
            nbits = census_window * census_window - 1
            C = C + Cc * (2.0 * prefilter_cap / nbits)
    if C is None:
        raise ValueError(
            "costMethod must be 'bt', 'census' or 'bt+census'!")
    if row_valid is not None:
        C = _edge_fill_rows(C, row_valid)
    return _box_sum(C, block_size)


@functools.partial(
    jax.jit,
    static_argnames=("min_disp", "num_disp", "block_size", "paths",
                     "P1", "P2", "prefilter_cap", "uniqueness",
                     "disp12_max_diff", "subpixel", "cost_method",
                     "census_window"))
def _sgm_disparity(img1, img2, *, min_disp, num_disp, block_size, P1, P2,
                   paths, prefilter_cap, uniqueness, disp12_max_diff,
                   subpixel, cost_method="bt", census_window=5):
    C = _sgm_cost(img1, img2, min_disp=min_disp, num_disp=num_disp,
                  block_size=block_size, prefilter_cap=prefilter_cap,
                  cost_method=cost_method, census_window=census_window)
    S = _aggregate(C, P1, P2, paths)
    return _sgm_post(S, min_disp=min_disp, num_disp=num_disp,
                     uniqueness=uniqueness,
                     disp12_max_diff=disp12_max_diff, subpixel=subpixel)


@functools.partial(
    jax.jit,
    static_argnames=("min_disp", "num_disp", "block_size", "paths",
                     "P1", "P2", "prefilter_cap", "uniqueness",
                     "disp12_max_diff", "subpixel", "cost_method",
                     "census_window"))
def _sgm_disparity_batch(imgs1, imgs2, *, min_disp, num_disp, block_size,
                         P1, P2, paths, prefilter_cap, uniqueness,
                         disp12_max_diff, subpixel, cost_method="bt",
                         census_window=5):
    """Batched pipeline: one device program for a whole frame stack (the
    batch vmaps through cost, aggregation — it folds into the lax.scan
    carries — and post passes)."""
    cost = functools.partial(
        _sgm_cost, min_disp=min_disp, num_disp=num_disp,
        block_size=block_size, prefilter_cap=prefilter_cap,
        cost_method=cost_method, census_window=census_window)
    C = jax.vmap(cost)(imgs1, imgs2)
    S = jax.vmap(lambda c: _aggregate(c, P1, P2, paths))(C)
    post = functools.partial(
        _sgm_post, min_disp=min_disp, num_disp=num_disp,
        uniqueness=uniqueness, disp12_max_diff=disp12_max_diff,
        subpixel=subpixel)
    return jax.vmap(post)(S)


def _sgm_post(S, *, min_disp, num_disp, uniqueness, disp12_max_diff,
              subpixel):
    """WTA + uniqueness + subpixel + LR check on one frame's path sum."""
    H, W = S.shape[:2]
    # Mask candidates whose target column x - d falls outside the image
    # (both ends: d > x for positive d, x - d > W-1 for negative d).
    xs = jnp.arange(W)[None, :, None]
    ds = (jnp.arange(num_disp) + min_disp)[None, None, :]
    S = jnp.where((xs - ds >= 0) & (xs - ds <= W - 1), S, jnp.inf)

    best = jnp.argmin(S, axis=-1)
    s_best = jnp.min(S, axis=-1)
    valid = jnp.isfinite(s_best)

    # Uniqueness: reject if some non-neighbor candidate is within ratio.
    if uniqueness > 0:
        dd = jnp.arange(num_disp)[None, None, :]
        non_neigh = jnp.abs(dd - best[..., None]) > 1
        s2 = jnp.min(jnp.where(non_neigh, S, jnp.inf), axis=-1)
        valid &= ~(s2 * 100.0 < s_best * (100.0 + uniqueness))

    # Subpixel: quadratic fit around the minimum, x16 fixed point.
    disp16 = (best + min_disp).astype(jnp.float32) * 16.0
    if subpixel:
        bm1 = jnp.take_along_axis(
            S, jnp.maximum(best - 1, 0)[..., None], axis=-1)[..., 0]
        bp1 = jnp.take_along_axis(
            S, jnp.minimum(best + 1, num_disp - 1)[..., None], axis=-1)[..., 0]
        bm1 = jnp.where(jnp.isfinite(bm1), bm1, s_best)
        bp1 = jnp.where(jnp.isfinite(bp1), bp1, s_best)
        denom = bm1 + bp1 - 2.0 * s_best
        delta = jnp.where(denom > 1e-6, (bm1 - bp1) / (2.0 * denom), 0.0)
        delta = jnp.clip(delta, -0.5, 0.5)
        interior = (best > 0) & (best < num_disp - 1)
        disp16 = disp16 + jnp.where(interior, delta, 0.0) * 16.0

    # Left-right check from the same aggregated volume:
    # right disparity at xr = argmin_d S(y, xr + d, d).
    if disp12_max_diff >= 0:
        cols = jnp.clip(xs + ds, 0, W - 1)        # (1, W, D)
        S_r = jnp.take_along_axis(
            S, jnp.broadcast_to(cols, (H, W, num_disp)), axis=1)
        # Mask right-view candidates whose left column xr + d is off-image
        # at either end (xr + d < 0 happens with negative minDisparity).
        S_r = jnp.where((xs + ds >= 0) & (xs + ds <= W - 1), S_r, jnp.inf)
        disp_r = jnp.argmin(S_r, axis=-1) + min_disp        # (H, W)
        match_col = jnp.clip(
            jnp.arange(W)[None, :] - (best + min_disp), 0, W - 1)
        lr = jnp.take_along_axis(disp_r, match_col, axis=1)
        valid &= jnp.abs(lr - (best + min_disp)) <= disp12_max_diff

    invalid_val = jnp.float32((min_disp - 1) * 16)
    out = jnp.where(valid, disp16, invalid_val)
    return jnp.round(out).astype(jnp.int16)


def filter_speckles(disparity, new_val, max_speckle_size, max_diff):
    """Invalidate small connected blobs of similar disparity (host-side).

    Parity target: the ``cv2.filterSpeckles`` post-pass SGBM users apply.
    Connected components (4-connectivity) where neighboring pixels differ
    by <= max_diff; components smaller than max_speckle_size become
    new_val. Runs in numpy/scipy (post-processing, not on the hot path).
    """
    from scipy.ndimage import label

    d = np.asarray(disparity).copy()
    # Quantize into difference-bounded regions: two neighbors belong to the
    # same blob if |d1 - d2| <= max_diff.
    q = np.floor_divide(d.astype(np.int64), max(int(max_diff), 1))
    blobs = np.zeros_like(d, dtype=np.int64)
    n_total = 0
    for v in np.unique(q):
        lab, n = label(q == v)
        blobs = np.where(lab > 0, lab + n_total, blobs)
        n_total += n
    counts = np.bincount(blobs.ravel())
    small = counts[blobs] < max_speckle_size
    d[small & (blobs > 0)] = new_val
    return d


class StereoSGM:
    """Semi-Global Matcher with a ``cv2.StereoSGBM``-compatible surface.

    Drop-in for the reference's SGBM calls (examples/008:29-31,
    examples/010:37-39): ``compute`` returns int16 disparity scaled by 16.

    Parameters follow OpenCV naming; ``paths`` (4 or 8) replaces OpenCV's
    ``mode`` (8 ~ MODE_HH full-path aggregation).

    Beyond the OpenCV surface: ``costMethod`` selects the matching cost —
    ``"bt"`` (Birchfield-Tomasi on the Sobel prefilter, OpenCV-like,
    default), ``"census"`` (census transform + Hamming distance over a
    ``censusWindow`` x ``censusWindow`` window — invariant to monotonic
    radiometric differences between the cameras and slightly more
    accurate on Tsukuba: bad-2.0 2.7% at censusWindow=7, blockSize=3,
    P1=120, P2=480 vs 3.1% for the tuned BT point), or ``"bt+census"``
    (their sum, census scaled into BT's range). P1/P2 are per-cost-scale
    penalties: retune them when switching costMethod.
    """

    def __init__(self, minDisparity=0, numDisparities=16, blockSize=3,
                 P1=0, P2=0, disp12MaxDiff=-1, preFilterCap=63,
                 uniquenessRatio=10, speckleWindowSize=0, speckleRange=2,
                 paths=8, costMethod="bt", censusWindow=5):
        if numDisparities <= 0:
            raise ValueError("numDisparities must be positive!")
        if blockSize < 1 or blockSize % 2 == 0:
            raise ValueError("blockSize must be a positive odd number!")
        if costMethod not in ("bt", "census", "bt+census"):
            raise ValueError(
                "costMethod must be 'bt', 'census' or 'bt+census'!")
        if censusWindow not in (3, 5, 7):
            raise ValueError("censusWindow must be 3, 5 or 7!")
        self.minDisparity = minDisparity
        self.numDisparities = numDisparities
        self.blockSize = blockSize
        self.P1 = P1 if P1 > 0 else 8 * blockSize * blockSize
        self.P2 = P2 if P2 > 0 else 32 * blockSize * blockSize
        self.disp12MaxDiff = disp12MaxDiff
        self.preFilterCap = preFilterCap
        self.uniquenessRatio = uniquenessRatio
        self.speckleWindowSize = speckleWindowSize
        self.speckleRange = speckleRange
        self.paths = paths
        self.costMethod = costMethod
        self.censusWindow = censusWindow

    def compute(self, img1, img2, subpixel=True):
        """Compute (H, W) int16 disparity x16 for the pair."""
        out = _sgm_disparity(
            jnp.asarray(img1), jnp.asarray(img2),
            min_disp=self.minDisparity, num_disp=self.numDisparities,
            block_size=self.blockSize, P1=float(self.P1), P2=float(self.P2),
            paths=self.paths, prefilter_cap=float(self.preFilterCap),
            uniqueness=float(self.uniquenessRatio),
            disp12_max_diff=self.disp12MaxDiff, subpixel=subpixel,
            cost_method=self.costMethod, census_window=self.censusWindow)
        out = np.asarray(out)
        if self.speckleWindowSize > 0:
            out = filter_speckles(
                out, (self.minDisparity - 1) * 16,
                self.speckleWindowSize, self.speckleRange * 16)
        return out

    def computeBatch(self, imgs1, imgs2, subpixel=True):
        """Batched :meth:`compute`: (B, H, W[, 3]) stacks -> (B, H, W).

        One device program for the whole stack (frame batches fold into
        the lax.scan carries), so per-call dispatch is paid once per
        batch. Matches per-frame :meth:`compute` output.
        """
        imgs1 = np.ascontiguousarray(imgs1)
        imgs2 = np.ascontiguousarray(imgs2)
        # (B, H, 3)-shaped gray batches are indistinguishable from a
        # single color image — reject them to catch the common mistake of
        # passing one frame.
        if (imgs1.shape != imgs2.shape or imgs1.ndim not in (3, 4)
                or (imgs1.ndim == 3 and imgs1.shape[-1] == 3)
                or (imgs1.ndim == 4 and imgs1.shape[-1] != 3)):
            raise ValueError(
                "Batches must be (B, H, W) or (B, H, W, 3) stacks with "
                "identical shapes!")
        out = np.asarray(_sgm_disparity_batch(
            jnp.asarray(imgs1), jnp.asarray(imgs2),
            min_disp=self.minDisparity, num_disp=self.numDisparities,
            block_size=self.blockSize, P1=float(self.P1), P2=float(self.P2),
            paths=self.paths, prefilter_cap=float(self.preFilterCap),
            uniqueness=float(self.uniquenessRatio),
            disp12_max_diff=self.disp12MaxDiff, subpixel=subpixel,
            cost_method=self.costMethod, census_window=self.censusWindow))
        if self.speckleWindowSize > 0:
            out = np.stack([
                filter_speckles(o, (self.minDisparity - 1) * 16,
                                self.speckleWindowSize,
                                self.speckleRange * 16) for o in out])
        return out


# cv2-compatible constructor alias mirroring StereoSGBM_create.
def StereoSGBM_create(**kwargs):
    return StereoSGM(**kwargs)
