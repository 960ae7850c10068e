"""GSW matcher (the fused-XLA path) against a small numpy per-pixel
oracle of the closed-form cost, plus batching and the SD/MI decision.

The oracle evaluates, in float64 and one window offset at a time,
``cost(x, d) = sum_window w * min(fMax, ||left(p) - right(p - d)||)``
with ``w = exp(-||left(p) - left(x)|| / gamma)`` (0 off the image), the
optional normalization by the summed weight of target-valid pixels, and
the winner-take-all / left-right check / occlusion fill of the matcher.
float32 sums can reorder exact-arithmetic ties, so every disagreement
must be a near-tie in the oracle's own costs.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from simplestereo_jax.passive.gsw import (StereoGSW, _gsw_mi_step,
                                          _gsw_weights, _mi_cost_table,
                                          _quantize_gray, gsw_disparity)


def _pair(rng, h, w, shift=-2):
    img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
    return img1, np.roll(img1, shift, axis=1)


def _window(a, pad, i, j, fill):
    """a sampled at (y + i - pad, x + j - pad), ``fill`` off the image."""
    H, W = a.shape[:2]
    p = np.full((H + 2 * pad, W + 2 * pad) + a.shape[2:], fill, np.float64)
    p[pad:pad + H, pad:pad + W] = a
    return p[i:i + H, j:j + W]


def _target(a, d, fill=0.0):
    """out(y, x) = a(y, x - d), ``fill`` where x - d leaves the image."""
    W = a.shape[1]
    out = np.full(a.shape, fill, np.float64)
    xs = np.arange(W)
    ok = (xs - d >= 0) & (xs - d <= W - 1)
    out[:, ok] = a[:, xs[ok] - d]
    return out, ok


def _weights(img, win, gamma):
    pad = win // 2
    f = img.astype(np.float64)
    return [[np.nan_to_num(np.exp(-np.sqrt(
        ((_window(f, pad, i, j, np.inf) - f) ** 2).sum(-1)) / gamma))
        for j in range(win)] for i in range(win)]


def _aggregate(w, maps, win, step, valid=None):
    """sum_window w * map, optionally divided by sum_window w * valid."""
    pad = win // 2
    num = den = 0.0
    for i in range(win):
        for j in range(win):
            if (i - pad) % step or (j - pad) % step:
                continue
            num = num + w[i][j] * _window(maps, pad, i, j, 0.0)
            if valid is not None:
                den = den + w[i][j] * _window(valid, pad, i, j, 0.0)
    return num if valid is None else num / np.maximum(den, 1e-12)


def _wta(costs, min_disp):
    """costs (D, H, W) -> disparity, the matcher's empty-range rule."""
    W = costs.shape[2]
    xs = np.arange(W)
    disp = costs.argmin(0) + min_disp
    return np.where(xs[None] < min_disp, xs[None], disp)


def _oracle_costs(img1, img2, win, mind, maxd, gamma, f_max, step,
                  normalize):
    f1, f2 = img1.astype(np.float64), img2.astype(np.float64)
    w = _weights(img1, win, gamma)
    W = img1.shape[1]
    xs = np.arange(W)
    costs = []
    for d in range(mind, maxd + 1):
        sh, ok = _target(f2, d)
        m = np.minimum(np.sqrt(((f1 - sh) ** 2).sum(-1)), f_max) * ok
        valid = np.broadcast_to(ok.astype(np.float64), m.shape)
        c = _aggregate(w, m, win, step, valid if normalize else None)
        costs.append(np.where((xs - d >= 0) & (xs - d <= W - 1), c, np.inf))
    return np.stack(costs)


def _occlusion_fill(disp, invalid):
    out = disp.copy()
    for row, src in zip(out, disp):
        ok = np.flatnonzero(src != invalid)
        for x in np.flatnonzero(src == invalid):
            left, right = ok[ok < x], ok[ok > x]
            vals = ([src[left[-1]]] if len(left) else []) \
                + ([src[right[0]]] if len(right) else [])
            if vals:
                row[x] = min(vals)
    return out


def _oracle(img1, img2, win, mind, maxd, consistent, step=1, gamma=10.0,
            f_max=60.0, normalize=False):
    """(disparity, left-reference costs)."""
    cl = _oracle_costs(img1, img2, win, mind, maxd, gamma, f_max, step,
                       normalize)
    dl = _wta(cl, mind)
    if not consistent:
        return dl, cl
    cr = _oracle_costs(img2[:, ::-1], img1[:, ::-1], win, mind, maxd,
                       gamma, f_max, step, normalize)
    W = img1.shape[1]
    xs = np.arange(W)[None]
    dr = _wta(cr, mind)[:, ::-1]
    dr = np.where((W - 1 - xs) < mind, -xs, dr)
    L = np.clip(xs + dr, 0, W - 1)
    agree = np.take_along_axis(dl, L, 1) == dr
    marker = -1 if mind >= 0 else mind - 1
    disagree = np.zeros(dl.shape, bool)
    for y in range(dl.shape[0]):
        for x in range(W):
            if not agree[y, x]:
                disagree[y, L[y, x]] = True
    return _occlusion_fill(np.where(disagree, marker, dl), marker), cl


def _assert_near_ties(costs, got, want, min_disp, rtol=1e-5):
    """Every pixel where got and want pick different candidates must be
    a near-tie of ``costs`` (D, H, W)."""
    sel = got != want
    a = np.take_along_axis(costs, (got - min_disp)[None], 0)[0][sel]
    b = np.take_along_axis(costs, (want - min_disp)[None], 0)[0][sel]
    assert (np.abs(a - b) <= rtol * np.abs(b)).all(), (a, b)


def _assert_matches_oracle(got, oracle, min_disp, consistent):
    want, cl = oracle
    assert (got != want).mean() <= 0.01, (got != want).mean()
    if not consistent:
        # a consistency fill can carry a flipped tie along its row; the
        # plain map must differ only at near-ties
        xs = np.arange(got.shape[1])[None]
        in_range = np.broadcast_to(xs >= min_disp, got.shape)
        _assert_near_ties(cl, np.where(in_range, got, min_disp),
                          np.where(in_range, want, min_disp), min_disp)


CASES = [
    # (h, w, win, min_disp, max_disp, consistent, step)
    (20, 40, 5, 0, 4, False, 1),
    (24, 52, 7, 2, 9, True, 1),
    (17, 33, 5, -3, 4, True, 1),     # negative minDisparity (marker path)
    (9, 17, 1, 0, 3, True, 1),       # win=1 degenerate window
    (12, 20, 9, 2, 2, False, 1),     # single-candidate range (D=1)
    (16, 140, 7, 0, 5, True, 1),     # wide frame
    (16, 48, 3, 0, 20, False, 1),    # D=21
    (16, 48, 3, -2, 19, True, 1),    # D=22 + consistent + negative minD
    (24, 52, 9, 2, 9, True, 2),      # subsampled window lattice (step)
    (17, 33, 5, -3, 4, True, 3),     # step + negative minDisparity
    (16, 48, 5, 0, 20, True, 2),     # step + D=21
]


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", CASES)
def test_gsw_matches_numpy_oracle(rng, h, w, win, mind, maxd, cons, step):
    img1, img2 = _pair(rng, h, w)
    got = np.asarray(gsw_disparity(
        img1, img2, win_size=win, min_disp=mind, max_disp=maxd, gamma=10.0,
        f_max=60.0, consistent=cons, step=step))
    assert got.shape == (h, w) and got.dtype == np.int16
    _assert_matches_oracle(got, _oracle(img1, img2, win, mind, maxd, cons,
                                        step), mind, cons)


NORM_CASES = [
    (20, 40, 5, 0, 4, False, 1),
    (24, 52, 7, 2, 9, True, 1),
    (17, 33, 5, -3, 4, True, 1),
    (16, 48, 3, 0, 20, False, 1),
    (24, 52, 9, 2, 9, True, 2),
    (16, 140, 7, 0, 5, True, 1),
]


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", NORM_CASES)
def test_gsw_normalize_matches_numpy_oracle(rng, h, w, win, mind, maxd,
                                            cons, step):
    """normalize: window costs become weighted means over the
    target-valid pixels (ASW-style)."""
    img1, img2 = _pair(rng, h, w)
    got = np.asarray(gsw_disparity(
        img1, img2, win_size=win, min_disp=mind, max_disp=maxd, gamma=10.0,
        f_max=60.0, consistent=cons, step=step, normalize=True))
    _assert_matches_oracle(got, _oracle(img1, img2, win, mind, maxd, cons,
                                        step, normalize=True), mind, cons)


def test_gsw_sentinel_float_rows_match_oracle(rng):
    """The sharded path (parallel/gsw.py) feeds float images whose
    global-boundary halo rows carry a 1e9 sentinel: they must act as
    off-image pixels (weight 0), like the oracle's padding."""
    img1 = rng.integers(0, 256, (16, 40, 3), np.uint8).astype(np.float32)
    img2 = np.roll(img1, -3, axis=1)
    pad = np.full((2, 40, 3), 1e9, np.float32)
    i1 = np.concatenate([pad, img1, pad])
    i2 = np.concatenate([pad, img2, pad])
    kw = dict(win_size=5, max_disp=4, consistent=True)
    got = np.asarray(gsw_disparity(i1, i2, **kw))[2:-2]
    want = np.asarray(gsw_disparity(img1, img2, **kw))
    np.testing.assert_array_equal(got, want)


def test_gsw_normalize_changes_borders_only(rng):
    """normalize rescales the window cost by the summed weight of the
    candidate-VALID pixels; away from the candidate-validity boundary
    the denominator is d-independent, so the argmin — and the disparity
    — can only change near the left border band."""
    img1, img2 = _pair(rng, 20, 60)
    kw = dict(win_size=7, min_disp=0, max_disp=5, gamma=10.0, f_max=60.0)
    plain = np.asarray(gsw_disparity(img1, img2, **kw))
    norm = np.asarray(gsw_disparity(img1, img2, normalize=True, **kw))
    band = 5 + 7 // 2  # max_disp + pad
    np.testing.assert_array_equal(plain[:, band:], norm[:, band:])
    assert (plain[:, :band] != norm[:, :band]).any()  # it does something


MI_CASES = [
    # (h, w, win, min_disp, max_disp)
    (20, 40, 5, 0, 4),
    (24, 52, 7, 2, 9),
    (17, 33, 5, -3, 4),
    (16, 48, 3, 0, 20),
]


@pytest.mark.parametrize("h,w,win,mind,maxd", MI_CASES)
def test_gsw_mi_step_matches_numpy_oracle(rng, h, w, win, mind, maxd):
    """One MI refinement: from the cost table of the previous matching,
    per-pixel costs T'[q1(x), q2(x - d)] (T' = table - min(table), zero
    off the image) aggregated with the geodesic weights, then WTA."""
    img1, img2 = _pair(rng, h, w)
    bins = 8
    q1 = _quantize_gray(jnp.asarray(img1), bins)
    q2 = _quantize_gray(jnp.asarray(img2), bins)
    prev = jnp.asarray(rng.integers(mind, maxd + 1, (h, w)), jnp.int32)
    wj = _gsw_weights(jnp.asarray(img1), win, 1, 10.0)
    got = np.asarray(_gsw_mi_step(wj, q1, q2, prev, win_size=win,
                                  min_disp=mind, max_disp=maxd, bins=bins))

    table = np.asarray(_mi_cost_table(q1, q2, prev, prev >= 0, bins=bins),
                       np.float64)
    flat = table - table.min()
    q1n, q2n = np.asarray(q1), np.asarray(q2)
    wts = _weights(img1, win, 10.0)
    xs = np.arange(w)
    costs = []
    for d in range(mind, maxd + 1):
        sh, ok = _target(q2n.astype(np.float64), d)
        m = flat[q1n, sh.astype(int)] * ok
        c = _aggregate(wts, m, win, 1)
        costs.append(np.where((xs - d >= 0) & (xs - d <= w - 1), c, np.inf))
    costs = np.stack(costs)
    want = _wta(costs, mind)
    # table costs tie exactly where windows read the same bins, so only
    # the near-tie rule applies here
    in_range = np.arange(w)[None] >= mind
    _assert_near_ties(costs, np.where(in_range, got, mind),
                      np.where(in_range, want, mind), mind)


@pytest.mark.parametrize("extra", [
    dict(), dict(normalize=True), dict(costMethod="mi", bins=8)],
    ids=["sd", "normalize", "mi"])
@pytest.mark.parametrize("consistent", [False, True])
def test_gsw_compute_batch_matches_compute(rng, extra, consistent):
    imgs1 = rng.integers(0, 256, (3, 16, 40, 3), np.uint8)
    imgs2 = np.stack([np.roll(a, -2, axis=1) for a in imgs1])
    m = StereoGSW(winSize=5, maxDisparity=4, consistent=consistent, **extra)
    b = m.computeBatch(imgs1, imgs2)
    for i in range(3):
        np.testing.assert_array_equal(b[i], m.compute(imgs1[i], imgs2[i]))


def test_gsw_validation(rng):
    img1, img2 = _pair(rng, 12, 24)
    with pytest.raises(ValueError):
        gsw_disparity(img1, img2, step=0)
    with pytest.raises(ValueError):
        gsw_disparity(img1, img2, step=2, cost_method="mi")
    with pytest.raises(ValueError):
        # 0 would return the random bootstrap field
        gsw_disparity(img1, img2, cost_method="mi", mi_iterations=0)
    with pytest.raises(ValueError):
        StereoGSW(winSize=4)


# --------------------------------------------------------------------------
# costMethod="auto": the SD/MI decision rule
# --------------------------------------------------------------------------

class TestCostMethodAuto:
    def test_probe_separates_matched_from_mismatched(self, tsukuba):
        """The validated anchors: a real matched pair scores well under
        the threshold; a gamma-0.5 right image scores far over it."""
        from simplestereo_jax.passive.gsw import (
            MI_AUTO_THRESHOLD, radiometric_divergence)

        left, right = tsukuba["left"], tsukuba["right"]
        plain = radiometric_divergence(left, right)
        assert plain < MI_AUTO_THRESHOLD / 2, plain
        g05 = np.clip(255.0 * (right / 255.0) ** 0.5, 0, 255) \
            .astype(np.uint8)
        mm = radiometric_divergence(left, g05)
        assert mm > 2 * MI_AUTO_THRESHOLD, mm

    def test_resolve_passthrough_and_auto(self, tsukuba):
        from simplestereo_jax.passive.gsw import resolve_cost_method

        left, right = tsukuba["left"], tsukuba["right"]
        assert resolve_cost_method(left, right, "sd") == "sd"
        assert resolve_cost_method(left, right, "mi") == "mi"
        assert resolve_cost_method(left, right, "auto") == "sd"
        g05 = np.clip(255.0 * (right / 255.0) ** 0.5, 0, 255) \
            .astype(np.uint8)
        assert resolve_cost_method(left, g05, "auto") == "mi"

    def test_compute_auto_records_choice_and_runs(self, rng):
        """End-to-end: auto resolves per pair, records lastCostMethod,
        and the chosen pipeline actually recovers the shift."""
        img1 = rng.integers(0, 256, (16, 40, 3), np.uint8)
        img2 = np.roll(img1, -2, axis=1)
        m = StereoGSW(winSize=5, maxDisparity=4, gamma=10.0, fMax=60.0,
                      costMethod="auto", bins=8, miIterations=2,
                      consistent=True)
        d = m.compute(img1, img2)
        assert m.lastCostMethod == "sd"
        assert (d[4:-4, 6:-6] == 2).mean() > 0.9

        g05 = np.clip(255.0 * (img2 / 255.0) ** 0.5, 0, 255) \
            .astype(np.uint8)
        m.compute(img1, g05)
        assert m.lastCostMethod == "mi"

    def test_compute_batch_auto_resolves_once(self, rng):
        imgs1 = rng.integers(0, 256, (2, 12, 32, 3), np.uint8)
        imgs2 = np.roll(imgs1, -2, axis=2)
        m = StereoGSW(winSize=5, maxDisparity=4, costMethod="auto", bins=8)
        m.computeBatch(imgs1, imgs2)
        assert m.lastCostMethod == "sd"

    def test_invalid_cost_method_rejected(self):
        with pytest.raises(ValueError, match="costMethod"):
            StereoGSW(costMethod="nope")

    def test_auto_batch_probe_matches_single_frame_probe(self):
        """The batch probe must histogram per-pixel GRAY means exactly
        like the single-frame probe — an all-green vs all-gray pair has
        identical gray distributions (EMD 0) and must resolve 'sd' from
        both entry points."""
        from simplestereo_jax.passive.gsw import (
            radiometric_divergence, resolve_cost_method)

        g = np.zeros((12, 24, 3), np.uint8)
        g[..., 1] = 255  # pure green, gray mean 85
        h = np.full((12, 24, 3), 85, np.uint8)  # gray, same mean
        assert radiometric_divergence(g, h) < 4.0
        assert radiometric_divergence(g[None], h[None]) \
            == radiometric_divergence(g, h)
        assert resolve_cost_method(g[None], h[None], "auto") == "sd"

    def test_auto_with_step_never_resolves_mi(self, rng):
        """auto + step>1 must fall back to 'sd' even on a radiometrically
        mismatched pair (resolving 'mi' there was a data-dependent
        ValueError mid-capture)."""
        img1 = rng.integers(0, 256, (16, 40, 3), np.uint8)
        img2 = np.clip(255.0 * (np.roll(img1, -2, axis=1) / 255.0) ** 0.5,
                       0, 255).astype(np.uint8)
        m = StereoGSW(winSize=5, maxDisparity=4, costMethod="auto", step=2)
        m.compute(img1, img2)  # must not raise
        assert m.lastCostMethod == "sd"
        with pytest.raises(ValueError, match="step"):  # explicit mi rejected
            gsw_disparity(img1, img2, win_size=5, max_disp=4,
                          cost_method="mi", step=2)
