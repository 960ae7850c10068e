"""Property tests: matcher invariants over randomized shapes/params.

Complements the parity suites: for any accepted configuration the
matchers must return the right shape/dtype and disparities inside the
candidate range (or the documented fill semantics) — no NaNs, no
out-of-range values, no shape errors at odd sizes.
"""

import numpy as np
import pytest

from simplestereo_jax.passive import (StereoASW, StereoGSW, StereoSGM,
                                      asw_disparity, asw_disparity_ref)


def _pair(rng, h, w):
    img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
    img2 = np.roll(img1, -min(2, w // 4), axis=1)
    return img1, img2


CASES = [
    # (h, w, winSize, minD, maxD, consistent, step)
    (9, 17, 1, 0, 3, False, 1),      # win=1 degenerate window
    (8, 16, 3, 0, 2, True, 1),
    (23, 31, 5, -2, 3, False, 1),    # negative minDisparity
    (16, 130, 7, 1, 5, True, 2),     # W past four kernel column tiles
    (12, 20, 9, 2, 2, False, 1),     # single-candidate range (D=1)
    (25, 33, 5, 0, 18, True, 1),     # D>16: two kernel candidate chunks
    (20, 40, 5, -3, 16, True, 1),    # D>16 + negative minDisparity
    (12, 40, 11, 0, 4, True, 1),     # window wider than the range
    (12, 40, 13, -2, 4, True, 1),    # ... with negative minDisparity
]


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", CASES)
def test_asw_invariants(rng, h, w, win, mind, maxd, cons, step):
    img1, img2 = _pair(rng, h, w)
    m = StereoASW(winSize=win, maxDisparity=maxd, minDisparity=mind,
                  consistent=cons, step=step)
    out = m.compute(img1, img2)
    assert out.shape == (h, w) and out.dtype == np.int16
    assert np.isfinite(out.astype(np.float64)).all()
    # range: candidates plus the documented empty-range fill (x - 0 for
    # x < minD) and the invalid marker on fully-invalid consistent rows
    # (-1, or minD - 1 when minD < 0 — -1 is a legal disparity then)
    marker = -1 if mind >= 0 else mind - 1
    lo = min(mind, marker if cons else 0, 0)
    assert out.min() >= lo and out.max() <= max(maxd, w - 1)

    # repeat-call determinism
    assert np.array_equal(np.asarray(m.compute(img1, img2)), out)
    m2 = StereoASW(winSize=win, maxDisparity=maxd, minDisparity=mind,
                   consistent=cons, step=step, subpixel=True)
    s = m2.compute(img1, img2)
    assert s.dtype == np.float32
    assert np.abs(s - out).max() <= 0.5 + 1e-6


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", CASES)
def test_asw_kernel_matches_xla_form(rng, h, w, win, mind, maxd, cons,
                                     step):
    """The GPU kernel (Pallas interpreter) and the XLA form agree on every
    fuzz shape; with minDisparity >= 0 both equal the oracle."""
    img1, img2 = _pair(rng, h, w)
    kw = dict(win_size=win, max_disp=maxd, min_disp=mind, consistent=cons,
              step=step)
    xla = np.asarray(asw_disparity(img1, img2, **kw))
    kern = np.asarray(asw_disparity(img1, img2, interpret=True, **kw))
    np.testing.assert_array_equal(kern, xla)
    if mind >= 0:
        np.testing.assert_array_equal(
            xla, np.asarray(asw_disparity_ref(img1, img2, **kw)))


@pytest.mark.parametrize("h,w,nd,bs,paths", [
    (10, 18, 4, 1, 4),      # blockSize=1 (no box sum)
    (9, 17, 3, 3, 8),       # odd sizes, D=3
    (16, 129, 8, 5, 8),     # W past a lane tile
    (8, 12, 16, 3, 4),      # D larger than half the width
])
def test_sgm_invariants(rng, h, w, nd, bs, paths):
    img1, img2 = _pair(rng, h, w)
    m = StereoSGM(minDisparity=0, numDisparities=nd, blockSize=bs,
                  paths=paths, disp12MaxDiff=1)
    out = m.compute(img1, img2)
    assert out.shape == (h, w) and out.dtype == np.int16
    valid = out >= 0
    if valid.any():
        assert out[valid].max() <= (nd - 1) * 16 + 8  # x16 + subpixel
    # batching folds into the scan carries without changing a value
    np.testing.assert_array_equal(
        m.computeBatch(img1[None], img2[None])[0], out)


@pytest.mark.parametrize("method,cw", [
    ("census", 3), ("census", 5), ("census", 7), ("bt+census", 5)])
def test_sgm_census_invariants(rng, method, cw):
    img1, img2 = _pair(rng, 12, 40)
    m = StereoSGM(minDisparity=0, numDisparities=4, blockSize=3,
                  paths=4, costMethod=method, censusWindow=cw)
    out = m.compute(img1, img2)
    assert out.shape == (12, 40) and out.dtype == np.int16
    valid = out >= 0
    assert valid.any() and out[valid].max() <= 3 * 16 + 8


def test_census_cost_monotonic_invariance(rng):
    """The census cost volume is BIT-EXACTLY invariant to any strictly
    increasing intensity remap of either camera (all > comparisons
    inside the window are preserved); the BT cost is not. This pins both
    the invariance property and that costMethod dispatch actually
    switches costs."""
    from simplestereo_jax.passive.sgm import _bt_cost, _census_cost

    g1 = rng.integers(0, 200, (16, 24)).astype(np.float32)
    g2 = np.roll(g1, -2, axis=1)
    # strictly increasing remap: gamma + gain + offset
    m2 = (g2 / 200.0) ** 2.2 * 120.0 + 30.0
    c_a = np.asarray(_census_cost(g1, g2, 0, 4, 5))
    c_b = np.asarray(_census_cost(g1, m2, 0, 4, 5))
    np.testing.assert_array_equal(c_a, c_b)
    b_a = np.asarray(_bt_cost(g1, g2, 0, 4))
    b_b = np.asarray(_bt_cost(g1, m2, 0, 4))
    assert not np.array_equal(b_a, b_b)
    # census cost range: integral Hamming distances in [0, 24]
    assert c_a.min() >= 0 and c_a.max() <= 24


def test_sgm_census_radiometric_robustness(rng):
    """End-to-end: census matching recovers the shift through a
    monotonic radiometric map (gamma + gain) of one camera."""
    h, w, shift = 24, 64, 3
    # Smooth random texture so the gamma map keeps local orderings.
    base = rng.random((h, w + shift))
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = (base - base.min()) / (base.max() - base.min())
    # target col = x - d: img1[x] = base[x] = img2[x - shift] -> d = +shift
    img1 = (base[:, :-shift] * 255).astype(np.uint8)
    img2g = (base[:, shift:] ** 2.2) * 140 + 40  # gamma 2.2, gain+offset
    img2 = img2g.astype(np.uint8)
    img1 = np.repeat(img1[..., None], 3, axis=2)
    img2 = np.repeat(img2[..., None], 3, axis=2)

    inner = np.zeros((h, w), bool)
    inner[4:-4, 10:-10] = True

    def frac_correct(m):
        d = m.compute(img1, img2)
        return ((np.round(d / 16.0) == shift) & inner).sum() / inner.sum()

    census = frac_correct(StereoSGM(
        minDisparity=0, numDisparities=8, blockSize=3, P1=56, P2=224,
        uniquenessRatio=0, paths=8, costMethod="census"))
    assert census > 0.9, census


def test_sgm_cost_method_validation():
    with pytest.raises(ValueError):
        StereoSGM(costMethod="sad")
    with pytest.raises(ValueError):
        StereoSGM(costMethod="census", censusWindow=4)


def test_sgm_negative_min_disparity(rng):
    """cv2.StereoSGBM accepts minDisparity < 0; candidates past either
    image edge must be masked, not wrapped."""
    img1, img2 = _pair(rng, 14, 22)
    m = StereoSGM(minDisparity=-4, numDisparities=8, blockSize=3,
                  paths=8, disp12MaxDiff=1)
    out = m.compute(img1, img2)
    assert out.shape == (14, 22) and out.dtype == np.int16
    valid = out > (-4 - 1) * 16
    assert valid.any()
    assert out[valid].min() >= -4 * 16 - 8
    assert out[valid].max() <= 3 * 16 + 8

    # target col = x - d: img2 = img1 rolled right by 2 -> true d = -2;
    # the LR check must not invalidate it (both edges masked in disp_r).
    img3 = np.roll(img1, 2, axis=1)
    d = m.compute(img1, img3)
    inner = np.round(d[3:-3, 6:-6] / 16.0)
    assert (inner == -2).mean() > 0.9


@pytest.mark.parametrize("size", [1, 3, 5])
def test_median_disparity_matches_scipy(rng, size):
    from scipy.ndimage import median_filter
    from simplestereo_jax.passive import median_disparity
    d = rng.integers(-16, 300, (13, 21)).astype(np.int16)
    out = median_disparity(d, size)
    assert out.dtype == np.int16 and out.shape == d.shape
    np.testing.assert_array_equal(out, median_filter(d, size, mode="nearest"))
    # batched = per-frame
    batch = median_disparity(np.stack([d, d[::-1]]), size)
    np.testing.assert_array_equal(batch[0], out)


def test_median_disparity_removes_isolated_invalids(rng):
    from simplestereo_jax.passive import median_disparity
    d = np.full((9, 9), 7, np.int16)
    d[4, 4] = -16  # isolated invalid marker
    out = median_disparity(d, 3)
    assert (out == 7).all()
    with pytest.raises(ValueError):
        median_disparity(d, 4)
    with pytest.raises(ValueError):
        median_disparity(d[None, None], 3)


@pytest.mark.parametrize("h,w,win,maxd", [
    (8, 14, 1, 2), (11, 19, 3, 4), (10, 16, 5, 3)])
def test_gsw_invariants(rng, h, w, win, maxd):
    img1, img2 = _pair(rng, h, w)
    m = StereoGSW(winSize=win, maxDisparity=maxd, iterations=1)
    out = m.compute(img1, img2)
    assert out.shape == (h, w) and out.dtype == np.int16
    assert out.min() >= 0 and out.max() <= max(maxd, w - 1)


@pytest.mark.parametrize("consistent", [False, True])
def test_gsw_negative_min_disparity(rng, consistent):
    """GSW accepts minDisparity < 0 (cv2-style range) and recovers a
    known negative shift, including through the consistent check."""
    img1 = rng.integers(0, 256, (14, 30, 3), np.uint8)
    img2 = np.roll(img1, 2, axis=1)   # target col = x + 2 -> d = -2
    m = StereoGSW(winSize=3, minDisparity=-4, maxDisparity=4,
                  iterations=1, consistent=consistent)
    d = m.compute(img1, img2)
    inner = d[3:-3, 6:-6]
    assert (inner == -2).mean() > 0.9


@pytest.mark.slow
def test_sgm_census_tsukuba_quality_gate(ref_res):
    """Quality gate for the benchmark operating point: census-SGM on
    Tsukuba must stay at bad-2.0 <= 3.0% (measured 2.69%; the tuned BT
    point scores 3.07%). Guards against cost/aggregation regressions
    that the shape/range fuzz cannot see."""
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.evaluation import evaluate_disparity, tsukuba_scale

    d = ref_res / "tsukuba"
    left = imread(str(d / "tsukuba_l.png"))
    right = imread(str(d / "tsukuba_r.png"))
    gt = imread(str(d / "groundtruth.png"), grayscale=True)
    nonocc = imread(str(d / "nonocc.png"), grayscale=True) > 0

    m = StereoSGM(minDisparity=0, numDisparities=16, blockSize=3,
                  P1=120, P2=480, uniquenessRatio=0,
                  costMethod="census", censusWindow=7)
    disp = m.compute(left, right)
    r = evaluate_disparity(disp, gt, nonocc, bad_thresholds=(2.0,),
                           disp_scale=1 / 16.0, gt_scale=tsukuba_scale)
    assert r["bad2"] <= 0.030, r["bad2"]


@pytest.mark.slow
def test_gsw_tsukuba_quality_gate(ref_res):
    """Quality gate for GSW's tuned operating point (round 3): the
    closed-form weights (gsw.py:_gsw_weights — the reference's chamfer
    recursion provably collapses to the direct color distance) at
    winSize=23, gamma=12.5, fMax=20, consistent must stay at
    bad-2.0 <= 4.0% on Tsukuba (measured 3.28%; round-2 defaults scored
    7.4%)."""
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.evaluation import evaluate_disparity, tsukuba_scale

    d = ref_res / "tsukuba"
    left = imread(str(d / "tsukuba_l.png"))
    right = imread(str(d / "tsukuba_r.png"))
    gt = imread(str(d / "groundtruth.png"), grayscale=True)
    nonocc = imread(str(d / "nonocc.png"), grayscale=True) > 0

    m = StereoGSW(winSize=23, maxDisparity=16, gamma=12.5, fMax=20,
                  consistent=True)
    disp = m.compute(left, right)
    r = evaluate_disparity(disp, gt, nonocc, bad_thresholds=(2.0,),
                           gt_scale=tsukuba_scale)
    assert r["bad2"] <= 0.040, r["bad2"]
