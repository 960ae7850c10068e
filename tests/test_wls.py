"""Tests for the WLS (fast global smoother) disparity post-filter."""

import numpy as np
import pytest

from simplestereo_jax.passive import fast_global_smoother, \
    wls_filter_disparity


def test_constant_signal_is_fixed_point(rng):
    guide = rng.integers(0, 256, (12, 18)).astype(np.float32)
    src = np.full((12, 18), 7.25, np.float32)
    out = fast_global_smoother(src, guide, lambda_=500.0)
    np.testing.assert_allclose(out, 7.25, atol=1e-3)


def test_smooths_noise_within_regions(rng):
    src = np.full((16, 24), 10.0, np.float32)
    noisy = src + rng.normal(0, 1.0, src.shape).astype(np.float32)
    out = fast_global_smoother(noisy, np.zeros_like(src), lambda_=200.0)
    assert np.abs(out - src).std() < 0.3 * np.abs(noisy - src).std()


def test_edge_preserving(rng):
    """A strong guide edge blocks smoothing across it."""
    H, W = 16, 24
    guide = np.zeros((H, W), np.float32)
    guide[:, W // 2:] = 255.0
    src = np.zeros((H, W), np.float32)
    src[:, W // 2:] = 10.0
    noisy = src + rng.normal(0, 0.5, src.shape).astype(np.float32)
    out = fast_global_smoother(noisy, guide, lambda_=200.0, sigma_color=8.0)
    # each side stays near its level; the step survives
    assert np.abs(out[:, :W // 2 - 1]).max() < 1.0
    assert np.abs(out[:, W // 2 + 1:] - 10.0).max() < 1.0
    assert out[:, W // 2].mean() - out[:, W // 2 - 1].mean() > 8.0


def test_invalid_pixels_filled_from_neighbors(rng):
    """Zero-confidence (invalid) pixels take propagated values."""
    d = np.full((12, 20), 5.0 * 16, np.float32)
    d[5:7, 8:12] = -16.0          # invalid block (SGM marker style)
    guide = np.zeros((12, 20), np.float32)
    out = wls_filter_disparity(d, guide, lambda_=64.0, invalid=-16,
                               disp_scale=1 / 16.0)
    assert np.abs(out - 5.0).max() < 0.2


def test_batched_matches_per_frame(rng):
    d = rng.normal(8, 2, (2, 10, 14)).astype(np.float32)
    g = rng.integers(0, 256, (2, 10, 14, 3)).astype(np.float32)
    batch = fast_global_smoother(d, g, lambda_=50.0)
    for i in range(2):
        np.testing.assert_allclose(
            batch[i], fast_global_smoother(d[i], g[i], lambda_=50.0),
            rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        wls_filter_disparity(d[0, 0], g)          # 1-D disparity
    with pytest.raises(ValueError):
        wls_filter_disparity(d, g[:1])            # mismatched batch


@pytest.mark.slow
def test_wls_fills_lr_checked_sgm_on_tsukuba(ref_res):
    """Production pipeline gate: census SGM with LR check + uniqueness
    leaves ~7% of nonocc invalid-or-bad; WLS filling/smoothing must
    bring dense bad-2.0 under 3.2% and avgerr under 0.50 px (measured
    2.83% / 0.44 px at lambda=2)."""
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.passive import StereoSGM
    from simplestereo_jax.evaluation import evaluate_disparity, tsukuba_scale

    d = ref_res / "tsukuba"
    left = imread(str(d / "tsukuba_l.png"))
    right = imread(str(d / "tsukuba_r.png"))
    gt = imread(str(d / "groundtruth.png"), grayscale=True)
    nonocc = imread(str(d / "nonocc.png"), grayscale=True) > 0

    m = StereoSGM(minDisparity=0, numDisparities=16, blockSize=3,
                  P1=120, P2=480, uniquenessRatio=10, disp12MaxDiff=1,
                  costMethod="census", censusWindow=7)
    d16 = m.compute(left, right)
    filt = wls_filter_disparity(d16, np.asarray(left).mean(-1),
                                lambda_=2.0, sigma_color=8.0,
                                invalid=-16, disp_scale=1 / 16.0)
    r = evaluate_disparity(filt, gt, nonocc, bad_thresholds=(2.0,),
                           gt_scale=tsukuba_scale)
    assert r["bad2"] <= 0.032, r["bad2"]
    assert r["avgerr"] <= 0.50, r["avgerr"]


# --------------------------------------------------------------------------
# quality_disparity preset (one-call best-quality composition)
# --------------------------------------------------------------------------

def _shift_scene(rng, H=24, W=48, d_true=3):
    """Textured pair with a uniform integer shift of d_true:
    left(x) == right(x - d_true)."""
    base = rng.integers(0, 256, (H, W + d_true, 3), np.uint8)
    img1 = base[:, :W]               # left
    img2 = base[:, d_true:]          # right: img1[x] = img2[x - d_true]
    return img1, img2


@pytest.mark.parametrize("matcher", ["asw", "sgm"])
def test_quality_preset_recovers_shift(rng, matcher):
    from simplestereo_jax.passive import quality_disparity

    d_true = 3
    img1, img2 = _shift_scene(rng, d_true=d_true)
    kw = dict(matcher=matcher, min_disp=0, max_disp=6)
    if matcher == "asw":
        kw.update(win_size=7)
    disp = quality_disparity(img1, img2, **kw)
    assert disp.shape == img1.shape[:2]
    assert disp.dtype == np.float32
    assert np.isfinite(disp).all()          # dense: no invalid markers
    inner = disp[4:-4, 8:-4]
    # sub-pixel float output centered on the true shift
    assert abs(np.median(inner) - d_true) < 0.5
    assert (np.abs(inner - d_true) < 1.0).mean() > 0.9


def test_quality_preset_validates_inputs(rng):
    from simplestereo_jax.passive import quality_disparity

    img1, img2 = _shift_scene(rng)
    with pytest.raises(ValueError):
        quality_disparity(img1[..., 0], img2[..., 0])
    with pytest.raises(ValueError):
        quality_disparity(img1, img2, matcher="magic")


@pytest.mark.slow
def test_quality_preset_sgm_tsukuba_gate(ref_res):
    """The preset's sgm point must reproduce the measured dense-quality
    gate (2.83% bad-2.0 / 0.44 px avgerr at lambda=2)."""
    from simplestereo_jax.imgio import imread
    from simplestereo_jax.passive import quality_disparity
    from simplestereo_jax.evaluation import evaluate_disparity, tsukuba_scale

    d = ref_res / "tsukuba"
    left = imread(str(d / "tsukuba_l.png"))
    right = imread(str(d / "tsukuba_r.png"))
    gt = imread(str(d / "groundtruth.png"), grayscale=True)
    nonocc = imread(str(d / "nonocc.png"), grayscale=True) > 0

    disp = quality_disparity(left, right, 0, 15, matcher="sgm")
    r = evaluate_disparity(disp, gt, nonocc, bad_thresholds=(2.0,),
                           gt_scale=tsukuba_scale)
    assert r["bad2"] <= 0.032, r["bad2"]
    assert r["avgerr"] <= 0.50, r["avgerr"]
