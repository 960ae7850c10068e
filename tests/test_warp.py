"""Warping engine: remap interpolation modes, undistort maps, and
scipy cross-validation."""

import numpy as np
import pytest
import jax.numpy as jnp

from simplestereo_jax import warp


@pytest.fixture
def img(rng):
    return rng.integers(0, 256, (24, 31, 3), np.uint8)


def _identity_maps(h, w):
    mx, my = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    return mx, my


def test_remap_identity_all_modes(img):
    h, w = img.shape[:2]
    mx, my = _identity_maps(h, w)
    for mode in ("nearest", "linear", "cubic"):
        out = np.asarray(warp.remap(jnp.asarray(img), jnp.asarray(mx),
                                    jnp.asarray(my), interpolation=mode))
        np.testing.assert_allclose(
            out, img.astype(out.dtype), atol=0.51 if mode == "cubic" else 0,
            err_msg=mode)


def test_remap_matches_scipy_linear(img):
    from scipy.ndimage import map_coordinates as sp_map

    h, w = img.shape[:2]
    rng = np.random.default_rng(3)
    mx = rng.uniform(1, w - 2, (h, w)).astype(np.float32)
    my = rng.uniform(1, h - 2, (h, w)).astype(np.float32)
    src = img[..., 0].astype(np.float32)
    out = np.asarray(warp.remap(jnp.asarray(src), jnp.asarray(mx),
                                jnp.asarray(my), interpolation="linear"))
    ref = sp_map(src.astype(np.float64), [my, mx], order=1)
    np.testing.assert_allclose(np.asarray(out, np.float64), ref, atol=0.01)


def test_remap_border_value(img):
    h, w = img.shape[:2]
    mx = np.full((h, w), -10.0, np.float32)  # everything out of image
    my = np.full((h, w), -10.0, np.float32)
    out = np.asarray(warp.remap(jnp.asarray(img), jnp.asarray(mx),
                                jnp.asarray(my), border_value=7.0))
    assert (out == 7).all()


def test_undistort_identity_for_zero_coeffs(img):
    K = np.array([[30.0, 0, 15.5], [0, 30.0, 12.0], [0, 0, 1]])
    out = np.asarray(warp.undistort_image(img, K, np.zeros(5)))
    # zero distortion + same camera matrix -> identity warp
    np.testing.assert_allclose(out, img, atol=0.51)


def test_init_undistort_rectify_map_roundtrip(rng):
    """Map lookup must equal the forward-distorted pixel position:
    mapx/mapy(u) = distort(K_new^-1 u), the cv2 semantics."""
    from simplestereo_jax.geometry import distortion

    K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1]])
    dist = np.array([0.05, -0.02, 0.001, 0.002, 0.01])
    size = (32, 24)
    mx, my = warp.init_undistort_rectify_map(K, dist, np.eye(3), K, size)
    mx, my = np.asarray(mx), np.asarray(my)

    us, vs = np.meshgrid(np.arange(32, dtype=float),
                         np.arange(24, dtype=float))
    norm = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1]], -1)
    dpts = np.asarray(distortion.distort_normalized(
        jnp.asarray(norm.reshape(-1, 2)), jnp.asarray(dist))).reshape(
        24, 32, 2)
    np.testing.assert_allclose(mx, dpts[..., 0] * K[0, 0] + K[0, 2],
                               atol=1e-4)
    np.testing.assert_allclose(my, dpts[..., 1] * K[1, 1] + K[1, 2],
                               atol=1e-4)


def test_get_optimal_new_camera_matrix_alpha_extremes():
    K = np.array([[100.0, 0, 64.0], [0, 100.0, 48.0], [0, 0, 1]])
    dist = np.array([0.1, -0.05, 0.0, 0.0, 0.0])
    K0, roi0 = warp.get_optimal_new_camera_matrix(K, dist, (128, 96), 0.0)
    K1, roi1 = warp.get_optimal_new_camera_matrix(K, dist, (128, 96), 1.0)
    # alpha=0 zooms in (no invalid pixels) vs alpha=1 keeps all source
    # pixels: focal(alpha=0) >= focal(alpha=1)
    assert K0[0, 0] >= K1[0, 0]
    assert len(roi0) == 4 and len(roi1) == 4


def test_map_coordinates_matches_scipy(rng):
    from scipy.ndimage import map_coordinates as sp_map

    img = rng.random((20, 25))
    coords = np.stack([rng.uniform(0, 19, 40), rng.uniform(0, 24, 40)])
    out = np.asarray(warp.map_coordinates(jnp.asarray(img),
                                          jnp.asarray(coords), order=1))
    ref = sp_map(img, coords, order=1)
    np.testing.assert_allclose(out, ref, atol=1e-6)


class TestRemapRowInvariant:
    """warp.remap_row_invariant must match remap exactly on row-constant
    images (it is the FTP virtual-reference fast path — round 5)."""

    @pytest.mark.parametrize("interp", ["nearest", "linear", "cubic"])
    def test_matches_remap_on_row_constant_image(self, rng, interp):
        H, W = 37, 53
        row = (rng.random(W) * 200 + 10).astype(np.float32)
        img = jnp.asarray(np.tile(row[None, :], (H, 1)))
        # maps cover interior, borders and far out-of-image
        mapx = jnp.asarray(rng.uniform(-6, W + 6, (29, 41)), jnp.float32)
        mapy = jnp.asarray(rng.uniform(-6, H + 6, (29, 41)), jnp.float32)
        ref = np.asarray(warp.remap(img, mapx, mapy, interpolation=interp,
                                    border_value=3.25))
        fast = np.asarray(warp.remap_row_invariant(
            img, mapx, mapy, interpolation=interp, border_value=3.25))
        np.testing.assert_allclose(fast, ref, rtol=0, atol=1e-4)

    def test_uint8_rounding_and_rejects_3d(self, rng):
        H, W = 16, 24
        row = rng.integers(0, 256, W, np.uint8)
        img = jnp.asarray(np.tile(row[None, :], (H, 1)))
        mapx = jnp.asarray(rng.uniform(0, W - 1, (H, W)), jnp.float32)
        mapy = jnp.asarray(rng.uniform(0, H - 1, (H, W)), jnp.float32)
        ref = np.asarray(warp.remap(img, mapx, mapy,
                                    interpolation="cubic"))
        fast = np.asarray(warp.remap_row_invariant(
            img, mapx, mapy, interpolation="cubic"))
        assert fast.dtype == np.uint8
        # integer rounding can differ only where the float values tie
        assert (fast.astype(int) - ref.astype(int) == 0).mean() > 0.999
        with pytest.raises(ValueError):
            warp.remap_row_invariant(jnp.zeros((4, 5, 3)), mapx, mapy)


def test_remap_row_invariant_fuzz(rng):
    """Property fuzz: random shapes (incl. degenerate widths), all
    interpolations, random out-of-range maps — the fast path must track
    remap on every row-constant image."""
    for _ in range(12):
        H = int(rng.integers(1, 40))
        W = int(rng.integers(1, 60))
        row = (rng.random(W) * 255).astype(np.float32)
        img = jnp.asarray(np.tile(row[None, :], (H, 1)))
        Ho = int(rng.integers(1, 30))
        Wo = int(rng.integers(1, 30))
        mapx = jnp.asarray(rng.uniform(-8, W + 8, (Ho, Wo)), jnp.float32)
        mapy = jnp.asarray(rng.uniform(-8, H + 8, (Ho, Wo)), jnp.float32)
        interp = ["nearest", "linear", "cubic"][int(rng.integers(3))]
        bv = float(rng.uniform(0, 50))
        ref = np.asarray(warp.remap(img, mapx, mapy, interpolation=interp,
                                    border_value=bv))
        fast = np.asarray(warp.remap_row_invariant(
            img, mapx, mapy, interpolation=interp, border_value=bv))
        np.testing.assert_allclose(fast, ref, rtol=1e-5, atol=1e-3,
                                   err_msg=f"{H}x{W}->{Ho}x{Wo} {interp}")
