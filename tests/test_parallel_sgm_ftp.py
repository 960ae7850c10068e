"""Row-sharded SGM (wavefront pipeline) and FTP parity vs single-device.

Runs on the virtual 8-device CPU mesh (conftest.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from simplestereo_jax import parallel
from simplestereo_jax.passive.sgm import _sgm_disparity


def _pair(rng, h=32, w=48, shift=3):
    img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
    img2 = np.roll(img1, -shift, axis=1)
    return img1, img2


def _single(img1, img2, **kw):
    defaults = dict(min_disp=0, num_disp=8, block_size=3, P1=72, P2=288,
                    paths=8, prefilter_cap=63.0, uniqueness=10.0,
                    disp12_max_diff=-1, subpixel=True,
                    cost_method="bt", census_window=5)
    defaults.update(kw)
    return np.asarray(_sgm_disparity(jnp.asarray(img1), jnp.asarray(img2),
                                     **defaults))


@pytest.mark.parametrize("n_rows", [
    pytest.param(2, marks=pytest.mark.slow),
    pytest.param(4, marks=pytest.mark.slow),
    8,
])
def test_tiled_sgm_bit_parity(rng, n_rows):
    mesh = parallel.make_mesh({"rows": n_rows},
                              devices=None if n_rows == 8 else
                              __import__("jax").devices()[:n_rows])
    img1, img2 = _pair(rng)
    single = _single(img1, img2)
    tiled = np.asarray(parallel.tiled_sgm_disparity(
        img1, img2, mesh, num_disp=8))
    np.testing.assert_array_equal(single, tiled)


@pytest.mark.parametrize("cost_method", [
    "census",
    pytest.param("bt+census", marks=pytest.mark.slow),
])
def test_tiled_sgm_census_parity(rng, cost_method):
    mesh = parallel.make_mesh({"rows": 8})
    img1, img2 = _pair(rng, h=40)
    single = _single(img1, img2, cost_method=cost_method, P1=120, P2=480)
    tiled = np.asarray(parallel.tiled_sgm_disparity(
        img1, img2, mesh, num_disp=8, cost_method=cost_method,
        P1=120, P2=480))
    np.testing.assert_array_equal(single, tiled)


def test_tiled_sgm_negative_mindisp_lr(rng):
    mesh = parallel.make_mesh({"rows": 4},
                              devices=__import__("jax").devices()[:4])
    img1, img2 = _pair(rng)
    kw = dict(min_disp=-4, num_disp=12, disp12_max_diff=1, subpixel=False)
    single = _single(img1, img2, **kw)
    tiled = np.asarray(parallel.tiled_sgm_disparity(
        img1, img2, mesh, **kw))
    np.testing.assert_array_equal(single, tiled)


@pytest.mark.slow
def test_tiled_sgm_paths4(rng):
    mesh = parallel.make_mesh({"rows": 8})
    img1, img2 = _pair(rng)
    single = _single(img1, img2, paths=4)
    tiled = np.asarray(parallel.tiled_sgm_disparity(
        img1, img2, mesh, num_disp=8, paths=4))
    np.testing.assert_array_equal(single, tiled)


def test_tiled_sgm_rejects_indivisible_rows(rng):
    mesh = parallel.make_mesh({"rows": 8})
    img1, img2 = _pair(rng, h=30)
    with pytest.raises(ValueError):
        parallel.tiled_sgm_disparity(img1, img2, mesh)


# --------------------------------------------------------------------------
# sharded FTP
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ftp_setup():
    from tests.test_active import _make_rig, _proj_coords_for_plane
    from simplestereo_jax.active import buildFringe, StereoFTP
    from simplestereo_jax import warp

    rig = _make_rig()
    period = 16.0
    fringe = buildFringe(period, dims=tuple(rig.res2), stripeColor="red")
    z0 = 520.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    cam_img = np.asarray(warp.remap(
        jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
        jnp.asarray(mapv, jnp.float32), interpolation="linear"))
    ftp = StereoFTP(rig, fringe, period)
    return dict(ftp=ftp, cam_img=cam_img, z0=z0)


def test_sharded_ftp_matches_single_device(ftp_setup):
    mesh = parallel.make_mesh({"rows": 8})
    ftp = ftp_setup["ftp"]
    single = ftp.getCloud(ftp_setup["cam_img"])
    sharded = parallel.sharded_ftp_cloud(ftp, ftp_setup["cam_img"], mesh)
    assert sharded.shape == single.shape
    # identical up to y-unwrap float associativity (the prefix-sum offset
    # sums per-shard totals instead of one long cumsum)
    both = np.isfinite(single[..., 2]) & np.isfinite(sharded[..., 2])
    assert both.mean() > 0.9
    dz = np.abs(single[..., 2] - sharded[..., 2])[both]
    assert np.max(dz) < 1e-2, f"max z diff {np.max(dz)}"
    # and the cloud is still the plane
    center = sharded[20:-20, 20:-20, 2]
    center = center[np.isfinite(center)]
    assert abs(np.median(center) - ftp_setup["z0"]) < 0.02 * ftp_setup["z0"]


def test_sharded_ftp_rejects_indivisible_rows(ftp_setup):
    mesh = parallel.make_mesh({"rows": 8})
    with pytest.raises(ValueError):
        parallel.sharded_ftp_cloud(
            ftp_setup["ftp"], ftp_setup["cam_img"], mesh,
            roi=(0, 0, 128, 90))


# --------------------------------------------------------------------------
# tiled GSW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("consistent", [False, True])
def test_tiled_gsw_bit_parity(rng, consistent):
    from simplestereo_jax.passive.gsw import gsw_disparity

    mesh = parallel.make_mesh({"rows": 8})
    img1, img2 = _pair(rng, h=40, w=40)
    kw = dict(win_size=7, max_disp=5, min_disp=0, gamma=10.0, f_max=60.0,
              consistent=consistent)
    single = np.asarray(gsw_disparity(img1, img2, iterations=1, **kw))
    tiled = np.asarray(parallel.tiled_gsw_disparity(
        img1, img2, mesh, iterations=1, **kw))
    np.testing.assert_array_equal(single, tiled)


@pytest.mark.parametrize("consistent", [False, True])
def test_tiled_gsw_pallas_engine_bit_parity(rng, consistent):
    """A 4-device row mesh (halo rows reach across three boundaries) must
    reproduce the single-device result bit-for-bit, sentinel halo rows
    included."""
    from simplestereo_jax.passive.gsw import gsw_disparity

    mesh = parallel.make_mesh({"rows": 4},
                              devices=__import__("jax").devices()[:4])
    img1, img2 = _pair(rng, h=24, w=40)
    kw = dict(win_size=5, max_disp=4, min_disp=0, gamma=10.0, f_max=60.0,
              consistent=consistent)
    single = np.asarray(gsw_disparity(img1, img2, iterations=1, **kw))
    tiled = np.asarray(parallel.tiled_gsw_disparity(
        img1, img2, mesh, iterations=1, **kw))
    np.testing.assert_array_equal(single, tiled)


def test_tiled_gsw_pallas_normalize_bit_parity(rng):
    """normalize under shard_map — sentinel halo rows contribute exact
    0.0 to both num and den, so the tiled run must stay bit-identical to
    the single-device matcher."""
    from simplestereo_jax.passive.gsw import gsw_disparity

    mesh = parallel.make_mesh({"rows": 4},
                              devices=__import__("jax").devices()[:4])
    img1, img2 = _pair(rng, h=24, w=40)
    kw = dict(win_size=5, max_disp=4, min_disp=0, gamma=10.0, f_max=60.0,
              consistent=True, normalize=True)
    single = np.asarray(gsw_disparity(img1, img2, iterations=1, **kw))
    tiled = np.asarray(parallel.tiled_gsw_disparity(
        img1, img2, mesh, iterations=1, **kw))
    np.testing.assert_array_equal(single, tiled)


@pytest.mark.slow
def test_tiled_gsw_normalized_negative_mindisp(rng):
    from simplestereo_jax.passive.gsw import gsw_disparity

    mesh = parallel.make_mesh({"rows": 4},
                              devices=__import__("jax").devices()[:4])
    img1 = rng.integers(0, 256, (32, 40, 3), np.uint8)
    img2 = np.roll(img1, 2, axis=1)     # d = -2
    kw = dict(win_size=5, max_disp=3, min_disp=-5, gamma=12.0, f_max=30.0,
              normalize=True, consistent=True)
    single = np.asarray(gsw_disparity(img1, img2, iterations=1, **kw))
    tiled = np.asarray(parallel.tiled_gsw_disparity(
        img1, img2, mesh, iterations=1, **kw))
    np.testing.assert_array_equal(single, tiled)


@pytest.mark.slow
def test_sharded_ftp_anaglyph(rng):
    """The "br" gray mode's global min/max ride pmin/pmax collectives."""
    from tests.test_active import _make_rig, _proj_coords_for_plane
    from simplestereo_jax.active import buildAnaglyphFringe, StereoFTPAnaglyph
    from simplestereo_jax import warp

    rig = _make_rig()
    period = 16.0
    fringe = buildAnaglyphFringe(period, dims=tuple(rig.res2))
    z0 = 520.0
    mapu, mapv, _ = _proj_coords_for_plane(rig, z0)
    cam_img = np.asarray(warp.remap(
        jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
        jnp.asarray(mapv, jnp.float32), interpolation="linear"))
    ftp = StereoFTPAnaglyph(rig, fringe, period, stripeColor="green")
    mesh = parallel.make_mesh({"rows": 8})
    single = ftp.getCloud(cam_img)
    sharded = parallel.sharded_ftp_cloud(ftp, cam_img, mesh)
    both = np.isfinite(single[..., 2]) & np.isfinite(sharded[..., 2])
    dz = np.abs(single[..., 2] - sharded[..., 2])[both]
    assert np.max(dz) < 1e-2, f"max z diff {np.max(dz)}"


@pytest.mark.slow
def test_tiled_sgm_fuzz_shapes_params(rng):
    """Randomized shapes/params: tiled == single must hold bit-exactly
    everywhere, not just at the fixed test points."""
    import jax

    for _ in range(3):
        n = int(rng.choice([2, 4, 8]))
        h = n * int(rng.integers(3, 7))
        w = int(rng.integers(20, 64))
        min_disp = int(rng.integers(-5, 3))
        num_disp = int(rng.integers(4, 12))
        bs = int(rng.choice([1, 3, 5]))
        cm = str(rng.choice(["bt", "census"]))
        sub = bool(rng.integers(0, 2))
        lr = int(rng.choice([-1, 1]))
        mesh = parallel.make_mesh({"rows": n}, devices=jax.devices()[:n])
        img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
        img2 = np.roll(img1, -int(rng.integers(0, 4)), axis=1)
        kw = dict(min_disp=min_disp, num_disp=num_disp, block_size=bs,
                  cost_method=cm, subpixel=sub, disp12_max_diff=lr,
                  P1=8 * bs * bs, P2=32 * bs * bs)
        single = _single(img1, img2, **kw)
        tiled = np.asarray(parallel.tiled_sgm_disparity(
            img1, img2, mesh, **kw))
        np.testing.assert_array_equal(
            single, tiled,
            err_msg=f"n={n} h={h} w={w} {kw}")


@pytest.mark.slow
def test_sharded_ftp_roi_parity(ftp_setup):
    """Non-trivial ROI: the shard row0 / roi_x / roi_y offset math must
    reproduce the single-device crop exactly."""
    mesh = parallel.make_mesh({"rows": 8})
    ftp = ftp_setup["ftp"]
    roi = (8, 8, 112, 80)   # 80 rows / 8 shards
    single = ftp.getCloud(ftp_setup["cam_img"], roi=roi)
    sharded = parallel.sharded_ftp_cloud(ftp, ftp_setup["cam_img"],
                                         mesh, roi=roi)
    assert sharded.shape == single.shape == (80, 112, 3)
    both = np.isfinite(single[..., 2]) & np.isfinite(sharded[..., 2])
    assert both.mean() > 0.9
    dz = np.abs(single[..., 2] - sharded[..., 2])[both]
    assert np.max(dz) < 1e-2, f"max z diff {np.max(dz)}"
