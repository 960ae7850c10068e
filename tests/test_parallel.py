"""Multi-device sharding: row-tiled matching parity, DP batching, psum.

Runs on the virtual 8-device CPU mesh (conftest.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from simplestereo_jax import parallel
from simplestereo_jax.passive import asw_disparity


@pytest.fixture(scope="module")
def mesh8():
    return parallel.make_mesh({"rows": 4, "batch": 2})


def test_make_mesh_validates():
    with pytest.raises(ValueError):
        parallel.make_mesh({"rows": 3})


@pytest.mark.parametrize("consistent", [False, True])
def test_tiled_asw_matches_single_device(rng, consistent):
    mesh = parallel.make_mesh({"rows": 8})
    img1 = rng.integers(0, 256, (32, 40, 3), np.uint8)
    img2 = np.roll(img1, -2, axis=1)
    kw = dict(win_size=5, max_disp=4, min_disp=0, consistent=consistent)
    single = np.asarray(asw_disparity(img1, img2, **kw))
    tiled = np.asarray(parallel.tiled_asw_disparity(
        img1, img2, mesh, row_axis="rows", **kw))
    mismatch = (single != tiled).mean()
    assert mismatch <= 0.005, f"tiled/single mismatch {mismatch:.2%}"


@pytest.mark.parametrize("consistent", [False, True])
def test_tiled_asw_kernel_matches_single_device(rng, consistent):
    """shard_map around the GPU kernel (Pallas interpreter here) in
    context mode, with invalid halo rows at the global boundary, equals
    the single-device matcher bit for bit."""
    mesh = parallel.make_mesh({"rows": 4}, devices=jax.devices()[:4])
    img1 = rng.integers(0, 256, (32, 40, 3), np.uint8)
    img2 = np.roll(img1, -2, axis=1)
    kw = dict(win_size=5, max_disp=4, min_disp=0, consistent=consistent)
    single = np.asarray(asw_disparity(img1, img2, **kw))
    tiled = np.asarray(parallel.tiled_asw_disparity(
        img1, img2, mesh, row_axis="rows", interpret=True, **kw))
    np.testing.assert_array_equal(single, tiled)


def test_tiled_asw_rejects_indivisible_rows(mesh8):
    img = np.zeros((30, 16, 3), np.uint8)
    with pytest.raises(ValueError):
        parallel.tiled_asw_disparity(img, img, mesh8, win_size=5)


def test_batch_parallel(mesh8):
    fn = lambda x: x.astype(jnp.float32) * 2 + 1
    run = parallel.batch_parallel(fn, mesh8, batch_axis="batch")
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    out = np.asarray(run(x))
    np.testing.assert_allclose(out, x * 2 + 1)


def test_psum_stats(mesh8):
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    s, c = np.asarray(parallel.psum_stats(x, mesh8, ("rows", "batch")))
    assert s == x.sum() and c == x.size


@pytest.mark.parametrize("consistent", [False, True])
def test_tiled_batch_matches_single_device(rng, mesh8, consistent):
    """Frame-DP x row-tiling over the 2-D mesh (the dryrun_multichip
    program shape: one batched matcher call per shard, halo ppermute)
    matches per-frame single-device output."""
    img1 = rng.integers(0, 256, (4, 16, 40, 3), np.uint8)
    img2 = np.roll(img1, -2, axis=2)
    kw = dict(win_size=5, max_disp=4, min_disp=0, consistent=consistent)
    tiled = np.asarray(parallel.tiled_asw_disparity_batch(
        img1, img2, mesh8, row_axis="rows", batch_axis="batch", **kw))
    for i in range(4):
        single = np.asarray(asw_disparity(img1[i], img2[i], **kw))
        mismatch = (single != tiled[i]).mean()
        assert mismatch <= 0.005, f"frame {i} mismatch {mismatch:.2%}"
