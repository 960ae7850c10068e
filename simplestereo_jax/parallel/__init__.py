"""
parallel
========

Multi-device/multi-host scaling for the dense stereo pipelines.

The reference's only parallelism is a CPU thread pool draining a row queue
(/root/reference/simplestereo/_passive.cpp:351-396 with
headers/safequeue.hpp). The device-mesh equivalents are:

- **frame-batch data parallelism** — shard a batch of stereo pairs over a
  mesh axis (``P("batch")``); embarrassingly parallel, no collectives;
- **spatial row tiling** — shard image rows over a mesh axis and exchange
  ``winSize//2`` halo rows with neighbors via ``lax.ppermute`` (the direct
  analog of blockwise attention's neighbor exchange, SURVEY.md §5);
  results are bit-identical to the single-device kernel because halo rows
  received at the *global* image boundary are re-marked invalid
  (``row_valid``) exactly like the kernel's own sentinel padding;
- **collective reductions** — ``psum`` for global statistics /
  bundle-adjustment normal equations (calibration).

All of it is expressed with ``jax.sharding.Mesh`` + ``shard_map``; XLA
inserts the collectives and, on GPUs, hands them to NCCL. Every sharded
program is jitted (mesh and configuration static): a ``shard_map`` called
outside ``jit`` runs op by op on every call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def make_mesh(axis_sizes, devices=None):
    """Build a ``jax.sharding.Mesh``.

    Parameters
    ----------
    axis_sizes : dict
        e.g. ``{"batch": 2, "rows": 4}``. Product must equal device count.
    devices : optional list of jax devices (default: all).
    """
    if devices is None:
        devices = jax.devices()
    names = tuple(axis_sizes)
    shape = tuple(axis_sizes[n] for n in names)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh {axis_sizes} needs {int(np.prod(shape))} devices, "
            f"got {len(devices)}")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, names)


def halo_exchange_rows(x, halo, axis_name, row_axis=0):
    """Extend a row-sharded block with ``halo`` rows from each neighbor.

    x : array whose ``row_axis`` dimension holds this shard's image rows
    (call inside shard_map; e.g. (H_local, W, 3) with ``row_axis=0`` or a
    frame batch (B, H_local, W, 3) with ``row_axis=1``).
    Returns (x extended by 2*halo rows along ``row_axis``,
    (H_local + 2*halo,) bool row_valid): boundary shards have no neighbor
    on one side; those halo rows are filled with zeros and flagged invalid
    so downstream kernels exclude them exactly like out-of-image rows.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    hl = x.shape[row_axis]
    valid_mid = jnp.ones((hl,), bool)

    def rows(a, start, count):
        return jax.lax.slice_in_dim(a, start, start + count, axis=row_axis)

    if n == 1:
        zshape = list(x.shape)
        zshape[row_axis] = halo
        z = jnp.zeros(tuple(zshape), x.dtype)
        ext = jnp.concatenate([z, x, z], axis=row_axis)
        valid = jnp.concatenate(
            [jnp.zeros((halo,), bool), valid_mid, jnp.zeros((halo,), bool)])
        return ext, valid
    # send my bottom rows down -> they become the next shard's top halo
    from_prev = jax.lax.ppermute(
        rows(x, hl - halo, halo), axis_name,
        [(i, i + 1) for i in range(n - 1)])
    # send my top rows up -> they become the previous shard's bottom halo
    from_next = jax.lax.ppermute(
        rows(x, 0, halo), axis_name, [(i + 1, i) for i in range(n - 1)])
    ext = jnp.concatenate([from_prev, x, from_next], axis=row_axis)
    top_ok = jnp.broadcast_to(idx > 0, (halo,))
    bot_ok = jnp.broadcast_to(idx < n - 1, (halo,))
    valid = jnp.concatenate([top_ok, valid_mid, bot_ok])
    return ext, valid


@functools.partial(jax.jit, static_argnames=(
    "mesh", "row_axis", "win_size", "max_disp", "min_disp", "consistent",
    "interpret"))
def tiled_asw_disparity(img1, img2, mesh, row_axis="rows", win_size=35,
                        max_disp=16, min_disp=0, gamma_c=5.0, gamma_p=17.5,
                        consistent=False, interpret=False):
    """Row-sharded ASW disparity over a device mesh.

    Shards image rows over ``mesh[row_axis]``, exchanges winSize//2 halo
    rows with ppermute, and runs the matcher per shard in *context*
    mode: the halo rows feed the boundary windows as sources only, so no
    disparity is computed just to be discarded. Consistency check and
    occlusion fill are per-row (x-direction) operations, so they stay
    shard-local. Output is bit-identical to the single-device matcher.
    ``interpret`` runs the GPU kernel in the Pallas interpreter.
    """
    from ..passive.asw import asw_disparity

    halo = win_size // 2
    H = img1.shape[0]
    n_rows = mesh.shape[row_axis]
    if H % n_rows:
        raise ValueError(f"image rows {H} not divisible by mesh axis "
                         f"{row_axis}={n_rows}")

    spec = P(row_axis)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False)
    def run(i1, i2):
        e1, valid = halo_exchange_rows(i1, halo, row_axis)
        e2, _ = halo_exchange_rows(i2, halo, row_axis)
        return asw_disparity(
            e1, e2, win_size=win_size, max_disp=max_disp, min_disp=min_disp,
            gamma_c=gamma_c, gamma_p=gamma_p, consistent=consistent,
            interpret=interpret, row_valid=valid, context=halo > 0)

    return run(jnp.asarray(img1), jnp.asarray(img2))


@functools.partial(jax.jit, static_argnames=(
    "mesh", "row_axis", "batch_axis", "win_size", "max_disp", "min_disp",
    "consistent", "interpret"))
def tiled_asw_disparity_batch(imgs1, imgs2, mesh, row_axis="rows",
                              batch_axis="batch", win_size=35, max_disp=16,
                              min_disp=0, gamma_c=5.0, gamma_p=17.5,
                              consistent=False, interpret=False):
    """Frame-batch DP x spatial row tiling over a 2-D device mesh.

    (B, H, W, 3) stacks are sharded over ``mesh[batch_axis]`` on the frame
    axis and ``mesh[row_axis]`` on the row axis; each shard exchanges
    winSize//2 halo rows with its row-neighbors (ppermute) and runs one
    batched matcher call. Output matches the single-device matcher.
    """
    from ..passive.asw import asw_disparity_batch

    halo = win_size // 2
    B, H = imgs1.shape[:2]
    n_rows = mesh.shape[row_axis]
    n_batch = mesh.shape[batch_axis]
    if H % n_rows:
        raise ValueError(f"image rows {H} not divisible by mesh axis "
                         f"{row_axis}={n_rows}")
    if B % n_batch:
        raise ValueError(f"batch {B} not divisible by mesh axis "
                         f"{batch_axis}={n_batch}")

    spec = P(batch_axis, row_axis)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False)
    def run(i1, i2):
        e1, valid = halo_exchange_rows(i1, halo, row_axis, row_axis=1)
        e2, _ = halo_exchange_rows(i2, halo, row_axis, row_axis=1)
        rv = jnp.broadcast_to(valid, (e1.shape[0],) + valid.shape)
        return asw_disparity_batch(
            e1, e2, win_size=win_size, max_disp=max_disp, min_disp=min_disp,
            gamma_c=gamma_c, gamma_p=gamma_p, consistent=consistent,
            interpret=interpret, row_valid=rv, context=halo > 0)

    return run(jnp.asarray(imgs1), jnp.asarray(imgs2))


def batch_parallel(fn, mesh, batch_axis="batch"):
    """Data-parallel map of a per-example ``fn`` over a sharded batch.

    ``fn`` maps unbatched pytrees to unbatched pytrees; the returned
    callable applies it to arrays with a leading batch dimension sharded
    over ``mesh[batch_axis]`` — no collectives.

    Per shard the local batch is applied by an unrolled Python loop, so
    ``fn`` may hold any kernel (N identical calls in one program share
    one compilation). For the flagship matcher prefer
    :func:`simplestereo_jax.passive.asw_disparity_batch`, which runs the
    local frames as one batched call.
    """
    spec = P(batch_axis)

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=spec, out_specs=spec,
        check_vma=False)
    def run(*args):
        n = jax.tree.leaves(args)[0].shape[0]
        outs = [fn(*jax.tree.map(lambda a: a[i], args)) for i in range(n)]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)

    return run


def psum_stats(x, mesh, axis_names):
    """Global (sum, count) of ``x`` sharded over ``axis_names`` — the
    pattern used for bundle-adjustment normal-equation reductions."""
    return _psum_stats(x, mesh=mesh, axis_names=tuple(axis_names))


@functools.partial(jax.jit, static_argnames=("mesh", "axis_names"))
def _psum_stats(x, *, mesh, axis_names):
    spec = P(*axis_names)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=spec, out_specs=P(),
        check_vma=False)
    def run(xl):
        s = jnp.sum(xl)
        c = jnp.asarray(xl.size, jnp.float32)
        for a in axis_names:
            s = jax.lax.psum(s, a)
            c = jax.lax.psum(c, a)
        return jnp.stack([s, c])

    return run(x)


from .sgm import tiled_sgm_disparity          # noqa: E402
from .gsw import tiled_gsw_disparity          # noqa: E402
from .ftp import sharded_ftp_cloud            # noqa: E402

__all__ = [
    "make_mesh",
    "halo_exchange_rows",
    "tiled_asw_disparity",
    "tiled_asw_disparity_batch",
    "tiled_sgm_disparity",
    "tiled_gsw_disparity",
    "sharded_ftp_cloud",
    "batch_parallel",
    "psum_stats",
]
