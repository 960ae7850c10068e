"""
parallel.gsw
============

Row-sharded GSW matcher. With the closed-form support weights
(passive/gsw.py — the reference's chamfer recursion collapses to the
direct color distance), every GSW stage is elementwise or a window-local
reduce, so row sharding needs only a ``winSize//2`` halo exchange and no
other collectives; the consistent-mode LR check and occlusion fill are
per-row (x-direction) and stay local.

Global-boundary halo rows are filled with a large finite sentinel
(1e9): their color distance to any real pixel underflows
``exp(-d/gamma)`` to exactly 0, reproducing the single-device matcher's
inf-padded out-of-image semantics (a finite sentinel keeps the capped
cost ``min(fMax, dist)`` NaN-free where both operands are padding).
Output is bit-identical to the single-device matcher.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..passive.gsw import gsw_disparity
from . import halo_exchange_rows

_SENTINEL = 1e9  # exp(-1e9/gamma) == 0.0 in f32 for any sane gamma


@functools.partial(jax.jit, static_argnames=(
    "mesh", "row_axis", "win_size", "max_disp", "min_disp", "gamma", "f_max",
    "iterations", "consistent", "normalize", "step"))
def tiled_gsw_disparity(img1, img2, mesh, row_axis="rows", *,
                        win_size=11, max_disp=16, min_disp=0, gamma=10.0,
                        f_max=120.0, iterations=1, consistent=False,
                        normalize=False, step=1):
    """Row-sharded GSW disparity over a device mesh (bit-identical to
    :func:`simplestereo_jax.passive.gsw_disparity`)."""
    halo = win_size // 2
    H = img1.shape[0]
    n = mesh.shape[row_axis]
    if H % n:
        raise ValueError(f"image rows {H} not divisible by mesh axis "
                         f"{row_axis}={n}")
    spec = P(row_axis)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False)
    def run(i1, i2):
        e1, valid = halo_exchange_rows(i1.astype(jnp.float32), halo,
                                       row_axis)
        e2, _ = halo_exchange_rows(i2.astype(jnp.float32), halo, row_axis)
        e1 = jnp.where(valid[:, None, None], e1, _SENTINEL)
        e2 = jnp.where(valid[:, None, None], e2, _SENTINEL)
        d = gsw_disparity(e1, e2, win_size=win_size, max_disp=max_disp,
                          min_disp=min_disp, gamma=gamma, f_max=f_max,
                          iterations=iterations, consistent=consistent,
                          normalize=normalize, step=step)
        return d[halo:-halo] if halo else d

    return run(jnp.asarray(img1), jnp.asarray(img2))


__all__ = ["tiled_gsw_disparity"]
