"""
parallel.sgm
============

Row-sharded multi-device SGM — the SURVEY §5 analog the reference has no
counterpart for (its SGM is a delegated single-process ``cv2.StereoSGBM``
call, e.g. /root/reference/examples/010 StereoMatchingTsukuba.py:37-39).

Decomposition over a ``jax.sharding.Mesh`` rows axis:

- **Cost volume** — local per shard after a small raw-row halo exchange
  (``ppermute``): the BT/census + box-filter receptive field is only
  ``blockSize//2 + max(1, censusWindow//2)`` rows.
- **Horizontal paths** — embarrassingly row-parallel (the scan runs along
  x), fully local.
- **Vertical + diagonal paths** — the SGM recurrence is a *non-associative*
  row recurrence, so cross-shard parallel prefix is not available. They
  run as a **wavefront pipeline**: each shard scans its own row block with
  ``lax.scan`` and hands the (k, W, D) boundary carry to its neighbor with
  ONE ``ppermute`` per tile boundary (not per row). Down-sweeps flow
  through shards 0→n-1 while up-sweeps flow n-1→0 concurrently, so two
  shards are active per stage and the sequential depth stays H rows of
  scan work split across n stages.
- **Winner-take-all / uniqueness / subpixel / LR check** — per-row
  (x-direction) operations, fully local.

Output is bit-identical to the single-device ``lax.scan``
pipeline: the per-component arithmetic and accumulation order replicate
:func:`simplestereo_jax.passive.sgm._aggregate` exactly, and the carry
handed across a tile boundary *is* the global scan's carry at that row.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..passive.sgm import (_edge_fill_rows, _roll_cols, _sgm_cost,
                           _sgm_post, _sgm_step)
from . import halo_exchange_rows


def _local_horizontal(C, P1, P2):
    """Both horizontal path sums (forward + backward stacked in one scan;
    same arithmetic as sgm._aggregate's horizontal block)."""
    H, W, D = C.shape
    Ch = jnp.stack([C, C[:, ::-1]], axis=0)          # (2, H, W, D)
    Ch = jnp.moveaxis(Ch, 2, 0)                      # (W, 2, H, D)

    def hstep(carry, c):
        out = _sgm_step(carry, c, P1, P2)
        return out, out

    init = jnp.zeros((2, H, D), C.dtype)
    _, oh = jax.lax.scan(hstep, init, Ch, unroll=4)
    oh = jnp.moveaxis(oh, 0, 2)                      # (2, H, W, D)
    return oh[0] + oh[1][:, ::-1]


def _vertical_wavefront(C, P1, P2, rolls, axis_name):
    """Vertical/diagonal path sums across row shards.

    Returns (down, up): (k, H_local, W, D) path sums for the k roll
    components scanning top→bottom resp. bottom→top (up is in flipped
    local row order, exactly like sgm._aggregate's ``ov[k+i]``).

    Pipeline: stage s activates shard s for the down-sweep and shard
    n-1-s for the up-sweep (``lax.cond`` keeps inactive shards idle);
    boundary carries move one shard per stage via ``ppermute`` — the only
    collective, one exchange per tile boundary.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    k = len(rolls)
    Hl, W, D = C.shape
    Cd = jnp.moveaxis(jnp.stack([C] * k, axis=0), 1, 0)       # (Hl, k, W, D)
    Cu = jnp.moveaxis(jnp.stack([C[::-1]] * k, axis=0), 1, 0)

    def vstep(carry, c):
        rolled = jnp.stack(
            [_roll_cols(carry[i], rolls[i]) for i in range(k)], axis=0)
        out = _sgm_step(rolled, c, P1, P2)
        return out, out

    def tile_scan(carry0, Cs):
        return jax.lax.scan(vstep, carry0, Cs, unroll=4)

    carry0 = jnp.zeros((k, W, D), C.dtype)
    out0 = jnp.zeros((Hl, k, W, D), C.dtype)

    def stage(s, state):
        cd, od, cu, ou = state
        cd, od = jax.lax.cond(
            idx == s, lambda: tile_scan(cd, Cd), lambda: (cd, od))
        cu, ou = jax.lax.cond(
            idx == n - 1 - s, lambda: tile_scan(cu, Cu), lambda: (cu, ou))
        if n > 1:
            # collectives stay OUTSIDE lax.cond: every shard permutes.
            cd = jax.lax.ppermute(
                cd, axis_name, [(i, i + 1) for i in range(n - 1)])
            cu = jax.lax.ppermute(
                cu, axis_name, [(i + 1, i) for i in range(n - 1)])
        return cd, od, cu, ou

    _, od, _, ou = jax.lax.fori_loop(
        0, n, stage, (carry0, out0, carry0, out0))
    return jnp.moveaxis(od, 1, 0), jnp.moveaxis(ou, 1, 0)  # (k, Hl, W, D)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "row_axis", "min_disp", "num_disp", "block_size", "P1", "P2",
    "paths", "prefilter_cap", "uniqueness", "disp12_max_diff", "subpixel",
    "cost_method", "census_window"))
def tiled_sgm_disparity(img1, img2, mesh, row_axis="rows", *,
                        min_disp=0, num_disp=16, block_size=3,
                        P1=None, P2=None, paths=8, prefilter_cap=63.0,
                        uniqueness=10.0, disp12_max_diff=-1, subpixel=True,
                        cost_method="bt", census_window=5):
    """Row-sharded SGM disparity over a device mesh.

    Parameters mirror :class:`simplestereo_jax.passive.StereoSGM`
    (OpenCV naming is on the class; this is the internal snake_case
    surface). Returns the OpenCV-convention (H, W) int16 disparity x16,
    bit-identical to the single-device pipeline.
    """
    if P1 is None:
        P1 = 8 * block_size * block_size
    if P2 is None:
        P2 = 32 * block_size * block_size
    H = img1.shape[0]
    n_rows = mesh.shape[row_axis]
    if H % n_rows:
        raise ValueError(f"image rows {H} not divisible by mesh axis "
                         f"{row_axis}={n_rows}")
    # Cost receptive field: blockSize//2 box rows around a pre-cost row
    # that sees 1 row (Sobel) or censusWindow//2 rows (census).
    pre = max(1, census_window // 2 if "census" in cost_method else 1)
    halo = block_size // 2 + pre
    rolls = (0, 1, -1) if paths >= 8 else (0,)
    k = len(rolls)
    spec = P(row_axis)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False)
    def run(i1, i2):
        e1, valid = halo_exchange_rows(i1, halo, row_axis)
        e2, _ = halo_exchange_rows(i2, halo, row_axis)
        # raw-row fill gives the Sobel/census stencils their edge-padded
        # *input* reach; the cost-level fill inside _sgm_cost (row_valid)
        # reproduces the box filter's edge padding of the cost volume.
        e1 = _edge_fill_rows(e1, valid)
        e2 = _edge_fill_rows(e2, valid)
        C = _sgm_cost(e1, e2, min_disp=min_disp, num_disp=num_disp,
                      block_size=block_size, prefilter_cap=prefilter_cap,
                      cost_method=cost_method, census_window=census_window,
                      row_valid=valid)[halo:-halo]
        S = _local_horizontal(C, float(P1), float(P2))
        od, ou = _vertical_wavefront(C, float(P1), float(P2), rolls,
                                     row_axis)
        # accumulate in sgm._aggregate's exact order for bit-parity
        for i in range(k):
            S = S + od[i]
            S = S + ou[i][::-1]
        return _sgm_post(S, min_disp=min_disp, num_disp=num_disp,
                         uniqueness=uniqueness,
                         disp12_max_diff=disp12_max_diff, subpixel=subpixel)

    return run(jnp.asarray(img1), jnp.asarray(img2))


__all__ = ["tiled_sgm_disparity"]
