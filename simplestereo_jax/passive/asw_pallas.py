"""
asw_pallas
==========

Fused ASW cost volume for the GPU: a Pallas kernel on the Triton route.

Replaces the reference's C++ thread-pool kernel
(reference simplestereo/_passive.cpp: workerASW :16-105,
workerASWconsistent :108-289) with one program per output tile:

- **Grid** ``(frame, disparity chunk, row tile, column tile)``. A tile is
  ``TILE`` output pixels; a chunk holds up to 16 candidates (more would
  spill the per-candidate sums out of registers), so wide ranges run as
  several chunks side by side.
- **Window walk.** A ``fori_loop`` over the window offsets, rows outer and
  columns inner — the order of the oracle and of the XLA form
  (:func:`simplestereo_jax.passive.asw._cost_volume_xla`), so each pixel
  sums the same terms in the same order. Every offset reads shifted
  windows of the padded planes through ``pl.ds`` slices (L1/L2 hits),
  evaluates the reference weight once, and accumulates all candidates of
  the chunk. The weighted sums never leave registers; the kernel writes
  only the final ``num / den`` of each candidate.
- **Validity by sentinel padding** (see :mod:`.asw`): window pixels off
  the image get weight exactly 0, so the loop has no branches.

The cost is a three-way elementwise product with no contraction, so the
tensor cores have nothing to do here; the kernel is bound by arithmetic
and the special-function units (two square roots and an exponential per
candidate and offset).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .asw import _lab_dist

TILE = (8, 32)     # output rows x columns per program (powers of two)
NUM_WARPS = 4
_D_CHUNK = 16      # most candidates whose sums one program keeps


def d_chunk(D):
    """Candidates per program: ``D`` split into equal chunks of <= 16."""
    n = -(-D // _D_CHUNK)
    return -(-D // n)


def _kernel(prox_ref, gc_ref, lab1_ref, lab2_ref, tad_ref, out_ref, *, g):
    b, ch, r, c = (pl.program_id(k) for k in range(4))
    th, tw = g.tile
    r0, c0 = r * th, c * tw
    d0 = g.min_disp + ch * g.d_chunk
    gamma_c = gc_ref[0]
    ctr_rows = pl.ds(r0 + g.pad, th)
    ctr1 = [lab1_ref[b, k, ctr_rows, pl.ds(c0 + g.left, tw)]
            for k in range(3)]
    ctr2 = [[lab2_ref[b, k, ctr_rows, pl.ds(c0 + g.left - d0 - dd, tw)]
             for k in range(3)] for dd in range(g.d_chunk)]

    def body(m, carry):
        num, den = list(carry[0]), list(carry[1])
        i = g.o0 + jax.lax.div(m, g.n_o) * g.step
        j = g.o0 + jax.lax.rem(m, g.n_o) * g.step
        rows = pl.ds(r0 + i, th)
        col = c0 + g.left - g.pad + j
        dl1 = _lab_dist([lab1_ref[b, k, rows, pl.ds(col, tw)]
                         for k in range(3)], ctr1)
        p = prox_ref[i, j]
        for dd in range(g.d_chunk):
            dl2 = _lab_dist([lab2_ref[b, k, rows, pl.ds(col - d0 - dd, tw)]
                             for k in range(3)], ctr2[dd])
            w = p * jnp.exp(-(dl1 + dl2) / gamma_c)
            t = tad_ref[b, ch * g.d_chunk + dd, rows, pl.ds(col, tw)]
            num[dd] = num[dd] + w * t
            den[dd] = den[dd] + w
        return tuple(num), tuple(den)

    zeros = tuple(jnp.zeros((th, tw), jnp.float32)
                  for _ in range(g.d_chunk))
    num, den = jax.lax.fori_loop(0, g.n_o * g.n_o, body, (zeros, zeros))
    for dd in range(g.d_chunk):
        out_ref[dd] = num[dd] / den[dd]


def asw_cost_volume(lab1, lab2, tad, prox, g, gamma_c, interpret=False):
    """(B, d_total, h_tiles, w_tiles) ASW cost of a frame stack.

    lab1, lab2 : (B, 3, Hp, Wp) padded Lab planes; tad : (B, d_total, Hp,
    Wp) truncated SAD; prox : (win, win) proximity weights; ``g`` the
    :class:`simplestereo_jax.passive.asw._Geometry` of the planes, built
    with this module's ``TILE`` and :func:`d_chunk`.
    """
    B = lab1.shape[0]
    th, tw = g.tile
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        functools.partial(_kernel, g=g),
        out_shape=jax.ShapeDtypeStruct((B, g.d_total, g.h_tiles, g.w_tiles),
                                       jnp.float32),
        grid=(B, g.n_chunks, g.h_tiles // th, g.w_tiles // tw),
        in_specs=[any_spec] * 5,
        out_specs=pl.BlockSpec((pl.squeezed, g.d_chunk, th, tw),
                               lambda b, ch, r, c: (b, ch, r, c)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="asw_cost_volume",
    )(prox, jnp.reshape(jnp.asarray(gamma_c, jnp.float32), (1,)), lab1,
      lab2, tad)
