"""
asw
===

Adaptive Support-Weight matcher: the public entry points, the plain XLA
form of the cost volume, and the one place that chooses between that
form and the GPU kernel (:mod:`.asw_pallas`).

Semantics are those of :func:`simplestereo_jax.passive.asw_ref.asw_disparity_ref`
(the reference's workerASW / workerASWconsistent, _passive.cpp:16-289).
The pipeline is split in three:

- **Planes** (:func:`_build_planes`): sentinel-padded Lab planes of both
  images and the truncated-SAD volume ``tad[d](y, x) = min(40,
  SAD(ref(y, x), tgt(y, x - d)))``, all on one padded grid. Out-of-image
  Lab samples carry a large sentinel, so the support weight
  ``exp(-||dLab|| / gammaC)`` of any window pixel that leaves the image
  underflows to exactly 0 — the reference's validity tests, branch-free.
- **Cost volume** ``cost[d, y, x] = sum(w * tad) / sum(w)`` over the
  window. :func:`_cost_volume_xla` walks the window offsets with
  ``lax.fori_loop`` in the oracle's order (rows outer, columns inner);
  :func:`simplestereo_jax.passive.asw_pallas.asw_cost_volume` is the
  fused GPU kernel that keeps the per-disparity sums in registers.
  :func:`_engine` picks one from the platform.
- **Post** (:func:`_finish`): winner-take-all, the empty-range rule, the
  left-right check and occlusion fill, and the optional sub-pixel fit.

Consistent mode costs no second pass: the ASW cost is symmetric in the
image pair, ``cost_R(x, d) = cost_L(x + d, d)`` bit for bit (the weight
product and the truncated SAD are the same terms, summed in the same
order), so the right-reference map is a per-disparity column shift of the
left volume.
"""

import functools

import jax
import jax.numpy as jnp

from .asw_ref import occlusion_fill
from .lab import bgr_to_lab

TAD_CAP = 40.0
LAB_SENTINEL = 1.0e6  # exp(-sentinel / gammaC) underflows to exactly 0.0


def _engine(interpret=False):
    """Cost-volume builder for the default platform: the Pallas kernel on
    ``gpu``, the XLA form on ``cpu``. ``interpret`` asks for the kernel
    in the Pallas interpreter on any platform (how the tests run it)."""
    if interpret:
        return "interpret"
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"ASW has no implementation for platform {platform!r}")


class _Geometry:
    """Padded-grid layout shared by the planes and both cost builders.

    Output pixel (y, x) sits at padded row ``y + pad`` and padded column
    ``x + left``. Row/column extents are rounded up to whole tiles of
    ``tile`` (the kernel's block shape; (1, 1) for the XLA form), and the
    disparity count to whole chunks of ``d_chunk`` candidates.
    """

    def __init__(self, h_out, W, win_size, min_disp, max_disp, step,
                 tile=(1, 1), d_chunk=None):
        self.h_out, self.W = h_out, W
        self.win, self.pad, self.step = win_size, win_size // 2, step
        self.min_disp, self.max_disp = min_disp, max_disp
        self.D = max_disp - min_disp + 1
        self.d_chunk = self.D if d_chunk is None else d_chunk
        self.n_chunks = -(-self.D // self.d_chunk)
        self.d_total = self.n_chunks * self.d_chunk
        self.tile = tile
        self.h_tiles = -(-h_out // tile[0]) * tile[0]
        self.w_tiles = -(-W // tile[1]) * tile[1]
        d_hi = min_disp + self.d_total - 1
        self.left = self.pad + max(d_hi, 0)
        self.Hp = self.h_tiles + 2 * self.pad
        self.Wp = self.left + self.w_tiles + self.pad + max(-min_disp, 0)
        # Window-offset lattice: every offset at step 1 (the reference's
        # semantics), else offsets o with o % step == 0 about the center
        # (the subsampled scan the reference suggested, passive.py:43-46).
        self.o0 = self.pad % step
        self.n_o = len(range(self.o0, win_size, step))


def _prox_table(win_size, gamma_p):
    """(win, win) proximity weights exp(-2 * sqrt(di^2 + dj^2) / gammaP)."""
    offs = jnp.arange(win_size, dtype=jnp.float32) - win_size // 2
    dist = jnp.sqrt(offs[:, None] ** 2 + offs[None, :] ** 2)
    return jnp.exp(-2.0 * dist / gamma_p)


def _build_planes(img1, img2, g, row_valid=None, context=False):
    """Padded planes of one pair on the grid of :class:`_Geometry` ``g``.

    Returns ``lab1``, ``lab2`` (3, Hp, Wp) sentinel-padded Lab and ``tad``
    (d_total, Hp, Wp), the truncated SAD of each candidate on the
    reference grid.

    row_valid : optional (H,) bool — rows marked False are treated exactly
        like out-of-image rows. Used by :mod:`simplestereo_jax.parallel`
        so that halo rows received at the *global* image boundary of a
        sharded run keep single-device semantics.
    context : bool — the input's first and last ``win_size // 2`` rows are
        window sources only (see :func:`asw_disparity`).
    """
    H, W = img1.shape[:2]
    top = 0 if context else g.pad

    def pack(arr, fill):
        a = jnp.transpose(arr, (2, 0, 1))
        if row_valid is not None:
            a = jnp.where(row_valid[None, :, None], a, fill)
        return jnp.pad(a, ((0, 0), (top, g.Hp - H - top),
                           (g.left, g.Wp - W - g.left)),
                       constant_values=fill)

    lab1 = pack(bgr_to_lab(img1), LAB_SENTINEL)
    lab2 = pack(bgr_to_lab(img2), LAB_SENTINEL)
    bgr1 = pack(img1.astype(jnp.float32), 0.0)
    bgr2 = pack(img2.astype(jnp.float32), 0.0)

    def tad_for(d):
        # bgr2 column c - d under reference column c, zero where it leaves
        # the grid (those window pixels carry weight 0).
        s = min(abs(d), g.Wp)
        if d >= 0:
            sh = jnp.pad(bgr2, ((0, 0), (0, 0), (s, 0)))[..., :g.Wp]
        else:
            sh = jnp.pad(bgr2, ((0, 0), (0, 0), (0, s)))[..., s:]
        return jnp.minimum(jnp.abs(bgr1 - sh).sum(0), TAD_CAP)

    tad = jnp.stack([tad_for(g.min_disp + dd) for dd in range(g.d_total)])
    return lab1, lab2, tad


def _lab_dist(win, ctr):
    """||win - ctr||_2 over the leading Lab axis."""
    dsq = (win[0] - ctr[0]) ** 2 + (win[1] - ctr[1]) ** 2
    return jnp.sqrt(dsq + (win[2] - ctr[2]) ** 2)


def _cost_volume_xla(lab1, lab2, tad, prox, g, gamma_c):
    """(D, h_out, W) ASW cost of one frame: a ``fori_loop`` over window
    offsets that accumulates the weighted sums of every candidate on the
    padded planes (the XLA form of the fused kernel)."""
    H, W, D, pad = g.h_out, g.W, g.D, g.pad
    wide = W + D - 1
    # target centers x - d of every candidate as one strip: strip column
    # k holds image column k - max_disp
    ctr1 = lab1[:, pad:pad + H, g.left:g.left + W]
    c2 = g.left - g.max_disp
    ctr2 = lab2[:, pad:pad + H, c2:c2 + wide]

    def body(m, carry):
        num, den = carry
        i = g.o0 + jax.lax.div(m, g.n_o) * g.step
        j = g.o0 + jax.lax.rem(m, g.n_o) * g.step
        col = g.left - pad + j
        dl1 = _lab_dist(jax.lax.dynamic_slice(lab1, (0, i, col), (3, H, W)),
                        ctr1)
        dl2 = _lab_dist(jax.lax.dynamic_slice(
            lab2, (0, i, col - g.max_disp), (3, H, wide)), ctr2)
        dl2 = jnp.stack([dl2[:, D - 1 - dd:D - 1 - dd + W]
                         for dd in range(D)])
        w = prox[i, j] * jnp.exp(-(dl1[None] + dl2) / gamma_c)
        t = jax.lax.dynamic_slice(tad, (0, i, col), (D, H, W))
        return num + w * t, den + w

    zeros = jnp.zeros((D, H, W), jnp.float32)
    num, den = jax.lax.fori_loop(0, g.n_o * g.n_o, body, (zeros, zeros))
    return num / den


def _finish(cost, *, min_disp, max_disp, consistent, subpixel):
    """Post passes on one frame's (D, H, W) cost volume: WTA with the
    smallest-d tie-break, the empty-range rule, the LR check
    (_passive.cpp:191-253), occlusion fill (_passive.cpp:258-285) and the
    optional equiangular sub-pixel refinement."""
    D, H, W = cost.shape
    xs = jnp.arange(W)
    d = jnp.arange(D)[:, None, None] + min_disp
    # a candidate needs its target center x - d inside the image
    costL = jnp.where((xs >= d) & (xs - d <= W - 1), cost, jnp.inf)
    best = jnp.argmin(costL, axis=0).astype(jnp.int32)
    raw = best + min_disp
    # Empty candidate range (x < min_disp): the reference outputs the
    # pixel's own column index (dBest stays 0 -> disparity x - 0).
    dispL = jnp.where(xs[None, :] < min_disp, xs[None, :], raw)

    if consistent:
        # cost_R(x, d) = cost_L(x + d, d), its center x + d in the image
        cols = jnp.clip(xs[None, None, :] + d, 0, W - 1)
        costR = jnp.take_along_axis(cost, jnp.broadcast_to(cols, cost.shape),
                                    axis=2)
        costR = jnp.where((xs + d >= 0) & (xs + d <= W - 1), costR, jnp.inf)
        dispR = jnp.argmin(costR, axis=0).astype(jnp.int32) + min_disp
        # Empty range on the right pass: dBest stays 0 there too, which
        # in right-image coordinates means matched left col 0, disp -x.
        xs_f = xs[None, :]
        dispR = jnp.where((W - 1 - xs_f) < min_disp, -xs_f, dispR)

        # Invalidate left pixels whose right-pass match disagrees; fill.
        # The reference's -1 marker collides with legal disparities when
        # min_disp < 0, so the marker becomes min_disp - 1 there (matches
        # the oracle; reference semantics assume minDisparity >= 0).
        marker = -1 if min_disp >= 0 else min_disp - 1
        L = jnp.clip(xs_f + dispR, 0, W - 1)
        agree = jnp.take_along_axis(dispL, L, axis=1) == dispR
        disagree = jnp.zeros((H, W), bool)
        disagree = jax.vmap(lambda f, l, a: f.at[l].max(~a))(
            disagree, L, agree)
        dispI = jnp.where(disagree, marker, dispL)
        out_i = occlusion_fill(dispI, invalid=marker).astype(jnp.int16)
    else:
        out_i = dispL.astype(jnp.int16)

    if not subpixel:
        return out_i

    # Equiangular (V-shaped) fit through the winner's cost neighborhood —
    # the sub-pixel model for SAD-class costs, whose profile is piecewise
    # LINEAR in d near the minimum (a parabola fit biases fractional
    # shifts toward integers). Only pixels whose final value still equals
    # the WTA winner are refined (consistency fills and empty-range
    # substitutions stay integer).
    def at(k):
        k = jnp.clip(k, 0, D - 1)
        return jnp.take_along_axis(costL, k[None], axis=0)[0]

    cm, c0, cp = at(best - 1), jnp.min(costL, axis=0), at(best + 1)
    interior = (raw > min_disp) & (raw < max_disp)
    finite = jnp.isfinite(cm) & jnp.isfinite(cp) & jnp.isfinite(c0)
    denom = jnp.maximum(cm, cp) - c0
    delta = jnp.where(interior & finite & (denom > 1e-6),
                      (cm - cp) / (2.0 * denom), 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    # The invalid marker is strictly below every legal WTA winner, so
    # marker pixels never satisfy out_i == raw and stay exactly integer.
    refine = out_i == raw
    return out_i.astype(jnp.float32) + jnp.where(refine, delta, 0.0)


@functools.partial(
    jax.jit,
    static_argnames=("win_size", "max_disp", "min_disp", "engine", "step",
                     "context"))
def _cost_jit(imgs1, imgs2, row_valid, gamma_c, gamma_p, *, win_size,
              max_disp, min_disp, engine, step, context):
    """(B, H, W, 3) pairs -> (B, D, h_out, W) ASW cost volumes from the
    builder ``engine`` ("pallas", "interpret" or "xla", see
    :func:`_engine`)."""
    B, H, W = imgs1.shape[:3]
    h_out = H - 2 * (win_size // 2) if context else H
    prox = _prox_table(win_size, gamma_p)
    if engine == "xla":
        g = _Geometry(h_out, W, win_size, min_disp, max_disp, step)
    else:
        from . import asw_pallas
        g = _Geometry(h_out, W, win_size, min_disp, max_disp, step,
                      tile=asw_pallas.TILE, d_chunk=asw_pallas.d_chunk(
                          max_disp - min_disp + 1))

    def planes(a, b, rv):
        return _build_planes(a, b, g, rv, context=context)

    if row_valid is None:
        lab1, lab2, tad = jax.vmap(lambda a, b: planes(a, b, None))(
            imgs1, imgs2)
    else:
        lab1, lab2, tad = jax.vmap(planes)(imgs1, imgs2, row_valid)

    if engine == "xla":
        return jax.vmap(
            lambda a, b, t: _cost_volume_xla(a, b, t, prox, g, gamma_c))(
                lab1, lab2, tad)
    return asw_pallas.asw_cost_volume(
        lab1, lab2, tad, prox, g, gamma_c,
        interpret=engine == "interpret")[:, :g.D, :h_out, :W]


@functools.partial(
    jax.jit,
    static_argnames=("win_size", "max_disp", "min_disp", "consistent",
                     "engine", "step", "subpixel", "context"))
def _asw_disparity_jit(imgs1, imgs2, row_valid, gamma_c, gamma_p, *,
                       win_size, max_disp, min_disp, consistent, engine,
                       step, subpixel, context):
    """(B, H, W, 3) pairs -> (B, h_out, W) disparity as one device
    program: planes, cost volume, post passes."""
    cost = _cost_jit(imgs1, imgs2, row_valid, gamma_c, gamma_p,
                     win_size=win_size, max_disp=max_disp,
                     min_disp=min_disp, engine=engine, step=step,
                     context=context)
    post = functools.partial(_finish, min_disp=min_disp, max_disp=max_disp,
                             consistent=consistent, subpixel=subpixel)
    return jax.vmap(post)(cost)


def asw_disparity_batch(imgs1, imgs2, win_size=35, max_disp=16, min_disp=0,
                        gamma_c=5.0, gamma_p=17.5, consistent=False,
                        row_valid=None, step=1, subpixel=False,
                        context=False, interpret=False):
    """Batched :func:`asw_disparity`: (B, H, W, 3) pairs -> (B, H, W)
    int16 (float32 when ``subpixel``), one device program for the stack
    (on the GPU the frame axis is a grid axis of one kernel launch).
    Bit-identical to per-frame :func:`asw_disparity`.

    row_valid : optional (B, H) bool — per-frame row validity (used by the
        sharded row-tiling path in :mod:`simplestereo_jax.parallel`).
    context : bool — first/last ``win_size // 2`` rows are window sources
        only (see :func:`asw_disparity`).
    interpret : bool — run the GPU kernel in the Pallas interpreter
        (tests on machines without a GPU).
    """
    return _asw_disparity_jit(
        jnp.asarray(imgs1), jnp.asarray(imgs2), row_valid,
        jnp.float32(gamma_c), jnp.float32(gamma_p), win_size=int(win_size),
        max_disp=int(max_disp), min_disp=int(min_disp),
        consistent=bool(consistent),
        engine=_engine(interpret), step=int(step), subpixel=bool(subpixel),
        context=bool(context))


def asw_disparity(img1, img2, win_size=35, max_disp=16, min_disp=0,
                  gamma_c=5.0, gamma_p=17.5, consistent=False,
                  row_valid=None, step=1, subpixel=False, context=False,
                  interpret=False):
    """ASW disparity map of one rectified BGR pair.

    Parameters mirror the reference ``StereoASW``
    (reference simplestereo/passive.py:59-69); semantics are
    validated against
    :func:`simplestereo_jax.passive.asw_ref.asw_disparity_ref`.

    subpixel : bool
        Equiangular sub-pixel refinement of the winner from its cost
        neighborhood (a capability beyond the reference's integer-only
        ASW; the V-shaped fit matches the SAD-class cost profile).
        Returns float32 then.
    context : bool
        The input's first and last ``win_size // 2`` rows are window
        *sources* only — no disparity is computed for them, and the
        output has ``H - 2 * (win_size // 2)`` rows. Used by the sharded
        row-tiling path (:mod:`simplestereo_jax.parallel`): the exchanged
        halo rows feed the boundary windows without the shard recomputing
        (and discarding) their disparities.
    row_valid : optional (H,) bool — rows treated as outside the image.
    interpret : bool — run the GPU kernel in the Pallas interpreter.

    Returns
    -------
    jnp.ndarray
        (H, W) int16 disparity (consistent mode fills occlusions like the
        reference). float32 when ``subpixel``.
    """
    rv = None if row_valid is None else jnp.asarray(row_valid)[None]
    return asw_disparity_batch(
        jnp.asarray(img1)[None], jnp.asarray(img2)[None], win_size=win_size,
        max_disp=max_disp, min_disp=min_disp, gamma_c=gamma_c,
        gamma_p=gamma_p, consistent=consistent, row_valid=rv, step=step,
        subpixel=subpixel, context=context, interpret=interpret)[0]
