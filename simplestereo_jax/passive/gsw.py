"""
gsw
===

Geodesic Support-Weight matcher (Hosni et al. 2009, as approximated by the
reference).

Parity target: /root/reference/simplestereo/_passive.cpp workerGSW
:408-700 / computeGSW :703-774 and passive.py:99-158. The reference
labels this matcher "*Incomplete* ... Not optimized. Do not use in
production"; this implementation reproduces its published semantics
(device-resident, vectorized over the image) with the reference's border
quirks cleaned up:

- per-pixel support weights from the reference's iterated two-pass
  (forward/backward) window-geodesic approximation — which provably
  collapses to the direct color distance to the window center (see
  :func:`_gsw_weights`), so the weights are computed in closed form;
- matching cost = sum over the window of w * min(fMax, ||dBGR||_2),
  *unnormalized* and using left-image weights only (unlike ASW);
- tie-break toward the smallest disparity; empty candidate ranges return
  the pixel's own column; ``consistent`` mode applies the same
  left-right invalidation + occlusion fill as ASW.

The reference's mutual-information cost is an unimplemented TODO there
(_passive.cpp:506-508; "Need to implement Mutual information as matching
cost", passive.py:124-130, with the ``bins`` parameter reserved for it).
Here it IS implemented (``costMethod="mi"``): the per-pixel
(Taxonomy-of-SGM, Hirschmuller 2008 §2.1) formulation — quantize both
images to ``bins`` gray levels, build the joint histogram over currently
matched pairs, Parzen-smooth, and use
``mi(i, j) = h12(i, j) - h1(i) - h2(j)`` as the per-pixel matching cost,
iterated from the previous disparity estimate (bootstrapped from a
random disparity field, Hirschmuller 2008 §2.1). Geodesic weights
aggregate the MI cost exactly like the color cost.

The reference's weight recursion is O(H*W*win^4*iterations); the closed
form here is O(H*W*win^2) elementwise work and the cost aggregation is
O(H*W*win^2*D) — all fused XLA reduces, no sequential chains.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .asw_ref import occlusion_fill


def _color_dist(a, b):
    return jnp.sqrt(((a - b) ** 2).sum(-1))


def _parzen(h, sigma=1.0, radius=3):
    """Separable Gaussian (Parzen window) smoothing of a 1-D or 2-D
    table."""
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    if h.ndim == 1:
        return jnp.convolve(h, k, mode="same")
    smooth_rows = jax.vmap(lambda v: jnp.convolve(v, k, mode="same"))
    return smooth_rows(smooth_rows(h).T).T


@functools.partial(jax.jit, static_argnames=("bins",))
def _mi_cost_table(q1, q2, disp, valid, *, bins):
    """Per-pixel MI cost table (bins, bins) from the current matching.

    Hirschmuller 2008 §2.1: h12 = -g(log(g(P12))), h_k = -g(log(g(P_k)))
    from the marginals. The returned table C(i, j) = h12(i, j) - h1(i)
    - h2(j) = -mi(i, j) is minimized by frequently co-occurring pairs.
    """
    W = q1.shape[1]
    xs = jnp.arange(W)[None, :]
    xm = jnp.clip(xs - disp, 0, W - 1)
    q2m = jnp.take_along_axis(q2, xm, axis=1)
    ok = valid & (xs - disp >= 0) & (xs - disp <= W - 1)

    eps = 1e-7
    # Joint histogram as a one-hot matmul (hist[i, j] = #{p : q1 = i,
    # q2m = j, ok}): one dense product in place of a scatter-add, and it
    # batches under vmap. Exact in f32 (0/1 operands, integer counts).
    e1 = jax.nn.one_hot(q1.reshape(-1), bins, dtype=jnp.float32)
    e2 = jax.nn.one_hot(q2m.reshape(-1), bins, dtype=jnp.float32)
    hist = jnp.matmul((e1 * ok.reshape(-1, 1)).T, e2,
                      precision=jax.lax.Precision.HIGHEST)
    n = jnp.maximum(hist.sum(), 1.0)
    P12 = hist / n
    h12 = -_parzen(jnp.log(_parzen(P12) + eps))
    P1 = P12.sum(1)
    P2 = P12.sum(0)

    def h_marg(p):
        return -_parzen(jnp.log(_parzen(p) + eps))

    h1 = h_marg(P1)
    h2 = h_marg(P2)
    return h12 - h1[:, None] - h2[None, :]


def _window_shifts(img2d_or_3d, win_size, fill):
    """(tot, H, W[, C]) stack of the image sampled at every window offset
    (``fill`` in out-of-image positions). Static slices of one pad."""
    H, W = img2d_or_3d.shape[:2]
    pad = win_size // 2
    widths = ((pad, pad), (pad, pad)) + ((0, 0),) * (img2d_or_3d.ndim - 2)
    p = jnp.pad(img2d_or_3d.astype(jnp.float32), widths,
                constant_values=fill)
    return jnp.stack([p[i // win_size:i // win_size + H,
                        i % win_size:i % win_size + W]
                      for i in range(win_size * win_size)])


@functools.partial(jax.jit, static_argnames=("win_size", "iterations"))
def _gsw_weights(img, win_size, iterations, gamma):
    """Support weights (tot, H, W): ``exp(-||c_i - c_center||_2 / gamma)``.

    Semantically identical to the reference's iterated Gauss-Seidel
    chamfer sweep (_passive.cpp:430-491: forward pass i ascending with
    ``w[i] = min_{k<=center}(w[k] + dist(i,k))``, backward with the lower
    half, repeated ``iterations`` times) — but that recursion is
    *mathematically vacuous*: its edge relation dist(i,k) is the direct
    BGR Euclidean distance between arbitrary half-window cells, which
    satisfies the triangle inequality, so any multi-hop path
    i -> k -> ... -> center costs at least dist(i, center) and the
    minimum is always the direct hop. Measured: the full sequential sweep
    at iterations 1/2/3 agrees with this closed form to 3e-12 (ulps of
    exp), old restructured-XLA and original fori forms alike.

    The collapse removes ~44k sequential fori steps (win=11); the weight
    stack is one fused elementwise program. ``iterations`` is kept for
    API parity with the reference and has no effect — exactly as in the
    reference, where extra iterations cannot change the converged sweep
    either.
    """
    S = _window_shifts(img, win_size, jnp.inf)
    center = (win_size * win_size - 1) // 2
    d = _color_dist(S, S[center][None])
    d = jnp.where(jnp.isfinite(d), d, jnp.inf)  # out-of-image -> weight 0
    return jnp.exp(-d / gamma)


@functools.partial(
    jax.jit,
    static_argnames=("win_size", "min_disp", "max_disp", "gamma", "f_max",
                     "iterations", "normalize", "step"))
def _gsw_pass(img1, img2, *, win_size, min_disp, max_disp, gamma, f_max,
              iterations, normalize=False, step=1):
    H, W = img1.shape[:2]
    D = max_disp - min_disp + 1

    w = _gsw_weights(img1, win_size, iterations, gamma)
    if step > 1:
        # ASW's `step` mode (the subsampled scan the reference proposed,
        # passive.py:43-46): keep offsets on a step-lattice anchored at
        # the window center by zeroing the other weights.
        pad = win_size // 2
        o = np.arange(win_size * win_size)
        keep = ((o // win_size - pad) % step == 0) \
            & ((o % win_size - pad) % step == 0)
        w = w * jnp.asarray(keep, jnp.float32)[:, None, None]

    f1 = img1.astype(jnp.float32)
    f2 = img2.astype(jnp.float32)

    def capdist(d):
        """min(fMax, ||left(y,x) - right(y,x-d)||), zero where invalid."""
        sh = _shift_tgt(f2, d)
        m = jnp.minimum(_color_dist(f1, sh), f_max)
        xs = jnp.arange(W)[None, :]
        valid = ((xs - d >= 0) & (xs - d <= W - 1)).astype(jnp.float32)
        valid = jnp.broadcast_to(valid, (H, W))
        return m * valid, valid

    # Build cost volume: python loop over disparities (D small), ONE
    # stacked multiply-reduce over the tot window offsets per candidate
    # (static slices of the padded map — no sequential fori chain; XLA
    # fuses the stack/mul/sum into a single streaming pass over w).
    costs = []
    for dd in range(D):
        d = min_disp + dd
        M, V = capdist(d)
        Ms = _window_shifts(M, win_size, 0.0)          # (tot, H, W)
        c = jnp.sum(w * Ms, axis=0)
        if normalize:
            # beyond-reference: ASW-style normalization by the summed
            # weight of *valid* window pixels — window cost becomes a
            # weighted mean, removing the window-truncation bias at the
            # image borders and occlusion fringes.
            Vs = _window_shifts(V, win_size, 0.0)
            c = c / jnp.maximum(jnp.sum(w * Vs, axis=0), 1e-12)
        xs = jnp.arange(W)[None, :]
        costs.append(
            jnp.where((xs - d >= 0) & (xs - d <= W - 1), c, jnp.inf))
    cost = jnp.stack(costs, -1)
    xs = jnp.arange(W)
    disp = jnp.argmin(cost, axis=-1).astype(jnp.int32) + min_disp
    disp = jnp.where(xs[None, :] < min_disp, xs[None, :], disp)
    return disp


def _shift_tgt(a, d):
    """Target-frame column shift: out(y, x) = a(y, x - d), zero fill.

    Handles either sign and |d| >= W (candidate validity is masked by
    the callers; cv2-style matchers accept negative minDisparity)."""
    W = a.shape[1]
    pad = [(0, 0)] * a.ndim
    if d == 0:
        return a
    if d > 0:
        pad[1] = (min(d, W), 0)
        return jnp.pad(a, pad)[:, :W]
    pad[1] = (0, min(-d, W))
    return jnp.pad(a, pad)[:, min(-d, W):]


def _quantize_gray(img, bins):
    """BGR -> gray level index in [0, bins)."""
    img = img.astype(jnp.float32)
    g = (0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
         if img.ndim == 3 else img)
    return jnp.clip((g * bins / 256.0).astype(jnp.int32), 0, bins - 1)


def _mi_cost_maps(q1, q2, table, *, min_disp, max_disp, bins):
    """Per-candidate MI cost maps ``M_d(y, x) = T'[q1(y,x), q2(y,x-d)]``
    for d = min_disp..max_disp, zero where column ``x - d`` leaves the
    image; ``T' = table - min(table)`` (non-negative, so zero-padded
    out-of-image window pixels stay neutral — the SD pass's border
    semantics).

    One-hot selection form instead of per-d table gathers: ``A =
    onehot(q1) @ T'`` selects each pixel's table row (HIGHEST matmul
    precision keeps T' in f32 — a one-hot selection is then exact,
    bit-identical to the gather), and ``M_d = sum_j A[..., j] *
    shift(onehot(q2), d)[..., j]`` — the zero-filled shift of the one-hot
    stack doubles as the candidate-validity mask. The D per-candidate
    gathers of the direct form become streaming vector math that batches
    under vmap.
    """
    flat_t = table - table.min()
    e1 = jax.nn.one_hot(q1, bins, dtype=jnp.float32)       # (H, W, bins)
    A = jnp.einsum("hwb,bc->hwc", e1, flat_t,
                   precision=jax.lax.Precision.HIGHEST)
    e2 = jax.nn.one_hot(q2, bins, dtype=jnp.float32)
    return [(A * _shift_tgt(e2, min_disp + dd)).sum(-1)
            for dd in range(max_disp - min_disp + 1)]


@functools.partial(
    jax.jit,
    static_argnames=("win_size", "min_disp", "max_disp", "bins"))
def _gsw_mi_step(w, q1, q2, disp_prev, *, win_size, min_disp, max_disp,
                 bins):
    """One MI refinement: cost table from the previous matching, then
    geodesic-weighted aggregation + WTA (same scaffolding as the SD pass).
    ``w`` is the precomputed support-weight stack — it depends only on
    the reference image, so it is built once per direction, not once per
    MI iteration.
    """
    H, W = q1.shape

    table = _mi_cost_table(q1, q2, disp_prev, disp_prev >= 0, bins=bins)
    maps = _mi_cost_maps(q1, q2, table, min_disp=min_disp,
                         max_disp=max_disp, bins=bins)

    xs = jnp.arange(W)[None, :]
    costs = []
    for dd, M in enumerate(maps):
        d = min_disp + dd
        c = jnp.sum(w * _window_shifts(M, win_size, 0.0), axis=0)
        costs.append(
            jnp.where((xs - d >= 0) & (xs - d <= W - 1), c, jnp.inf))
    cost = jnp.stack(costs, -1)
    disp = jnp.argmin(cost, axis=-1).astype(jnp.int32) + min_disp
    return jnp.where(xs < min_disp, xs, disp)


#: EMD threshold (gray levels) above which ``cost_method="auto"`` picks
#: MI. Validated on Tsukuba (see the decision table in
#: :func:`gsw_disparity`): matched pairs measure <= ~2.1, the SD/MI
#: quality ranking flips between EMD 4.3 (SD 8.9% vs MI 9.6% bad-2.0)
#: and 6.3 (SD 13.1% vs MI 10.4%).
MI_AUTO_THRESHOLD = 5.0


def radiometric_divergence(img1, img2, bins=64):
    """Radiometric mismatch probe: 1-D earth-mover's distance between the
    two images' grayscale histograms, in gray levels (0-255 scale).

    Host-side and cheap (two 64-bin histograms); drives
    ``cost_method="auto"``. Rationale: a rectified stereo pair of the
    same scene has near-identical intensity *distributions* (the
    viewpoint shift barely moves the histogram), so a large histogram
    transport distance can only come from a radiometric transform
    (exposure/gain/gamma mismatch between the cameras) — exactly the
    regime where the SD cost collapses and MI wins. Measured anchors
    (Tsukuba pair; lawn = the 1280x720 res/2 pair): matched pairs score
    0.5 (Tsukuba) / 2.1 (lawn); right-image transforms score +2 gray ->
    2.4, +8 gray -> 8.3, contrast x0.85 -> 10.0, gamma 0.8 -> 15.9,
    gamma 0.5 -> 52.6. Quality consequences per level: the decision
    table in :func:`gsw_disparity`.
    """
    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    # channel-average BGR(A) inputs of ANY leading shape — (H, W, 3)
    # frames and (B, H, W, 3) batches alike. A (B, H, W) gray batch has
    # no channel axis and must NOT be averaged over W (review finding:
    # the old ndim==3 test histogrammed raw channel values for batches,
    # detaching the probe from the calibrated threshold).
    if a.ndim >= 3 and a.shape[-1] in (3, 4):
        a = a.mean(-1)
    if b.ndim >= 3 and b.shape[-1] in (3, 4):
        b = b.mean(-1)
    ha, _ = np.histogram(a, bins=bins, range=(0, 255))
    hb, _ = np.histogram(b, bins=bins, range=(0, 255))
    pa = ha / max(ha.sum(), 1)
    pb = hb / max(hb.sum(), 1)
    return float(np.abs(np.cumsum(pa - pb)).sum() * (255.0 / bins))


def resolve_cost_method(img1, img2, cost_method,
                        threshold=MI_AUTO_THRESHOLD, step=1):
    """Resolve ``cost_method="auto"`` to "sd" or "mi" via the
    radiometric-divergence probe; passes "sd"/"mi" through unchanged.

    ``step > 1`` forces "sd" for auto without probing: MI does not
    support the subsampled scan, and resolving to "mi" there would turn
    a radiometric drift into a data-dependent ValueError mid-capture —
    the exact condition auto exists to survive (an explicit
    ``cost_method="mi"`` with step > 1 still raises)."""
    if cost_method != "auto":
        return cost_method
    if step > 1:
        return "sd"
    return ("mi" if radiometric_divergence(img1, img2) > threshold
            else "sd")


def gsw_disparity(img1, img2, win_size=11, max_disp=16, min_disp=0,
                  gamma=10.0, f_max=120.0, iterations=3,
                  consistent=False, cost_method="sd", bins=20,
                  mi_iterations=2, normalize=False, step=1):
    """GSW disparity (parameters mirror the reference StereoGSW,
    passive.py:133-145).

    cost_method: "sd" — the reference's weighted capped color-difference
    cost; "mi" — per-pixel mutual-information cost (the reference's
    unimplemented TODO). MI is initialized from a *random* disparity
    field (Hirschmuller 2008 §2.1: 1/D of the pairs are then correct,
    enough signal to bootstrap the joint histogram — an SD init can lock
    in a wrong self-consistent matching under radiometric distortion)
    and refined ``mi_iterations`` times from the evolving matching.
    "auto" resolves per pair via :func:`radiometric_divergence` (EMD >
    :data:`MI_AUTO_THRESHOLD` gray levels -> MI): MI's robustness is not
    free — on matched radiometry it is both slower (a histogram build
    and several refinement passes) and worse (its cost is a histogram
    statistic, blunter than the color distance) — so pay its tax only
    when SD is actually broken. Decision table (Tsukuba,
    win=23, D=11, gamma=12.5, consistent; EMD = probe value; measured
    round 5, threshold set between the 4.3 and 6.3 rows):

    ======================= ===== ========== ========== ======
    right-image transform    EMD  SD bad-2.0 MI bad-2.0 winner
    ======================= ===== ========== ========== ======
    none                      0.5     2.4%       7.1%     SD
    +2 gray brightness        2.4     3.7%       8.0%     SD
    +4 gray brightness        4.3     8.9%       9.6%     SD
    +6 gray brightness        6.3    13.1%      10.4%     MI
    +8 gray brightness        8.3    21.9%       9.4%     MI
    contrast x0.85           10.0    38.9%      10.7%     MI
    gamma 0.8                15.9    56.0%       8.2%     MI
    gamma 0.5                52.6    62.1%       7.9%     MI
    ======================= ===== ========== ========== ======

    normalize (beyond-reference): divide each window cost by the summed
    weight of its valid pixels (ASW-style weighted mean) instead of the
    reference's raw weighted sum. Inert for "mi" (the MI cost is a table
    statistic, not a color distance).
    """
    if step < 1:
        raise ValueError("step must be >= 1!")
    # the probe is host-side numpy; device-resident inputs pay one
    # frame readback here (auto only)
    cost_method = resolve_cost_method(img1, img2, cost_method, step=step)
    if step > 1 and cost_method == "mi":
        raise ValueError("step > 1 requires cost_method='sd'!")
    if cost_method == "mi" and mi_iterations < 1:
        # 0 would return the random bootstrap field — reject instead
        raise ValueError("mi_iterations must be >= 1!")

    img1 = jnp.asarray(img1)
    img2 = jnp.asarray(img2)
    H, W = img1.shape[:2]
    xs = jnp.arange(W)
    kw = dict(win_size=win_size, min_disp=min_disp, max_disp=max_disp,
              gamma=float(gamma), f_max=float(f_max),
              iterations=iterations, normalize=normalize, step=step)

    def one_direction(a, b):
        if cost_method != "mi":
            return _gsw_pass(a, b, **kw)
        qa = _quantize_gray(a, bins)
        qb = _quantize_gray(b, bins)
        disp = jax.random.randint(
            jax.random.PRNGKey(0), (H, W), min_disp, max_disp + 1,
            dtype=jnp.int32)
        w = _gsw_weights(a, win_size, iterations, float(gamma))
        for _ in range(mi_iterations):
            disp = _gsw_mi_step(
                w, qa, qb, disp, win_size=win_size, min_disp=min_disp,
                max_disp=max_disp, bins=bins)
        return disp

    dispL = one_direction(img1, img2)
    if not consistent:
        return dispL.astype(jnp.int16)
    dispRf = one_direction(img2[:, ::-1], img1[:, ::-1])
    dispR = dispRf[:, ::-1]
    xs_f = xs[None, :]
    dispR = jnp.where((W - 1 - xs_f) < min_disp, -xs_f, dispR)
    L = jnp.clip(xs_f + dispR, 0, W - 1)
    agree = jnp.take_along_axis(dispL, L, axis=1) == dispR
    disagree = jnp.zeros((H, W), bool)
    disagree = jax.vmap(lambda f, l, a: f.at[l].max(~a))(disagree, L, agree)
    # -1 is a legal disparity when min_disp < 0: mark with min_disp - 1
    # there (same convention as the consistent ASW path).
    marker = -1 if min_disp >= 0 else min_disp - 1
    dispI = jnp.where(disagree, marker, dispL)
    return occlusion_fill(dispI, invalid=marker).astype(jnp.int16)


class StereoGSW:
    """Geodesic Support-Weight matcher (API parity: passive.py:99-158).

    Beyond the reference: ``costMethod="mi"`` activates the per-pixel
    mutual-information matching cost the reference left as a TODO
    (radiometrically robust — matches across nonlinear intensity
    transforms), ``costMethod="auto"`` picks SD/MI per pair via the
    radiometric-divergence probe (see the decision table in
    :func:`gsw_disparity`; the resolved choice of the last
    :meth:`compute`/:meth:`computeBatch` call is recorded in
    ``self.lastCostMethod``), and ``consistent=True`` adds the
    left-right check + occlusion fill the reference also listed as
    missing for GSW.

    .. note::
        Like the reference's version, this matcher is provided for
        completeness; prefer :class:`StereoASW` / :class:`StereoSGM`.
    """

    def __init__(self, winSize=11, maxDisparity=16, minDisparity=0,
                 gamma=10, fMax=120, iterations=3, bins=20,
                 consistent=False, costMethod="sd", miIterations=2,
                 normalize=False, step=1):
        if winSize <= 0 or winSize % 2 == 0:
            raise ValueError("winSize must be a positive odd number!")
        if costMethod not in ("sd", "mi", "auto"):
            raise ValueError("costMethod must be 'sd', 'mi' or 'auto'!")
        self.winSize = winSize
        self.maxDisparity = maxDisparity
        self.minDisparity = minDisparity
        self.gamma = gamma
        self.fMax = fMax
        self.iterations = iterations
        self.bins = bins  # joint-histogram bins for costMethod="mi"
        self.consistent = consistent
        self.costMethod = costMethod
        self.miIterations = miIterations
        self.normalize = normalize  # ASW-style weighted-mean cost
        self.step = step  # window-offset lattice stride (ASW-style)
        self.lastCostMethod = None  # resolved choice of the last compute

    def compute(self, img1, img2):
        img1 = np.ascontiguousarray(img1)
        img2 = np.ascontiguousarray(img2)
        if img1.ndim != 3 or img1.shape[2] != 3 or img1.shape != img2.shape:
            raise ValueError(
                "Images must be 3-channel BGR with identical shapes!")
        self.lastCostMethod = resolve_cost_method(img1, img2,
                                                  self.costMethod,
                                                  step=self.step)
        return np.asarray(gsw_disparity(
            img1, img2, win_size=self.winSize,
            max_disp=self.maxDisparity, min_disp=self.minDisparity,
            gamma=float(self.gamma), f_max=float(self.fMax),
            iterations=self.iterations, consistent=self.consistent,
            cost_method=self.lastCostMethod, bins=self.bins,
            mi_iterations=self.miIterations, normalize=self.normalize,
            step=self.step))

    def computeBatch(self, imgs1, imgs2):
        """Batched :meth:`compute`: (B, H, W, 3) stacks -> (B, H, W).

        One device program for the stack (the batch vmaps over the
        per-frame pipeline). API symmetry with StereoASW/StereoSGM
        batching; matches per-frame output.
        """
        imgs1 = np.ascontiguousarray(imgs1)
        imgs2 = np.ascontiguousarray(imgs2)
        if imgs1.ndim != 4 or imgs1.shape[3] != 3 \
                or imgs1.shape != imgs2.shape:
            raise ValueError(
                "Batches must be (B, H, W, 3) BGR with identical shapes!")
        # auto: one probe over the whole batch (a capture batch shares
        # its cameras, hence its radiometry)
        cost_method = resolve_cost_method(imgs1, imgs2, self.costMethod,
                                          step=self.step)
        self.lastCostMethod = cost_method
        fn = functools.partial(
            gsw_disparity, win_size=self.winSize,
            max_disp=self.maxDisparity, min_disp=self.minDisparity,
            gamma=float(self.gamma), f_max=float(self.fMax),
            iterations=self.iterations, consistent=self.consistent,
            cost_method=cost_method, bins=self.bins,
            mi_iterations=self.miIterations, normalize=self.normalize,
            step=self.step)
        return np.asarray(jax.vmap(fn)(jnp.asarray(imgs1),
                                       jnp.asarray(imgs2)))
