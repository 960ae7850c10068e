"""
sharded
=======

Device-resident, multi-chip bundle adjustment for large view counts.

The host-f64 LM in :mod:`.ba` is right for the reference's problem sizes
(tens of views). This module is the scale path promised by the framework
design (SURVEY.md §2.3/§5): views are sharded over a mesh axis, per-view
Gauss-Newton blocks are built with ``jax.jacfwd`` on device, and the
intrinsic normal equations are reduced across the mesh with ``psum`` —
the classic Schur-complement distribution:

    J_i = [A_i | B_i]   (A: d r_i / d intrinsics, B: d r_i / d pose_i)
    S   = sum_i A_i^T A_i - A_i^T B_i (B_i^T B_i)^-1 B_i^T A_i   (psum)
    g   = sum_i A_i^T r_i - A_i^T B_i (B_i^T B_i)^-1 B_i^T r_i   (psum)
    d_theta = -S^-1 g  (replicated);  d_pose_i local back-substitution.

Pose blocks never leave their shard; only the small (4+nd)^2 intrinsic
system crosses the ICI.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..geometry.rotations import rodrigues_to_matrix
from ..geometry.distortion import distort_normalized


def _project(obj, pose, intr, nd):
    """(N,3) obj -> (N,2) pixels; pose (6,), intr (4+nd,)."""
    R = rodrigues_to_matrix(pose[:3])
    p = obj @ R.T + pose[3:][None, :]
    xy = p[:, :2] / p[:, 2:3]
    dist = jnp.zeros(14, intr.dtype).at[:nd].set(intr[4:4 + nd])
    xyd = distort_normalized(xy, dist)
    u = intr[0] * xyd[:, 0] + intr[2]
    v = intr[1] * xyd[:, 1] + intr[3]
    return jnp.stack([u, v], 1)


def _residual(obj, img, pose, intr, nd):
    return (_project(obj, pose, intr, nd) - img).reshape(-1)


def calibrate_camera_sharded(object_points, image_points, K_init,
                             dist_init, mesh, axis="views", iterations=20,
                             damping=1e-3):
    """Distributed Gauss-Newton camera calibration.

    object_points : (V, N, 3), image_points : (V, N, 2) — V divisible by
    the mesh axis size. K_init (3,3), dist_init (nd,) start values (use
    the host Zhang init on a subsample of views).

    Returns (rms, K, dist, poses (V, 6)).
    """
    obj = jnp.asarray(object_points, jnp.float32)
    img = jnp.asarray(image_points, jnp.float32)
    V = obj.shape[0]
    n_axis = mesh.shape[axis]
    if V % n_axis:
        raise ValueError(f"views {V} not divisible by mesh axis {n_axis}")
    nd = len(np.ravel(dist_init))
    n_intr = 4 + nd

    K_init = np.asarray(K_init, np.float64)
    intr0 = jnp.asarray(np.concatenate([
        [K_init[0, 0], K_init[1, 1], K_init[0, 2], K_init[1, 2]],
        np.ravel(dist_init)]), jnp.float32)

    # per-view pose init on host (cheap, V homography DLTs)
    from . import ba
    poses0 = []
    for o, i in zip(np.asarray(obj), np.asarray(img)):
        H = ba._homography_dlt(o[:, :2], i)
        r, t = ba._extrinsics_from_h(H, K_init)
        poses0.append(np.concatenate([r, t]))
    poses0 = jnp.asarray(np.stack(poses0), jnp.float32)

    spec = P(axis)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(spec, spec, spec, P()), out_specs=(spec, P()),
        check_vma=False)
    def gn_steps(obj_l, img_l, poses_l, intr):
        def one_view_blocks(intr, o, i, pose):
            r = _residual(o, i, pose, intr, nd)
            A = jax.jacfwd(lambda th: _residual(o, i, pose, th, nd))(intr)
            B = jax.jacfwd(lambda p: _residual(o, i, p, intr, nd))(pose)
            BtB = B.T @ B + damping * jnp.eye(6, dtype=B.dtype)
            BtB_inv = jnp.linalg.inv(BtB)
            AtB = A.T @ B
            S = A.T @ A - AtB @ BtB_inv @ AtB.T
            g = A.T @ r - AtB @ (BtB_inv @ (B.T @ r))
            return S, g, B, BtB_inv, r

        def step(carry, _):
            poses_l, intr = carry
            S, g, B, BtB_inv, r = jax.vmap(
                lambda o, i, p: one_view_blocks(intr, o, i, p))(
                    obj_l, img_l, poses_l)
            S_tot = jax.lax.psum(S.sum(0), axis) \
                + damping * jnp.eye(n_intr, dtype=S.dtype)
            g_tot = jax.lax.psum(g.sum(0), axis)
            d_intr = -jnp.linalg.solve(S_tot, g_tot)
            # back-substitute poses locally
            def back(o, i, p, Bv, BtBi, rv):
                Av = jax.jacfwd(
                    lambda th: _residual(o, i, p, th, nd))(intr)
                rhs = Bv.T @ rv + (Av @ d_intr) @ Bv
                return p - BtBi @ rhs
            poses_l = jax.vmap(back)(obj_l, img_l, poses_l, B, BtB_inv, r)
            intr = intr + d_intr
            cost = jax.lax.psum(jax.vmap(
                lambda o, i, p: (_residual(o, i, p, intr, nd) ** 2).sum())(
                    obj_l, img_l, poses_l).sum(), axis)
            return (poses_l, intr), cost

        (poses_l, intr), costs = jax.lax.scan(
            step, (poses_l, intr), None, length=iterations)
        return poses_l, (intr, costs)

    sh = NamedSharding(mesh, spec)
    multi = jax.process_count() > 1
    # Multi-process meshes: device_put shards host values to every
    # process's addressable devices (the host init is deterministic, so
    # all processes hold identical numpy inputs).
    obj_s = jax.device_put(np.asarray(obj) if multi else obj, sh)
    img_s = jax.device_put(np.asarray(img) if multi else img, sh)
    poses_s = jax.device_put(np.asarray(poses0) if multi else poses0, sh)
    intr_in = np.asarray(intr0) if multi else intr0
    # full-f32 normal equations (a GPU may otherwise run them in TF32)
    with jax.default_matmul_precision("highest"):
        poses, (intr, costs) = jax.jit(gn_steps)(obj_s, img_s, poses_s,
                                                 intr_in)
    if multi:
        # pose blocks of other processes' views are not addressable here
        from jax.experimental import multihost_utils
        poses = multihost_utils.process_allgather(poses, tiled=True)

    intr = np.asarray(intr, np.float64)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]])
    n_pts = obj.shape[0] * obj.shape[1]
    rms = float(np.sqrt(np.asarray(costs)[-1] / n_pts))
    return rms, K, intr[4:], np.asarray(poses)
