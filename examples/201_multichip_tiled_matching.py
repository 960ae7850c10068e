"""Extra: shard dense matching over a device mesh with halo
exchange (no reference equivalent — the reference's only parallelism is a
CPU thread pool)."""

import numpy as np

import simplestereo_jax as ss
from simplestereo_jax import parallel
from simplestereo_jax.imgio import imread

RES = "/root/reference/examples/res/tsukuba/"
img1 = imread(RES + "tsukuba_l.png")
img2 = imread(RES + "tsukuba_r.png")

import jax
n = len(jax.devices())
mesh = parallel.make_mesh({"rows": n})
H = img1.shape[0] - img1.shape[0] % n
disp = parallel.tiled_asw_disparity(
    img1[:H], img2[:H], mesh, win_size=35, min_disp=4, max_disp=14,
    gamma_c=15, gamma_p=17.5, consistent=True)
print("Tiled disparity:", np.asarray(disp).shape)

# The whole matcher family tiles over the mesh.
disp_sgm = parallel.tiled_sgm_disparity(
    img1[:H], img2[:H], mesh, num_disp=16, cost_method="census",
    census_window=7, P1=120, P2=480, uniqueness=0)
print("Tiled SGM disparity:", np.asarray(disp_sgm).shape)

disp_gsw = parallel.tiled_gsw_disparity(
    img1[:H], img2[:H], mesh, win_size=11, max_disp=14, min_disp=4,
    gamma=12.5, f_max=20.0, consistent=True)
print("Tiled GSW disparity:", np.asarray(disp_gsw).shape)
