"""Apply rectification maps to an image pair (cf. reference examples/006).
The warp runs on device (jitted gather remap)."""

import simplestereo_jax as ss
from simplestereo_jax.imgio import imread, imwrite

RES = "/root/reference/examples/res/2/"
rigRect = ss.RectifiedStereoRig.fromFile(RES + "rigRect.json")
img1 = imread(RES + "lawn_L.png")
img2 = imread(RES + "lawn_R.png")

r1, r2 = rigRect.rectifyImages(img1, img2)
imwrite("lawn_L_rect.png", r1)
imwrite("lawn_R_rect.png", r2)
print("Saved rectified pair")
