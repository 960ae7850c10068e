"""Undistort a stereo pair with the calibrated rig
(cf. reference examples/004a)."""

import simplestereo_jax as ss
from simplestereo_jax.imgio import imread, imwrite

RES = "/root/reference/examples/res/1/"
rig = ss.StereoRig.fromFile(RES + "rig.json")
img1 = imread(RES + "left.png")
img2 = imread(RES + "right.png")

u1, u2 = rig.undistortImages(img1, img2)
imwrite("left_undist.png", u1)
imwrite("right_undist.png", u2)
print("Saved undistorted pair")
