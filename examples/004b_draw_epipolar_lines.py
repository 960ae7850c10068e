"""Draw corresponding epipolar lines on an undistorted pair
(cf. reference examples/004b)."""

import numpy as np

import simplestereo_jax as ss
from simplestereo_jax.imgio import imread, imwrite

RES = "/root/reference/examples/res/1/"
rig = ss.StereoRig.fromFile(RES + "rig.json")
img1 = imread(RES + "left.png")
img2 = imread(RES + "right.png")
img1, img2 = rig.undistortImages(img1, img2)

F = np.asarray(rig.getFundamentalMatrix())
img1, img2 = ss.utils.drawCorrespondingEpipolarLines(
    img1, img2, F, x1=[(620, 220), (640, 370)], color=(0, 0, 255))
imwrite("left_epilines.png", img1)
imwrite("right_epilines.png", img2)
print("Saved epipolar-line pair")
