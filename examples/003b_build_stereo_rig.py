"""Stereo chessboard calibration -> rig.json (cf. reference examples/003b)."""

import glob
import sys

import simplestereo_jax as ss

folder = sys.argv[1] if len(sys.argv) > 1 else \
    "/root/reference/examples/res/1/calib"
lefts = sorted(glob.glob(folder + "/*_L.png"))
rights = sorted(glob.glob(folder + "/*_R.png"))

rig = ss.calibration.chessboardStereo(
    list(zip(lefts, rights)), chessboardSize=(7, 6), squareSize=60.5)
print("Reprojection error:", rig.reprojectionError)
rig.save("rig.json")
print("Saved rig.json")
