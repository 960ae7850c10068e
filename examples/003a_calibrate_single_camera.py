"""Single-camera chessboard calibration (cf. reference examples/003a)."""

import glob
import sys

import simplestereo_jax as ss

folder = sys.argv[1] if len(sys.argv) > 1 else \
    "/root/reference/examples/res/1/calib"
images = sorted(glob.glob(folder + "/*_L.png"))

rms, K, dist, rvecs, tvecs = ss.calibration.chessboardSingle(
    images, chessboardSize=(7, 6), squareSize=60.5)
print("RMS reprojection error:", rms)
print("Camera matrix:\n", K)
print("Distortion coefficients:", dist)
