"""Rectify a calibrated rig analytically (cf. reference examples/005:
directRectify is the default minimal-distortion method)."""

import simplestereo_jax as ss

RES = "/root/reference/examples/res/2/"
rig = ss.StereoRig.fromFile(RES + "rig.json")

rigRect = ss.rectification.directRectify(rig)
# Alternatives: ss.rectification.fusielloRectify(rig),
#               ss.rectification.loopRectify(rig),
#               ss.rectification.stereoRectify(rig)
rigRect.save("rigRect.json")
print("Saved rigRect.json")
