"""Triangulate known camera-projector correspondences with a
StructuredLightRig (cf. reference examples/101)."""

import numpy as np

import simplestereo_jax as ss

RES = "/root/reference/examples/res/stereoFTP/"
rig = ss.StructuredLightRig.fromFile(RES + "stereoRig.json")

camPoints = np.array([[320.5, 240.5], [400.0, 300.0]])
projPoints = np.array([[640.0, 360.0], [700.0, 420.0]])
world = rig.triangulate(camPoints, projPoints)
print("Triangulated points:\n", world.reshape(-1, 3))
