"""Public API surface parity with the reference package.

Every public symbol of /root/reference/simplestereo (classes, functions,
methods, rig properties — see SURVEY.md §2.1) must exist on
simplestereo_jax so a reference user can switch without code changes.
The reference tree itself is not needed: the expected surface is pinned
here from the survey.
"""

import pytest

import simplestereo_jax as ss

MODULE_SYMBOLS = {
    "": ["StereoRig", "RectifiedStereoRig", "StructuredLightRig"],
    "active": ["GrayCode", "GrayCodeDouble", "GrayCodeSingle", "StereoFTP",
               "StereoFTPAnaglyph", "StereoFTP_Mapping",
               "StereoFTP_PhaseOnly", "buildAnaglyphFringe",
               "buildBinaryFringe", "buildFringe", "computeROI",
               "findCentralStripe", "generateGrayCodeImgs"],
    "calibration": ["chessboardProCam", "chessboardProCamWhite",
                    "chessboardSingle", "chessboardStereo",
                    "generateChessboardSVG",
                    "getFundamentalMatrixFromProjections", "phaseShift",
                    "phaseShiftWhite"],
    "passive": ["StereoASW", "StereoGSW"],
    "points": ["distortPoints", "exportPLY", "getAdimensional3DPoints",
               "importPLY"],
    "rectification": ["directRectify", "fusielloRectify",
                      "getBestXShearingTransformation", "getFittingMatrix",
                      "loopRectify", "stereoRectify"],
    "unwrapping": ["infiniteImpulseResponse"],
    "utils": ["Capture", "drawCorrespondingEpipolarLines",
              "getCrossProductMatrix", "moveExtrinsicOriginToFirstCamera"],
}

METHODS = {
    "StereoRig": ["fromFile", "save", "getBaseline", "getCenters",
                  "getEssentialMatrix", "getFundamentalMatrix",
                  "getProjectionMatrices", "undistortImages",
                  # property surface (reference _rigs.py:22-338)
                  "E", "F", "R", "T", "distCoeffs1", "distCoeffs2",
                  "intrinsic1", "intrinsic2"],
    "RectifiedStereoRig": ["computeRectificationMaps", "fromFile",
                           "get3DPoints", "getRectifiedProjectionMatrices",
                           "rectifyImages", "save", "Rcommon",
                           "rectHomography1", "rectHomography2"],
    "StructuredLightRig": ["fromFile", "triangulate",
                           "undistortCameraImage"],
}


@pytest.mark.parametrize("mod", sorted(MODULE_SYMBOLS))
def test_module_symbols(mod):
    target = ss if not mod else getattr(ss, mod)
    missing = [n for n in MODULE_SYMBOLS[mod] if not hasattr(target, n)]
    assert not missing, f"{mod or 'top-level'}: missing {missing}"


@pytest.mark.parametrize("cls", sorted(METHODS))
def test_class_surface(cls):
    c = getattr(ss, cls)
    missing = [m for m in METHODS[cls] if not hasattr(c, m)]
    assert not missing, f"{cls}: missing {missing}"


def test_method_surfaces():
    assert hasattr(ss.utils.Capture, "get")
    for m in ("getResolution", "setFrameRate", "setResolution", "start",
              "stop"):
        assert hasattr(ss.utils.Capture, m), m
    assert hasattr(ss.active.StereoFTP, "convertGrayscale")
    assert hasattr(ss.active.StereoFTP, "getCloud")
    assert hasattr(ss.active.StereoFTP_PhaseOnly, "getPhase")
    for m in ("compute", "computeBatch"):
        assert hasattr(ss.passive.StereoASW, m), m
    assert hasattr(ss.passive.StereoGSW, "compute")
