"""
simplestereo_jax
================

A stereo vision framework built on JAX / XLA / Pallas.

Capability-parity target: decadenza/SimpleStereo (see /root/reference), but
re-designed for accelerators:

- all dense per-pixel compute (warping, cost volumes, FFT profilometry,
  Gray-code decode, bundle-adjustment residuals) runs on device as jitted
  XLA programs or Pallas kernels;
- small 3x3 rig algebra (homography derivations, calibration bookkeeping)
  stays host-side in float64 numpy: it is control-plane work and demands
  bit-accurate double precision;
- multi-device scaling is expressed with ``jax.sharding.Mesh`` + ``shard_map``
  (frame-batch data parallelism and spatial tiling with halo exchange),
  never with host threads.

Public API mirrors the reference package (``simplestereo``) so existing
users can switch: rig classes are exported at package level, algorithms live
in ``calibration``, ``rectification``, ``passive``, ``active``,
``unwrapping``, ``points`` and ``utils`` submodules.

Reference layer map: /root/reference/simplestereo/__init__.py:11-24
"""

__version__ = "0.1.0"

from .rigs import StereoRig, RectifiedStereoRig, StructuredLightRig

from . import geometry
from . import warp
from . import rigs
from . import calibration
from . import rectification
from . import passive
from . import active
from . import unwrapping
from . import points
from . import parallel
from . import utils
from . import profiling
from . import evaluation

__all__ = [
    "StereoRig",
    "RectifiedStereoRig",
    "StructuredLightRig",
    "geometry",
    "warp",
    "rigs",
    "calibration",
    "rectification",
    "passive",
    "active",
    "unwrapping",
    "points",
    "parallel",
    "utils",
    "profiling",
    "evaluation",
]
