"""relativisticraytracer_tpu — a relativistic black-hole renderer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
levi2234/RelativisticRayTracer (CUDA + OpenGL):

  * per-pixel null-geodesic ray marching in a pseudo-Kerr potential
    (RK4, adaptive step size, horizon capture, escape to infinity),
  * volumetric radiative transfer through a procedural accretion disk and
    dust-cloud layer with Doppler beaming + gravitational redshift,
  * equirectangular skybox background with bilinear filtering,
  * post effects (lens distortion, chromatic aberration, bloom, vignette)
    and exponential tone mapping,
  * free-fly camera + keyframed Catmull-Rom camera paths with a fixed-step
    simulation clock,
  * frame streaming to an FFmpeg H.264 encoder (native C++ frame sink).

Design stance (see SURVEY.md §7): a frame is ONE pure jitted function
`render(scene, camera, effects, time, skybox) -> uint8[H, W, 4]`. Vectors
are structure-of-arrays (separate x/y/z planes, never a minor dim of 3).
On an NVIDIA GPU the march runs as one Pallas kernel on the Triton route
with per-block early exit and block-divergent media shading
(ops/pallas_march.py); elsewhere it is a `lax.while_loop` with per-ray
active masks replacing CUDA thread divergence, the plain reference path.
Multi-card scaling is pure output-partitioned image tiling over a
`jax.sharding.Mesh` (zero collectives per frame).
"""

from relativisticraytracer_tpu.config import (
    SceneConfig,
    CameraEffects,
    RenderSettings,
    DEFAULT_SCENE,
)
from relativisticraytracer_tpu.render.camera import CameraState, camera_state_from_pose
from relativisticraytracer_tpu.render.pipeline import Renderer, render_frame
from relativisticraytracer_tpu.paths import (
    Keyframe,
    CameraPath,
    PathManager,
    PathController,
    CameraController,
    catmull_rom,
    lerp_angle,
    init_default_paths,
)

__version__ = "0.1.0"

__all__ = [
    "SceneConfig",
    "CameraEffects",
    "RenderSettings",
    "DEFAULT_SCENE",
    "CameraState",
    "camera_state_from_pose",
    "Renderer",
    "render_frame",
    "Keyframe",
    "CameraPath",
    "PathManager",
    "PathController",
    "CameraController",
    "catmull_rom",
    "lerp_angle",
    "init_default_paths",
]
