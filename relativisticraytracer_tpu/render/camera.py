"""Camera state + primary-ray generation.

`CameraState` is the host->device camera ABI (reference: raymarcher.h:11-16):
position plus an orthonormal (forward, right, up) basis. Basis construction
from (pos, yaw, pitch) matches `CameraController::getCUDAStateFrom`
(reference: src/main.cpp:141-167): forward from spherical angles,
right = worldUp x forward, up = forward x right.

Ray generation matches the reference kernel prologue
(reference: src/raymarcher.cu:20-34): uv at pixel CORNERS (x/width, y/height
— not centers), optional barrel-distortion pre-warp of uv, NDC mapping with
aspect on u only, and rd = normalize(forward + u*right + v*up).

Orientation note: the reference writes pixel (x, y) to buffer row
(height-1-y) (raymarcher.cu:168), displays with GL's bottom-left texture
origin, and records through FFmpeg `-vf vflip` (main.cpp:67). Those three
flips cancel: the final on-screen/encoded image row j (top-down) is exactly
kernel row y = j. We therefore generate rays directly in top-down row order
with NO flip anywhere else in the pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from relativisticraytracer_tpu.config import CameraEffects
from relativisticraytracer_tpu.core.vecmath import Vec3, normalize
from relativisticraytracer_tpu.render.postfx import apply_lens_distortion

_DEG2RAD = 3.14159 / 180.0  # reference uses 3.14159f here (main.cpp:142-143)


@dataclasses.dataclass
class CameraState:
    """pos/forward/right/up as float32[3] arrays (a JAX pytree)."""

    pos: jnp.ndarray
    forward: jnp.ndarray
    right: jnp.ndarray
    up: jnp.ndarray

    def replace(self, **kw) -> "CameraState":
        return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    CameraState, data_fields=["pos", "forward", "right", "up"], meta_fields=[]
)


def camera_state_from_pose(pos, yaw: float, pitch: float) -> CameraState:
    """Build the orthonormal camera basis from a fly-camera pose
    (reference: src/main.cpp:141-167). Host-side float32 math.

    yaw/pitch in degrees; forward = (sin(yaw)cos(pitch), sin(pitch),
    cos(yaw)cos(pitch)); right = worldUp x forward; up = forward x right.
    """
    f32 = np.float32
    yaw_r = f32(yaw) * f32(_DEG2RAD)
    pitch_r = f32(pitch) * f32(_DEG2RAD)

    fwd = np.array(
        [
            math.sin(yaw_r) * math.cos(pitch_r),
            math.sin(pitch_r),
            math.cos(yaw_r) * math.cos(pitch_r),
        ],
        dtype=np.float32,
    )
    fwd = fwd / f32(np.sqrt(np.sum(fwd * fwd, dtype=np.float32)))

    world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    right = np.cross(world_up, fwd).astype(np.float32)
    right = right / f32(np.sqrt(np.sum(right * right, dtype=np.float32)))
    up = np.cross(fwd, right).astype(np.float32)

    return CameraState(
        pos=jnp.asarray(np.asarray(pos, dtype=np.float32)),
        forward=jnp.asarray(fwd),
        right=jnp.asarray(right),
        up=jnp.asarray(up),
    )


def default_camera() -> CameraState:
    """Reference startup pose: pos (0, 10, -60), yaw 0, pitch -10
    (reference: src/main.cpp:128-130)."""
    return camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)


def primary_rays(px, py, width: int, height: int, forward, right, up,
                 use_lens_distortion, distortion_amount):
    """Directions and (possibly lens-distorted) uv for pixel coordinates
    (px, py) of a width x height image (raymarcher.cu:20-34). The ONE
    definition shared by `generate_rays` and the GPU kernel's in-kernel
    ray generation (ops/pallas_march.py): integer-valued f32 pixel
    coordinates and the same op order make the two bitwise equal.
    `forward`/`right`/`up` are 3-sequences of scalars."""
    # division (not reciprocal-multiply), as in the reference
    uv_x = px / jnp.float32(width)
    uv_y = py / jnp.float32(height)

    # Barrel distortion pre-warp (raymarcher.cu:22-25), runtime-gated without
    # retrace: blend by the 0/1 flag.
    dx, dy = apply_lens_distortion(uv_x, uv_y, distortion_amount)
    on = use_lens_distortion > 0.5
    uv_x = jnp.where(on, dx, uv_x)
    uv_y = jnp.where(on, dy, uv_y)

    aspect = jnp.float32(width) / jnp.float32(height)
    u = (uv_x * 2.0 - 1.0) * aspect
    v = uv_y * 2.0 - 1.0

    f, r = forward, right
    rd = normalize(
        Vec3(
            f[0] + u * r[0] + v * up[0],
            f[1] + u * r[1] + v * up[1],
            f[2] + u * r[2] + v * up[2],
        )
    )
    return rd, uv_x, uv_y


def pixel_grid(width: int, height: int, offset=(0, 0)):
    """f32 (px, py) planes of a height x width tile whose top-left pixel is
    `offset` = (x0, y0) (static ints or traced scalars) of a larger image.
    Integer-valued f32 adds below 2^24 are exact, so a tile's coordinates
    are bitwise the matching crop of the full image's."""
    xs = jnp.arange(width, dtype=jnp.float32) + jnp.asarray(offset[0], jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32) + jnp.asarray(offset[1], jnp.float32)
    return (jnp.broadcast_to(xs[None, :], (height, width)),
            jnp.broadcast_to(ys[:, None], (height, width)))


def generate_rays(
    width: int,
    height: int,
    cam: CameraState,
    effects: CameraEffects,
) -> Tuple[Vec3, Vec3, jnp.ndarray, jnp.ndarray]:
    """Primary rays for every pixel, top-down row order.

    Returns (origins, directions, uv_x, uv_y) where each component is a
    float32[height, width] plane. uv is the (possibly lens-distorted)
    screen coordinate later reused by the vignette (raymarcher.cu:160).
    """
    px, py = pixel_grid(width, height)
    rd, uv_x, uv_y = primary_rays(
        px, py, width, height, cam.forward, cam.right, cam.up,
        effects.use_lens_distortion, effects.distortion_amount,
    )
    shape = (height, width)
    origin = Vec3(
        jnp.broadcast_to(cam.pos[0], shape),
        jnp.broadcast_to(cam.pos[1], shape),
        jnp.broadcast_to(cam.pos[2], shape),
    )
    return origin, rd, uv_x, uv_y
