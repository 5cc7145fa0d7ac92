#!/usr/bin/env python
"""Tile one frame across every local GPU (zero collectives; each card
early-exits its own tile). On a CPU host, set
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
to try the same code on 8 virtual devices.

RRT_EXAMPLE_SMOKE=1 shrinks the frame so CI can execute this script."""

import os

# Smoke tier (CI) runs on the CPU backend; the config flag is set before
# any JAX use and wins over any installed accelerator plugin. Without
# RRT_EXAMPLE_SMOKE the script uses JAX's default device (a GPU runs the
# march kernel).
if os.environ.get("RRT_EXAMPLE_SMOKE") == "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from relativisticraytracer_tpu import CameraEffects, RenderSettings, SceneConfig
from relativisticraytracer_tpu.io.image import load_skybox, save_png
from relativisticraytracer_tpu.parallel.sharding import make_mesh, make_sharded_renderer
from relativisticraytracer_tpu.render.camera import camera_state_from_pose
from relativisticraytracer_tpu.render.skybox import skybox_from_array

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"

mesh = make_mesh()  # all devices, most-square ('ty','tx') factorization
print(f"mesh: {mesh.devices.shape} over {mesh.devices.size} device(s)")

scene = SceneConfig(**({"max_steps": 16} if SMOKE else {}))
settings = (
    RenderSettings(width=1920, height=1080)
    if not SMOKE
    else RenderSettings(width=256, height=128, max_steps=16)
)
render = make_sharded_renderer(scene, settings, mesh)

camera = camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)
sky = skybox_from_array(
    load_skybox(None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64))
)
frame = render(camera, CameraEffects(), 1.0, sky)
print(f"sharding: {frame.sharding}")
save_png("sharded.png", np.asarray(frame))
