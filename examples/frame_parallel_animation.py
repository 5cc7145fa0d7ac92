#!/usr/bin/env python
"""Render an animation with whole frames round-robined across every local
card — the throughput-scaling mode (zero communication, linear in cards).
On a CPU host try:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu

RRT_EXAMPLE_SMOKE=1 shrinks the job so CI can execute this script.
"""

import os

# Smoke tier (CI) runs on the CPU backend; the config flag is set before
# any JAX use and wins over any installed accelerator plugin. Without
# RRT_EXAMPLE_SMOKE the script uses JAX's default device (a GPU runs the
# march kernel).
if os.environ.get("RRT_EXAMPLE_SMOKE") == "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax

from relativisticraytracer_tpu import RenderSettings, SceneConfig
from relativisticraytracer_tpu.io.image import load_skybox
from relativisticraytracer_tpu.paths import default_paths
from relativisticraytracer_tpu.render.pipeline import Renderer
from relativisticraytracer_tpu.runtime.app import AnimationJob

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"

renderer = Renderer(
    SceneConfig(),
    RenderSettings(width=1280, height=720)
    if not SMOKE
    else RenderSettings(width=64, height=48, max_steps=16),
    skybox_rgba=load_skybox(
        None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64)
    ),
)
job = AnimationJob(
    path=default_paths()[0],           # "Gargantua Fly-By"
    renderer=renderer,
    fps=24,
    duration=5.0 if not SMOKE else 0.25,
    out_path="flyby_720p.mp4",         # segments + concat when ffmpeg exists
)
stats = job.run(devices=jax.devices())  # frame k -> card k % N
print(stats)
