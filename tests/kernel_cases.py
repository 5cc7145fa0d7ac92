"""Kernel-vs-`while` frame cases shared by test_pallas.py and
test_pallas_frames.py (split so the test workers share the Pallas
interpreter's cost)."""

import numpy as np

from relativisticraytracer_tpu.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
    effects_off,
)
from relativisticraytracer_tpu.ops.pallas_march import render_tile_pallas
from relativisticraytracer_tpu.render.camera import camera_state_from_pose
from relativisticraytracer_tpu.render.pipeline import render_frame
from relativisticraytracer_tpu.render.skybox import (
    procedural_starfield,
    skybox_from_array,
)

POSE = ((0.0, 5.0, -38.0), 0.0, -6.0)
SKY = procedural_starfield(16, 32)

# (scene kwargs, effects on, sky, (w, h), steps, supersample)
CASES = {
    "vacuum": (dict(enable_disk=False, enable_clouds=False), False, True,
               (32, 16), 64, 1),
    "kerr09": (dict(enable_disk=False, enable_clouds=False, spin_a=0.9),
               False, True, (32, 16), 64, 1),
    "disk_only": (dict(enable_clouds=False), False, True, (32, 16), 48, 1),
    "full_fx": (dict(), True, True, (32, 16), 48, 1),
    "non_pow2": (dict(), True, True, (37, 13), 32, 1),
    "no_sky": (dict(enable_clouds=False), True, False, (32, 16), 32, 1),
    "supersample2": (dict(enable_clouds=False), True, True, (16, 8), 32, 2),
}


def kernel_and_while_frames(name, **kernel_kw):
    scene_kw, fx, with_sky, (w, h), steps, ss = CASES[name]
    scene = SceneConfig(max_steps=steps, **scene_kw)
    settings = RenderSettings(width=w, height=h, max_steps=steps,
                              loop="while", supersample=ss)
    sky = skybox_from_array(SKY) if with_sky else None
    cam = camera_state_from_pose(*POSE)
    eff = CameraEffects() if fx else effects_off()
    got = render_tile_pallas(scene, settings, cam, eff, 1.5, sky,
                              interpret=True, **kernel_kw)
    want = render_frame(scene, settings, cam, eff, 1.5, sky)
    return np.asarray(got), np.asarray(want), (h, w)


