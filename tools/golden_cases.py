"""The golden parity cases: one list for tools/make_goldens.py (which
renders them on the CPU into tests/goldens/), bench.py and chip_smoke.py
(which render them on the GPU and gate the RMSE against those files).

(name, scene kwargs, effects on, (w, h), pose, time, max_steps). The
small cases bracket the march's code paths (vacuum, Kerr spin, disk, full
scene with effects); the 192x108 and 512x512 frames catch
resolution-dependent faults in padding and block index math; the
full_budget_192x108 case runs the production 2000-step cap, where every
other case stops at 400.
"""

import pathlib

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[1] / "tests" / "goldens"
DEFAULT_POSE = ((0.0, 5.0, -38.0), 0.0, -6.0)
# the golden renders use this procedural sky size (procedural_starfield)
SKY_SHAPE = (64, 128)
CASES = [
    ("schwarzschild_vacuum", dict(enable_disk=False, enable_clouds=False),
     False, (64, 48), DEFAULT_POSE, 2.0, 400),
    ("kerr09_vacuum", dict(enable_disk=False, enable_clouds=False, spin_a=0.9),
     False, (64, 48), DEFAULT_POSE, 2.0, 400),
    ("disk_only", dict(enable_clouds=False), False, (64, 48),
     DEFAULT_POSE, 2.0, 400),
    ("full_scene_fx", dict(), True, (64, 48), DEFAULT_POSE, 2.0, 400),
    ("offaxis_full_192x108", dict(), True, (192, 108),
     ((-18.0, -5.0, -38.0), 18.0, 4.0), 7.0, 400),
    ("full_scene_512", dict(), True, (512, 512), DEFAULT_POSE, 2.0, 400),
    ("full_budget_192x108", dict(), True, (192, 108),
     ((0.0, 10.0, -60.0), 0.0, -10.0), 10.0, 2000),
]


def rmse_u8(got, want) -> float:
    """RMSE of the RGB channels of two uint8 frames, in [0, 1] units."""
    import numpy as np

    diff = got[..., :3].astype(int) - want[..., :3].astype(int)
    return float(np.sqrt(np.mean((diff / 255.0) ** 2)))


def render_case(case, loop: str):
    """Render one golden case through the Renderer with `loop`."""
    from relativisticraytracer_tpu.config import (
        CameraEffects,
        RenderSettings,
        SceneConfig,
        effects_off,
    )
    from relativisticraytracer_tpu.render.camera import camera_state_from_pose
    from relativisticraytracer_tpu.render.pipeline import Renderer
    from relativisticraytracer_tpu.render.skybox import procedural_starfield

    name, scene_kw, effects_on, (w, h), pose, t, steps = case
    scene = SceneConfig(max_steps=steps, **scene_kw)
    settings = RenderSettings(width=w, height=h, max_steps=steps, loop=loop)
    r = Renderer(scene, settings, skybox_rgba=procedural_starfield(*SKY_SHAPE))
    effects = CameraEffects() if effects_on else effects_off()
    return r.render_np(camera_state_from_pose(*pose), effects, time=t)
