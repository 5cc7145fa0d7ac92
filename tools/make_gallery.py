#!/usr/bin/env python
"""Render the docs/gallery images on the current backend (a GPU, for
full-size renders in reasonable time).

    python tools/make_gallery.py [--fast]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from relativisticraytracer_tpu.config import (  # noqa: E402
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu.io.image import load_skybox, save_png  # noqa: E402
from relativisticraytracer_tpu.paths import default_paths, interpolate_path  # noqa: E402
from relativisticraytracer_tpu.render.camera import camera_state_from_pose  # noqa: E402
from relativisticraytracer_tpu.render.pipeline import Renderer  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parents[1] / "docs" / "gallery"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="reduced steps")
    args = ap.parse_args()

    steps = 600 if args.fast else 2000
    w, h = 640, 360
    OUT.mkdir(parents=True, exist_ok=True)
    sky = load_skybox(None, fallback_shape=(1024, 2048))
    effects = CameraEffects()

    paths = default_paths()
    shots = [
        ("gargantua_flyby_t9", SceneConfig(max_steps=steps), paths[0], 9.0),
        ("horizon_focus_t4", SceneConfig(max_steps=steps), paths[1], 4.0),
        ("horizon_skimmer_t13", SceneConfig(max_steps=steps), paths[2], 13.0),
        ("kerr_a09_t9", SceneConfig(max_steps=steps, spin_a=0.9), paths[0], 9.0),
    ]
    renderers = {}
    for name, scene, path, t in shots:
        key = scene
        if key not in renderers:
            renderers[key] = Renderer(
                scene, RenderSettings(width=w, height=h, max_steps=steps),
                skybox_rgba=sky,
            )
        pos, yaw, pitch = interpolate_path(path, t)
        cam = camera_state_from_pose(pos, yaw, pitch)
        frame = renderers[key].render_np(cam, effects, t)
        save_png(str(OUT / f"{name}.png"), frame)
        print(f"gallery {name}: mean rgb {frame[..., :3].mean():.1f}")


if __name__ == "__main__":
    main()
