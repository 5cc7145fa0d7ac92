#!/usr/bin/env python
"""Run the BASELINE.json config ladder end-to-end and report timings.

  1. Schwarzschild lensed-skybox still, 256x256, no disk
  2. Kerr a=0.9 shadow + photon ring, 512x512
  3. Volumetric accretion disk (radiative transfer), 512x512
  4. Full scene 1080p: disk + clouds + skybox + post FX
  5. Catmull-Rom camera-path animation with all effects -> video

Needs an NVIDIA GPU. Writes docs/config_ladder.json and per-config PNGs
under docs/gallery/.
"""

import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from relativisticraytracer_tpu.config import (  # noqa: E402
    CameraEffects,
    RenderSettings,
    SceneConfig,
    effects_off,
)
from relativisticraytracer_tpu.io.image import load_skybox, save_png  # noqa: E402
from relativisticraytracer_tpu.paths import default_paths  # noqa: E402
from relativisticraytracer_tpu.render.camera import camera_state_from_pose  # noqa: E402
from relativisticraytracer_tpu.render.pipeline import Renderer  # noqa: E402
from relativisticraytracer_tpu.runtime.app import AnimationJob  # noqa: E402
from tools.benchlib import (  # noqa: E402
    card_info,
    require_gpu,
    time_batches,
    time_first_call,
)

OUT = pathlib.Path(__file__).resolve().parents[1] / "docs"


def _time_renderer(renderer, cam, effects):
    """(median ms/frame of 3 batches of 3 pipelined frames, compile s)."""
    def fn(i):
        return renderer.render(cam, effects, 1.0 + i / 24.0)

    compile_s = time_first_call(fn)
    med, _ = time_batches(fn)
    return med, compile_s


def main():
    dev = require_gpu()
    card = card_info()
    sky = load_skybox(None)
    cam = camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)
    results = []

    ladder = [
        ("1_schwarzschild_256", SceneConfig(enable_disk=False, enable_clouds=False),
         256, 256, effects_off()),
        ("2_kerr09_512", SceneConfig(spin_a=0.9, enable_disk=False, enable_clouds=False),
         512, 512, effects_off()),
        ("3_disk_512", SceneConfig(enable_clouds=False), 512, 512, effects_off()),
        # the CLI presets' rungs (full scene + FX at each preset resolution)
        ("4_full_1080p", SceneConfig(), 1920, 1080, CameraEffects()),
        ("4b_full_540p_preview", SceneConfig(), 960, 540, CameraEffects()),
        ("4c_full_realtime", SceneConfig(), 480, 272, CameraEffects()),
        # the reference's own window size (config.h:7-8) at full quality
        ("4d_reference_window", SceneConfig(), 1000, 700, CameraEffects()),
    ]
    for name, scene, w, h, eff in ladder:
        r = Renderer(scene, RenderSettings(width=w, height=h), skybox_rgba=sky)
        ms, compile_s = _time_renderer(r, cam, eff)
        frame = r.render_np(cam, eff, 1.0)
        save_png(str(OUT / "gallery" / f"ladder_{name}.png"), frame)
        results.append({"config": name, "ms_per_frame": round(ms, 1),
                        "compile_s": round(compile_s, 1),
                        "meets_30fps": ms < 1000.0 / 30.0,
                        "resolution": f"{w}x{h}", "max_steps": scene.max_steps})
        print(results[-1], flush=True)

    # 5. animation -> video (2 s at 480x272, all effects, fixed-step clock).
    # Warm up (compile) OUTSIDE the timed job so ms_per_frame is the steady
    # pipelined throughput, and report compile time separately.
    from relativisticraytracer_tpu.paths import interpolate_path

    r = Renderer(SceneConfig(), RenderSettings(width=480, height=272), skybox_rgba=sky)
    path = default_paths()[0]
    pos, yaw, pitch = interpolate_path(path, 1.0 / 24.0)
    compile_s = time_first_call(lambda i: r.render(
        camera_state_from_pose(pos, yaw, pitch), CameraEffects(), 1.0 / 24.0))
    with tempfile.TemporaryDirectory() as td:
        job = AnimationJob(path=path, renderer=r, fps=24, duration=2.0,
                           out_path=f"{td}/ladder_anim.mp4")
        stats = job.run(resume=False)
    # still-render throughput at the same resolution/pose family, for the
    # "animation ~= still throughput" sanity comparison (device-side only;
    # the animation number additionally pays the per-frame host fetch).
    still_ms, _ = _time_renderer(
        r, camera_state_from_pose(pos, yaw, pitch), CameraEffects())
    results.append({
        "config": "5_path_animation_480p", "frames": stats["frames"],
        "ms_per_frame": round(stats["mean_frame_ms"], 1),
        "still_throughput_ms_same_res": round(still_ms, 1),
        "compile_s": round(compile_s, 1),
    })
    print(results[-1], flush=True)

    report = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": card,
        "configs": results,
    }
    (OUT / "config_ladder.json").write_text(json.dumps(report, indent=2))
    print(f"wrote {OUT / 'config_ladder.json'}")


if __name__ == "__main__":
    main()
