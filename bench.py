#!/usr/bin/env python
"""Headline benchmark: full-scene 1080p frame time on one NVIDIA GPU.

Renders the BASELINE.json north-star workload — 1920x1080 frame with
volumetric accretion disk + dust clouds + skybox + post FX, reference
quality settings (2000-step cap, 0.3M base step) — and prints ONE JSON
line, with the card's name and power limit beside it. Baseline: 33.33
ms/frame (>30 fps target; the CUDA reference publishes no numbers, see
BASELINE.md). vs_baseline > 1.0 beats the target. Fails on a machine
without a GPU, and when the golden parity gate fails.

Usage: python bench.py [--small] [--frames N] [--loop while|scan|pallas]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from tools.benchlib import (  # noqa: E402
    card_info,
    require_gpu,
    time_batches,
    time_first_call,
)

BASELINE_MS = 1000.0 / 30.0


def parity_gate(loop: str) -> dict:
    """Render the golden cases (tools/golden_cases.py) with the benchmarked
    march and RMSE-gate them against the CPU-rendered goldens. A missing
    golden fails the gate. Returns {"pass": bool, "cases": {name: rmse}}."""
    import numpy as np

    from tools.golden_cases import CASES, GOLDEN_DIR, render_case, rmse_u8

    out = {"pass": True, "cases": {}}
    for case in CASES:
        name = case[0]
        golden_path = GOLDEN_DIR / f"{name}.npy"
        if not golden_path.exists():
            out["cases"][name] = "missing"
            out["pass"] = False
            continue
        rmse = rmse_u8(render_case(case, loop), np.load(golden_path))
        out["cases"][name] = rmse
        out["pass"] = out["pass"] and rmse < 1e-3
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="256x256 quick sanity run")
    ap.add_argument("--frames", type=int, default=5,
                    help="frames per timed batch (3 batches)")
    ap.add_argument("--loop", default="auto",
                    choices=["auto", "while", "scan", "pallas"])
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the on-chip golden parity gate")
    args = ap.parse_args()

    dev = require_gpu()

    from relativisticraytracer_tpu.config import (
        CameraEffects,
        RenderSettings,
        SceneConfig,
    )
    from relativisticraytracer_tpu.render.camera import default_camera
    from relativisticraytracer_tpu.render.pipeline import Renderer
    from relativisticraytracer_tpu.render.skybox import procedural_starfield

    width, height = (256, 256) if args.small else (1920, 1080)
    scene = SceneConfig()  # full reference scene, max_steps=2000
    settings = RenderSettings(width=width, height=height, loop=args.loop)
    renderer = Renderer(scene, settings,
                        skybox_rgba=procedural_starfield(2048, 4096))
    loop = settings.resolved_loop()

    # Reference startup pose (src/main.cpp:128-130); sim clock advances at
    # the recording rate (main.cpp:511-513).
    camera = default_camera()
    effects = CameraEffects()

    def frame(i):
        return renderer.render(camera, effects, 1.0 + i / 24.0)

    compile_s = time_first_call(frame)
    ms, batches = time_batches(frame, batches=3, per_batch=args.frames)

    result = {
        "metric": f"full_scene_{height}p_frame_time[{dev.device_kind},{loop}]",
        "value": ms,
        "unit": "ms/frame",
        "vs_baseline": BASELINE_MS / ms,
        "batches_ms": batches,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "card": card_info(),
    }
    if not args.no_parity:
        gate = parity_gate(loop)
        result["parity"] = "pass" if gate["pass"] else "fail"
        result["parity_rmse"] = gate["cases"]

    print(json.dumps(result))
    if result.get("parity") == "fail":
        print("# PARITY GATE FAILED on this device", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
