#!/usr/bin/env python
"""Measure the sanctioned precision-for-speed trades (RMSE < 1e-3 budget).

BASELINE.json's parity contract is per-pixel RMSE < 1e-3 vs the reference;
the build ships bitwise-exact semantics, leaving that budget unspent.
This measures what spending it buys on THIS hardware:

  * noise_octave_cap N: every fbm/ridge octave count in the media stack
    capped at N (SceneConfig.noise_octave_cap; None = reference-exact).
    Rendered through the default path at 1080p: ms + RMSE vs the exact
    frame (computed on device).
  * step_scale k: SceneConfig.step_size_m scaled by k — the same geodesic
    integral with coarser RK4 steps (every adaptive zone scales together,
    raymarcher.cu:54-62 semantics preserved). Rays terminate in ~1/k the
    steps, so the march cost drops ~linearly — IF the lensing error near
    the photon ring fits the budget.

Writes docs/precision_trades.json. Needs an NVIDIA GPU.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import time as _time

import numpy as np
import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--caps", type=int, nargs="*", default=[4, 3, 2])
    ap.add_argument("--step-scales", type=float, nargs="*",
                    default=[1.1, 1.25, 1.5])
    args = ap.parse_args()

    from tools.benchlib import card_info, require_gpu

    dev = require_gpu()
    print(f"# {dev.device_kind} | {card_info()}", flush=True)

    from relativisticraytracer_tpu.config import (
        CameraEffects,
        RenderSettings,
        SceneConfig,
    )
    from relativisticraytracer_tpu.render.camera import camera_state_from_pose
    from relativisticraytracer_tpu.render.pipeline import Renderer
    from relativisticraytracer_tpu.render.skybox import procedural_starfield

    W, H = args.width, args.height
    settings = RenderSettings(width=W, height=H, loop="auto")
    sky = procedural_starfield(2048, 4096)
    cam = camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)
    eff = CameraEffects()

    def timed(r):
        out = r.render(cam, eff, 1.0)
        np.asarray(jnp.sum(out.ravel()[:8].astype(jnp.float32)))
        best = []
        for _ in range(3):
            t0 = _time.perf_counter()
            for _ in range(5):
                out = r.render(cam, eff, 1.0)
            np.asarray(jnp.sum(out.ravel()[:8].astype(jnp.float32)))
            best.append((_time.perf_counter() - t0) * 200.0)
        return out, float(np.median(best))

    results = {"width": W, "height": H, "pose": "headline", "cases": {}}
    exact_r = Renderer(SceneConfig(), settings, skybox_rgba=sky)
    exact_frame, exact_ms = timed(exact_r)
    results["cases"]["exact"] = {"ms": round(exact_ms, 1), "rmse": 0.0}
    print(f"exact      {exact_ms:7.1f} ms")

    @jax.jit
    def rmse(a, b):
        d = (a[..., :3].astype(jnp.float32) - b[..., :3].astype(jnp.float32))
        return jnp.sqrt(jnp.mean((d / 255.0) ** 2))

    BUDGET = 1e-3

    def measure_case(name, scene):
        frame, ms = timed(Renderer(scene, settings, skybox_rgba=sky))
        e = float(rmse(frame, exact_frame))
        ok = "WITHIN budget" if e < BUDGET else "over budget"
        results["cases"][name] = {
            "ms": round(ms, 1), "rmse": round(e, 6), "fits_budget": e < BUDGET,
        }
        print(f"{name:<12} {ms:7.1f} ms  rmse {e:.2e}  ({ok})")

    for cap in args.caps:
        measure_case(f"octaves<= {cap}", SceneConfig(noise_octave_cap=cap))
    base_h = SceneConfig().step_size_m
    for k in args.step_scales:
        measure_case(f"step_scale {k}", SceneConfig(step_size_m=base_h * k))

    out = pathlib.Path(__file__).resolve().parents[1] / "docs" / "precision_trades.json"
    if out.exists():
        # partial runs (--caps / --step-scales subsets) merge into the
        # existing record instead of clobbering the other cases, and any
        # extra top-level records (e.g. step_scale_probe) are preserved
        prev = json.loads(out.read_text())
        same_dims = (prev.get("width"), prev.get("height")) == (W, H)
        merged_cases = prev.get("cases", {}) if same_dims else {}
        merged_cases.update(results["cases"])
        prev.update(results)
        prev["cases"] = merged_cases
        results = prev
    out.write_text(json.dumps(results, indent=2))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
