#!/usr/bin/env python
"""Time the GPU march kernel's block / warp / unroll choices against the
plain XLA `while` march, per frame, on the card.

    python tools/sweep_march.py [--sizes 1920x1080,1000x700]
        [--configs 4x8:1:4,8x8:2:4,...] [--budget-s 600]

A config is BHxBW:num_warps:unroll. Full scene (disk, clouds, procedural
sky, post FX), the reference's 2000-step cap and startup pose. Prints one
JSON line per (size, config) with the compile time (first call) and the
median of 3 batches of 3 frames, plus the largest difference to the XLA
frame in LSB. Stops starting new configs once `--budget-s` has passed.
A config that fails to compile is reported as such and the sweep goes on.
"""

import argparse
import functools
import json
import pathlib
import sys
import time as _time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tools.benchlib import (  # noqa: E402
    card_info,
    require_gpu,
    time_batches,
    time_first_call,
)


def _frame_fn(scene, settings, cam, effects, sky, kernel_kw=None):
    import jax
    import jax.numpy as jnp

    if kernel_kw is None:
        from relativisticraytracer_tpu.render.pipeline import render_frame

        fn = jax.jit(functools.partial(render_frame, scene, settings))
    else:
        from relativisticraytracer_tpu.ops.pallas_march import (
            render_tile_pallas,
        )

        fn = jax.jit(functools.partial(render_tile_pallas, scene, settings,
                                       **kernel_kw))
    return lambda i: fn(cam, effects, jnp.float32(1.0 + i / 24.0), sky)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1920x1080,1000x700")
    ap.add_argument("--configs", default="4x8:1:4")
    ap.add_argument("--budget-s", type=float, default=600.0)
    args = ap.parse_args()

    dev = require_gpu()
    print(f"# device {dev.platform} {dev.device_kind} | {card_info()}",
          flush=True)

    import numpy as np

    from relativisticraytracer_tpu.config import (
        CameraEffects,
        RenderSettings,
        SceneConfig,
    )
    from relativisticraytracer_tpu.render.camera import default_camera
    from relativisticraytracer_tpu.render.skybox import (
        procedural_starfield,
        skybox_from_array,
    )

    scene = SceneConfig()
    sky = skybox_from_array(procedural_starfield(2048, 4096))
    cam = default_camera()
    effects = CameraEffects()
    t_start = _time.perf_counter()
    for size in args.sizes.split(","):
        w, h = (int(v) for v in size.split("x"))
        settings = RenderSettings(width=w, height=h, loop="while")
        xla = _frame_fn(scene, settings, cam, effects, sky)
        compile_s = time_first_call(xla)
        med, per = time_batches(xla)
        ref = np.asarray(xla(0))
        print(json.dumps({"size": size, "path": "xla_while",
                          "compile_s": compile_s, "ms": med,
                          "ms_batches": per}), flush=True)
        for cfg in args.configs.split(","):
            if _time.perf_counter() - t_start > args.budget_s:
                print(f"# budget spent; skipped {size} {cfg}", flush=True)
                continue
            blk, warps, unroll = cfg.split(":")
            bh, bw = (int(v) for v in blk.split("x"))
            kw = dict(block=(bh, bw), num_warps=int(warps),
                      unroll=int(unroll))
            rec = {"size": size, "path": "kernel", "config": cfg}
            try:
                fn = _frame_fn(scene, settings, cam, effects, sky, kw)
                rec["compile_s"] = time_first_call(fn)
                rec["ms"], rec["ms_batches"] = time_batches(fn)
                d = np.abs(np.asarray(fn(0)).astype(int) - ref.astype(int))
                rec["max_lsb_vs_xla"] = int(d.max())
                rec["frac_px_differ"] = float((d[..., :3] > 0).any(-1).mean())
            except Exception as e:  # noqa: BLE001 — a sweep reports, goes on
                rec["error"] = repr(e)[:2000]
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
