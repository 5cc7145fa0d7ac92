#!/usr/bin/env python
"""Smoke check: the renderer's main path, end to end, on an NVIDIA GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # only the multi-card paths, on four cards

One card, in order:
  device  JAX's device and `nvidia-smi` name + power limit; fails unless
          the platform is "gpu".
  parity  every golden case (tools/golden_cases.py) through the plain XLA
          `while` march and through the Pallas-Triton kernel: RMSE of each
          against the CPU goldens (gate: < 1e-3), and kernel vs XLA on the
          card (max |diff| in LSB, RMSE, share of differing pixels).
  timing  kernel vs XLA per frame, full scene with the 2000-step cap, at
          1920x1080 and the reference's 1000x700 window: compile (first
          call) apart, then the median of 3 batches of 3 frames. Confirms
          the kernel path lowers to a compiled Triton call.
  cli     `python -m relativisticraytracer_tpu still` at both sizes (the
          1000x700 still must equal the timed kernel frame) and `anim` for
          a few frames of path 0 at 1000x700 into the frame sink.

--four runs only what exists across cards: a 1080p frame through
`make_sharded_renderer` on a 2x2 mesh, compared with the one-card frame
(bitwise equal expected), and `AnimationJob.run` over the four cards.

Everything is one process, so one JAX client holds the card(s). The last
line of stdout is one JSON object, {"ok": true, "device": {...}}; any
failed phase exits non-zero without it, and so does a machine whose JAX
has no GPU.
"""

import argparse
import json
import sys
import tempfile
import time as _time

SIZES = ((1920, 1080), (1000, 700))


class PhaseFailed(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def phase_device(n_needed: int):
    import jax

    devs = jax.devices()
    dev = devs[0]
    print(f"[device] {dev.platform} {dev.device_kind} x{len(devs)} "
          f"(jax {jax.__version__})", flush=True)
    _check(dev.platform == "gpu", f"platform is {dev.platform!r}, not 'gpu'")
    _check(len(devs) >= n_needed, f"needs {n_needed} GPUs, found {len(devs)}")
    from tools.benchlib import card_info

    print(f"[device] nvidia-smi: {card_info()}", flush=True)
    return devs


def phase_parity():
    import numpy as np

    from tools.golden_cases import CASES, GOLDEN_DIR, render_case, rmse_u8

    ok = True
    for case in CASES:
        name = case[0]
        want = np.load(GOLDEN_DIR / f"{name}.npy")
        xla = render_case(case, loop="while")
        ker = render_case(case, loop="pallas")
        r_xla, r_ker = rmse_u8(xla, want), rmse_u8(ker, want)
        d = np.abs(ker[..., :3].astype(int) - xla[..., :3].astype(int))
        print(f"[parity] {name}: rmse_vs_golden xla={r_xla:.3e} "
              f"kernel={r_ker:.3e} | kernel_vs_xla max={int(d.max())} LSB "
              f"rmse={rmse_u8(ker, xla):.3e} "
              f"px_differ={float((d > 0).any(-1).mean()):.3e}", flush=True)
        ok = ok and r_xla < 1e-3 and r_ker < 1e-3
    _check(ok, "a golden case is at or above RMSE 1e-3")


def _renderers(w, h, sky):
    from relativisticraytracer_tpu.config import RenderSettings, SceneConfig
    from relativisticraytracer_tpu.render.pipeline import Renderer

    # The same (scene, settings) values the CLI builds, so the cli phase
    # reuses these compiled programs.
    scene = SceneConfig(max_steps=2000)
    out = {}
    for path, loop in (("kernel", "auto"), ("xla_while", "while")):
        settings = RenderSettings(width=w, height=h, max_steps=2000, loop=loop)
        out[path] = Renderer(scene, settings, skybox=sky)
    _check(out["kernel"].settings.resolved_loop() == "pallas",
           "loop='auto' did not resolve to the GPU kernel")
    return out


def phase_timing(sky):
    import jax.numpy as jnp

    from relativisticraytracer_tpu.config import CameraEffects
    from relativisticraytracer_tpu.render.camera import default_camera
    from tools.benchlib import lowers_to_triton, time_batches, time_first_call

    cam, eff = default_camera(), CameraEffects()
    frames = {}
    for w, h in SIZES:
        rs = _renderers(w, h, sky)
        compiled = lowers_to_triton(rs["kernel"]._fn, cam, eff,
                                    jnp.float32(1.0), sky)
        _check(compiled, f"{w}x{h}: the kernel path is not a Triton call")
        _check(not lowers_to_triton(rs["xla_while"]._fn, cam, eff,
                                    jnp.float32(1.0), sky),
               f"{w}x{h}: the XLA path lowered to a Triton call")
        res = {}
        for path, r in rs.items():
            def fn(i, r=r):
                return r.render(cam, eff, 1.0 + i / 24.0)

            compile_s = time_first_call(fn)
            med, per = time_batches(fn)
            res[path] = med
            print(f"[timing] {w}x{h} {path}: compile+first {compile_s:.1f} s, "
                  f"median {med:.2f} ms/frame (batches "
                  f"{', '.join(f'{p:.2f}' for p in per)})"
                  + (" [compiled Triton kernel]" if path == "kernel" else ""),
                  flush=True)
        print(f"[timing] {w}x{h} kernel speedup over xla_while: "
              f"{res['xla_while'] / res['kernel']:.1f}x", flush=True)
        frames[(w, h)] = rs["kernel"].render_np(cam, eff, 1.0)
    return frames


def phase_cli(frames):
    import pathlib

    import numpy as np

    from relativisticraytracer_tpu.__main__ import main as cli
    from relativisticraytracer_tpu.io.image import load_image_rgba
    from relativisticraytracer_tpu.io.video import ffmpeg_available

    with tempfile.TemporaryDirectory() as td:
        for w, h in SIZES:
            out = f"{td}/still_{w}x{h}.png"
            t0 = _time.perf_counter()
            cli(["still", "--width", str(w), "--height", str(h), "--out", out])
            img = load_image_rgba(out)
            _check(img.shape == (h, w, 4), f"still {w}x{h}: shape {img.shape}")
            same = np.array_equal(img, frames[(w, h)])
            print(f"[cli] still {w}x{h}: {_time.perf_counter() - t0:.1f} s, "
                  f"equals the timed kernel frame: {same}", flush=True)
            _check(same, f"still {w}x{h} differs from the kernel frame")

        n, w, h = 4, 1000, 700
        t0 = _time.perf_counter()
        cli(["anim", "--path-index", "0", "--width", str(w), "--height",
             str(h), "--fps", "24", "--duration", str(n / 24),
             "--out", f"{td}/clip.mp4"])
        if ffmpeg_available():
            out = pathlib.Path(f"{td}/clip.mp4")
            _check(out.exists() and out.stat().st_size > 0, "no mp4 written")
            what = f"{out.name} {out.stat().st_size} bytes (ffmpeg)"
        else:
            out = pathlib.Path(f"{td}/clip.rgba")
            size = out.stat().st_size if out.exists() else -1
            _check(size == n * w * h * 4,
                   f"{out.name}: {size} bytes, expected {n * w * h * 4}")
            what = f"{out.name} {size} bytes = {n} x {w}x{h}x4"
        print(f"[cli] anim path 0, {n} frames at {w}x{h}: "
              f"{_time.perf_counter() - t0:.1f} s, {what}", flush=True)


def phase_four(devs):
    import numpy as np

    from relativisticraytracer_tpu.config import (
        CameraEffects,
        RenderSettings,
        SceneConfig,
    )
    from relativisticraytracer_tpu.parallel.sharding import (
        make_mesh,
        make_sharded_renderer,
    )
    from relativisticraytracer_tpu.paths import default_paths
    from relativisticraytracer_tpu.render.camera import default_camera
    from relativisticraytracer_tpu.render.pipeline import Renderer
    from relativisticraytracer_tpu.render.skybox import (
        procedural_starfield,
        skybox_from_array,
    )
    from relativisticraytracer_tpu.runtime.app import AnimationJob
    from tools.benchlib import time_batches, time_first_call

    devs = devs[:4]
    scene = SceneConfig(max_steps=2000)
    settings = RenderSettings(width=1920, height=1080, max_steps=2000)
    sky = skybox_from_array(procedural_starfield(1024, 2048))
    cam, eff = default_camera(), CameraEffects()
    mesh = make_mesh(devs, shape=(2, 2))
    fn = make_sharded_renderer(scene, settings, mesh)

    def sharded(i):
        return fn(cam, eff, 1.0 + i / 24.0, sky)

    compile_s = time_first_call(sharded)
    med, per = time_batches(sharded)
    tiled = np.asarray(fn(cam, eff, 1.0, sky))
    one = Renderer(scene, settings, skybox=sky)
    single = one.render_np(cam, eff, 1.0)
    d = np.abs(tiled.astype(int) - single.astype(int))
    print(f"[four] 1080p on a 2x2 mesh ({settings.resolved_loop()}): "
          f"compile+first {compile_s:.1f} s, median {med:.2f} ms/frame "
          f"(batches {', '.join(f'{p:.2f}' for p in per)}); "
          f"vs one card: max |diff| {int(d.max())} LSB", flush=True)
    _check(np.array_equal(tiled, single),
           "the sharded 1080p frame differs from the one-card frame")

    r = Renderer(scene, RenderSettings(width=1000, height=700,
                                       max_steps=2000), skybox=sky)
    n = 8
    with tempfile.TemporaryDirectory() as td:
        stats = AnimationJob(path=default_paths()[0], renderer=r, fps=24,
                             duration=n / 24, out_path=f"{td}/clip.rgba",
                             ).run(devices=devs)
    print(f"[four] AnimationJob over {stats['devices']} cards: "
          f"{stats['frames_written']} frames at 1000x700 in "
          f"{stats['wall_s']:.1f} s (compiles included)", flush=True)
    _check(stats["frames_written"] == n and stats["devices"] == 4,
           f"animation over four cards: {stats}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card paths, on four cards")
    args = ap.parse_args()

    t0 = _time.perf_counter()
    try:
        devs = phase_device(4 if args.four else 1)
        if args.four:
            phase_four(devs)
        else:
            from relativisticraytracer_tpu.render.skybox import (
                procedural_starfield,
                skybox_from_array,
            )

            phase_parity()
            # the CLI's default sky (io/image.load_skybox fallback shape)
            sky = skybox_from_array(procedural_starfield(1024, 2048))
            frames = phase_timing(sky)
            phase_cli(frames)
    except PhaseFailed as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    dev = devs[0]
    print(f"[done] all phases passed in {_time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four else len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
