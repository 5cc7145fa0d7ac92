#!/usr/bin/env python
"""Serve a live fly-camera preview at http://localhost:8000 (MJPEG over
HTTP). Equivalent CLI: python -m relativisticraytracer_tpu interactive.
Controls: click to capture the mouse; WASD/Space/Shift fly, R records,
P plays a path, B/V/L/C effects, ESC quits.

RRT_EXAMPLE_SMOKE=1 starts the server on an ephemeral port, fetches one
rendered frame over HTTP, then shuts down — so CI executes the real
preview path end-to-end."""

import os

# Smoke tier (CI) runs on the CPU backend; the config flag is set before
# any JAX use and wins over any installed accelerator plugin. Without
# RRT_EXAMPLE_SMOKE the script uses JAX's default device (a GPU runs the
# march kernel).
if os.environ.get("RRT_EXAMPLE_SMOKE") == "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

from relativisticraytracer_tpu import RenderSettings, SceneConfig
from relativisticraytracer_tpu.io.image import load_skybox
from relativisticraytracer_tpu.render.pipeline import Renderer
from relativisticraytracer_tpu.runtime.app import Session
from relativisticraytracer_tpu.runtime.preview import PreviewServer

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"

session = Session(renderer=Renderer(
    SceneConfig(**({"max_steps": 16} if SMOKE else {})),
    RenderSettings(width=960, height=540)
    if not SMOKE
    else RenderSettings(width=64, height=48, max_steps=16),
    skybox_rgba=load_skybox(
        None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64)
    ),
))
server = PreviewServer(session, port=8000 if not SMOKE else 0, fps_cap=30.0)
print(f"open http://localhost:{server.port} — click to capture the mouse; "
      "WASD/Space/Shift fly, R records, P plays a path, B/V/L/C effects, "
      "ESC quits")
if SMOKE:
    import urllib.request

    server.start()
    with urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/frame.jpg", timeout=120
    ) as r:
        assert r.status == 200 and r.read(2) == b"\xff\xd8", "not a JPEG"
    session.handle_key("escape")   # exercise the ESC path
    server.stop()
    print("smoke: one frame served, ESC shutdown clean")
else:
    server.serve_until_interrupt()
