"""The frame program: one pure jitted function per (scene, resolution).

Everything the reference spreads over main.cpp/GL/CUDA plumbing collapses
into `render_frame`: ray gen -> masked geodesic march -> radiative transfer
-> skybox composite -> post FX -> tone map -> uint8 pack. The host driver
(runtime/app.py) only feeds (camera, effects, time) pytrees and streams
uint8 frames out — the analog of the reference's per-frame kernel
launch + PBO interop (src/main.cpp:460-480).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from relativisticraytracer_tpu.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu.core.vecmath import Vec3
from relativisticraytracer_tpu.render.camera import (
    CameraState,
    pixel_grid,
    primary_rays,
)
from relativisticraytracer_tpu.render.march import (
    MarchState,
    composite_background,
    march,
)
from relativisticraytracer_tpu.render.postfx import (
    apply_effects_and_tonemap,
    downsample_box,
    pack_rgba8,
)
from relativisticraytracer_tpu.render.skybox import Skybox, sample_sky


def frame_epilogue(scene: SceneConfig, effects: CameraEffects,
                   sky: Optional[Skybox], state: MarchState, uv_x, uv_y,
                   ss: int) -> jnp.ndarray:
    """Marched rays -> uint8 RGBA: sky composite (raymarcher.cu:123-150),
    post FX + tone map (:152-166), supersample resolve and pack (:168-172).
    Shared by the XLA march and the GPU kernel path."""
    if sky is not None:
        def sky_fn(d: Vec3) -> Vec3:
            return sample_sky(sky, d, effects)
    else:
        def sky_fn(d: Vec3) -> Vec3:
            zero = jnp.zeros_like(d.x)
            return Vec3(zero, zero, zero)

    hdr = composite_background(state, sky_fn)
    ldr = apply_effects_and_tonemap(hdr, uv_x, uv_y, effects, scene.exposure)
    return pack_rgba8(downsample_box(ldr, ss))


def render_tile(
    scene: SceneConfig,
    settings: RenderSettings,
    camera: CameraState,
    effects: CameraEffects,
    time,
    sky: Optional[Skybox],
    tile=None,
    offset=(0, 0),
) -> jnp.ndarray:
    """Render the (tile_w, tile_h) tile, in supersampled pixels, whose
    top-left pixel is `offset` of the settings' frame (default: the whole
    frame) -> uint8[tile_h/ss, tile_w/ss, 4]. A tile is bitwise the
    matching crop of the frame, which is what the multi-card path
    (parallel/sharding.py) relies on. The march runs as
    `settings.resolved_loop()` says: the GPU kernel or an XLA loop."""
    if settings.resolved_loop() == "pallas":
        from relativisticraytracer_tpu.ops.pallas_march import (
            render_tile_pallas,
        )

        return render_tile_pallas(scene, settings, camera, effects, time,
                                  sky, tile=tile, offset=offset)

    ss = settings.supersample
    img_w, img_h = settings.width * ss, settings.height * ss
    tw, th = tile if tile is not None else (img_w, img_h)
    px, py = pixel_grid(tw, th, offset)
    direction, uv_x, uv_y = primary_rays(
        px, py, img_w, img_h, camera.forward, camera.right, camera.up,
        effects.use_lens_distortion, effects.distortion_amount,
    )
    origin = Vec3(*(jnp.broadcast_to(camera.pos[k], (th, tw))
                    for k in range(3)))
    state = march(scene, origin, direction, time,
                  max_steps=settings.resolved_max_steps(scene),
                  loop=settings.resolved_loop(), chunk=settings.chunk)
    return frame_epilogue(scene, effects, sky, state, uv_x, uv_y, ss)


def render_frame(
    scene: SceneConfig,
    settings: RenderSettings,
    camera: CameraState,
    effects: CameraEffects,
    time,
    sky: Optional[Skybox],
) -> jnp.ndarray:
    """Render one frame -> uint8[height, width, 4], top-down row order.

    `scene`/`settings` are static (hashable); `camera`, `effects`, `time`,
    and `sky` are traced, so camera motion, effect toggles, the sim clock,
    and even skybox swaps reuse the compiled program.
    """
    return render_tile(scene, settings, camera, effects, time, sky)


@functools.lru_cache(maxsize=32)
def _compiled_render(scene: SceneConfig, settings: RenderSettings):
    return jax.jit(functools.partial(render_frame, scene, settings))


class Renderer:
    """Convenience host-side driver around the jitted frame program.

    Caches one executable per (scene, settings); keeps the skybox resident
    on device (the one-time upload, analog of main.cpp:247-248).
    """

    def __init__(
        self,
        scene: SceneConfig = SceneConfig(),
        settings: RenderSettings = RenderSettings(),
        skybox_rgba: Optional[np.ndarray] = None,
        skybox: Optional[Skybox] = None,
    ):
        self.scene = scene
        self.settings = settings
        # `skybox` shares an already-built device texture (e.g. between a
        # quality and a motion renderer — one device copy); `skybox_rgba`
        # uploads a host array.
        self.sky: Optional[Skybox] = skybox
        if skybox is None and skybox_rgba is not None:
            from relativisticraytracer_tpu.render.skybox import skybox_from_array

            self.sky = skybox_from_array(skybox_rgba)
        self._fn = _compiled_render(scene, settings)
        self._sky_cache: dict = {}

    def render(
        self,
        camera: CameraState,
        effects: Optional[CameraEffects] = None,
        time: float = 0.0,
    ) -> jnp.ndarray:
        """Returns the device uint8[H, W, 4] frame (no host copy)."""
        if effects is None:
            effects = CameraEffects()
        return self._fn(camera, effects, jnp.float32(time), self.sky)

    def render_np(self, camera, effects=None, time: float = 0.0) -> np.ndarray:
        """Render and fetch to host (the analog of the PBO readback)."""
        return np.asarray(self.render(camera, effects, time))

    def _sky_on(self, device):
        """Per-device replica of the skybox (one-time upload per card)."""
        if self.sky is None or device is None:
            return self.sky
        if device not in self._sky_cache:
            self._sky_cache[device] = jax.device_put(self.sky, device)
        return self._sky_cache[device]

    def render_on(self, device, camera, effects=None,
                  time: float = 0.0) -> jnp.ndarray:
        """Dispatch one frame on a SPECIFIC jax.Device (returns the device
        array without blocking). Frames are mutually independent, so an
        animation round-robins them across cards with zero communication —
        the frame-parallel complement to parallel/sharding's spatial tiling
        (reference recording loop: src/main.cpp:505-529, at N-card
        throughput)."""
        if effects is None:
            effects = CameraEffects()
        if device is None:
            return self._fn(camera, effects, jnp.float32(time), self.sky)
        camera, effects, t = jax.device_put(
            (camera, effects, jnp.float32(time)), device
        )
        return self._fn(camera, effects, t, self._sky_on(device))
