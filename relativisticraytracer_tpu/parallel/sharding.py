"""Multi-card image-tile rendering over a `jax.sharding.Mesh`.

The reference's only parallelism is the per-pixel CUDA thread grid
(reference: src/raymarcher.cu:176-180). Across cards the frame is split
into output tiles: it is sharded over a 2-D device mesh ('ty' rows x 'tx'
cols) with `shard_map`; every ray is independent, so the frame program runs
with ZERO collectives — the only cross-device traffic is the gather of
finished tiles (the analog of the reference's glReadPixels, main.cpp:89).

Each device renders its tile with the single-card frame program
(render/pipeline.render_tile): rays generated from the camera and the
tile's global pixel offset, the march (GPU kernel or XLA loop, as
`settings.resolved_loop()` says), sky, post FX and pack. A tile is bitwise
the matching crop of the single-card frame (tests/test_sharding.py).

The march's early exit runs per device, so each card stops as soon as ITS
tile is finished. The frame time is the max over shards; the photon ring
at the image centre makes the central tiles the slowest.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from relativisticraytracer_tpu.config import CameraEffects, RenderSettings, SceneConfig
from relativisticraytracer_tpu.render.camera import CameraState
from relativisticraytracer_tpu.render.pipeline import render_tile
from relativisticraytracer_tpu.render.skybox import Skybox

AXIS_ROWS = "ty"
AXIS_COLS = "tx"


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square (rows, cols) factorization of n."""
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """Build a ('ty', 'tx') tile mesh over the given devices (default: all).
    The cards of one host reach each other all to all, so the shape follows
    the image (most-square by default), not a physical topology."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = _factor2(len(devices))
    ny, nx = shape
    if ny * nx != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(np.asarray(devices).reshape(ny, nx), (AXIS_ROWS, AXIS_COLS))


def render_frame_sharded(
    scene: SceneConfig,
    settings: RenderSettings,
    mesh: Mesh,
    camera: CameraState,
    effects: CameraEffects,
    time,
    sky: Optional[Skybox],
    interpret: bool = False,
) -> jnp.ndarray:
    """Render one frame with the image tiled over `mesh`.

    Height/width must divide by the mesh rows/cols. Returns the sharded
    uint8[H, W, 4] frame; tiled == untiled bit-for-bit (tested).
    `interpret=True` runs the GPU kernel in the Pallas interpreter (tests
    on a machine without a GPU, with the kernel path chosen explicitly)."""
    ny, nx = mesh.devices.shape
    if settings.height % ny or settings.width % nx:
        raise ValueError(
            f"image {settings.height}x{settings.width} not divisible by mesh {ny}x{nx}"
        )
    ss = settings.supersample
    tw, th = settings.width * ss // nx, settings.height * ss // ny

    def tile_fn(camera, effects, time, sky):
        offset = (
            (jax.lax.axis_index(AXIS_COLS) * tw).astype(jnp.float32),
            (jax.lax.axis_index(AXIS_ROWS) * th).astype(jnp.float32),
        )
        if interpret:
            from relativisticraytracer_tpu.ops.pallas_march import (
                render_tile_pallas,
            )

            return render_tile_pallas(scene, settings, camera, effects, time,
                                      sky, tile=(tw, th), offset=offset,
                                      interpret=True)
        return render_tile(scene, settings, camera, effects, time, sky,
                           tile=(tw, th), offset=offset)

    sharded = jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(AXIS_ROWS, AXIS_COLS, None),
        # pallas_call outputs carry no varying-mesh-axis metadata; every
        # tile is purely local, so the check adds nothing here.
        check_vma=False,
    )
    return sharded(camera, effects, time, sky)


def make_sharded_renderer(
    scene: SceneConfig,
    settings: RenderSettings,
    mesh: Mesh,
):
    """jit-compiled sharded frame function (camera, effects, time, sky) ->
    uint8[H, W, 4], sharded over `mesh`."""

    def fn(camera, effects, time, sky):
        return render_frame_sharded(scene, settings, mesh, camera, effects,
                                    time, sky)

    return jax.jit(fn)
