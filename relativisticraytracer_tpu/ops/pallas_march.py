"""The geodesic march as one Pallas kernel on the Triton route (NVIDIA GPU).

The XLA `while` march (render/march.py) runs the frame in lock step: every
ray is stepped until the slowest ray in the FRAME stops (up to the
2000-step cap near the photon sphere), the ray state crosses device memory
every step, and the media noise is evaluated for every ray on every step.
The reference CUDA kernel has none of these costs (16x16 thread blocks,
per-thread `break`, a divergent media branch; src/raymarcher.cu:41-121,
176-180). This kernel gets them back on the card:

  * each program owns a small power-of-two (BLOCK_H, BLOCK_W) block of
    pixels and generates its rays in-kernel from the camera scalars (a
    small input array the program loads itself) and its pixel coordinates
    plus a pixel offset — so a shard of a multi-card frame runs the same
    kernel (parallel/sharding.py);
  * the block's state lives in registers through its own `lax.while_loop`,
    which exits when every ray of the block is captured or escaped;
  * media shading sits under the block-wide `lax.cond` of
    `march_step(media_cond=True)`, so a block pays for the noise only when
    one of its rays may be lit. With one warp per block this is the
    reference's warp-level divergence.

The body is the SAME `march_step` the XLA path runs. The sky gather, post
FX and pack stay in XLA around the kernel (render/pipeline.frame_epilogue).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from relativisticraytracer_tpu.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu.core.utils import largest_divisor_at_most
from relativisticraytracer_tpu.core.vecmath import Vec3
from relativisticraytracer_tpu.render.camera import pixel_grid, primary_rays
from relativisticraytracer_tpu.render.march import (
    MarchState,
    block_any,
    init_state,
    march_step,
)

# Pixels per program (powers of two, as Triton requires) and warps per
# program: one ray per thread. Chosen by the block/warp/unroll sweep on
# the H100 (PERF.md "Block sweep"; tools/sweep_march.py).
BLOCK_H = 8
BLOCK_W = 8
NUM_WARPS = 2
# March steps per while-loop trip. Finished rays are masked no-ops, so
# overshooting the all-done point by fewer than UNROLL steps is exact.
# Snapped to a divisor of the step cap. Unrolling bought no speed on the
# card and doubles Triton's compile time per step of unroll.
UNROLL = 1

# Camera ABI: [time, pos(3), forward(3), right(3), up(3), use_lens_distortion,
# distortion_amount, x0, y0], padded to a power of two for Triton.
_N_SCALARS = 17
_SCALARS_PADDED = 32


def camera_scalars(camera, effects: CameraEffects, time,
                   offset=(0.0, 0.0)) -> jnp.ndarray:
    """Pack the kernel's scalar inputs (see the ABI above) into one f32
    array. `offset` is the (x0, y0) pixel of the launch's top-left ray in
    the full image; traced scalars are fine."""
    parts = [
        jnp.asarray(time, jnp.float32).reshape(1),
        jnp.asarray(camera.pos, jnp.float32).reshape(3),
        jnp.asarray(camera.forward, jnp.float32).reshape(3),
        jnp.asarray(camera.right, jnp.float32).reshape(3),
        jnp.asarray(camera.up, jnp.float32).reshape(3),
        jnp.asarray(effects.use_lens_distortion, jnp.float32).reshape(1),
        jnp.asarray(effects.distortion_amount, jnp.float32).reshape(1),
        jnp.asarray(offset[0], jnp.float32).reshape(1),
        jnp.asarray(offset[1], jnp.float32).reshape(1),
    ]
    scal = jnp.concatenate(parts)
    return jnp.pad(scal, (0, _SCALARS_PADDED - _N_SCALARS))


def _march_kernel(scene: SceneConfig, max_steps: int, unroll: int,
                  img_w: int, img_h: int, block_h: int, block_w: int,
                  scal_ref, ix_ref, iy_ref, iz_ref, tr_ref, hit_ref,
                  vx_ref, vy_ref, vz_ref):
    s = [scal_ref[k] for k in range(_N_SCALARS)]
    t = s[0]
    cam_pos = s[1:4]
    x0, y0 = s[15], s[16]

    shape = (block_h, block_w)
    row = pl.program_id(0) * block_h + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    col = pl.program_id(1) * block_w + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    px = col.astype(jnp.float32) + x0
    py = row.astype(jnp.float32) + y0
    rd, _, _ = primary_rays(px, py, img_w, img_h, s[4:7], s[7:10], s[10:13],
                            s[13], s[14])
    zeros = jnp.zeros(shape, jnp.float32)
    state = init_state(
        Vec3(zeros + cam_pos[0], zeros + cam_pos[1], zeros + cam_pos[2]), rd)

    def cond(carry):
        i, st = carry
        return jnp.logical_and(i < max_steps, block_any(st.active))

    def body(carry):
        i, st = carry
        for _ in range(unroll):
            st = march_step(scene, st, t, media_cond=True)
        return i + unroll, st

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    ix_ref[...] = st.intensity.x
    iy_ref[...] = st.intensity.y
    iz_ref[...] = st.intensity.z
    tr_ref[...] = st.transmittance
    hit_ref[...] = st.hit_horizon.astype(jnp.float32)
    vx_ref[...] = st.v.x
    vy_ref[...] = st.v.y
    vz_ref[...] = st.v.z


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.partial(
    jax.jit,
    static_argnames=(
        "scene", "width", "height", "max_steps", "image", "block",
        "num_warps", "unroll", "interpret",
    ),
)
def march_pallas(
    scene: SceneConfig,
    camera,
    effects: CameraEffects,
    time,
    width: int,
    height: int,
    max_steps: int,
    offset=(0.0, 0.0),
    image: Optional[Tuple[int, int]] = None,
    block: Tuple[int, int] = (BLOCK_H, BLOCK_W),
    num_warps: int = NUM_WARPS,
    unroll: int = UNROLL,
    interpret: bool = False,
) -> MarchState:
    """March the (height, width) tile whose top-left pixel is `offset` of
    an `image` = (img_w, img_h) frame (default: the tile is the frame).

    Returns the final MarchState of each ray as (height, width) planes;
    `p` and `active` are not written back (None). `interpret=True` runs
    the Pallas interpreter — for tests on a machine without a GPU."""
    img_w, img_h = image if image is not None else (width, height)
    block_h, block_w = block
    for b in block:
        if b < 1 or b & (b - 1):
            raise ValueError(f"block dims must be powers of two, got {block}")
    hp, wp = _round_up(height, block_h), _round_up(width, block_w)
    unroll = largest_divisor_at_most(max_steps, unroll)
    kernel = functools.partial(
        _march_kernel, scene, max_steps, unroll, img_w, img_h,
        block_h, block_w,
    )
    plane = pl.BlockSpec((block_h, block_w), lambda i, j: (i, j))
    outs = pl.pallas_call(
        kernel,
        grid=(hp // block_h, wp // block_w),
        in_specs=[pl.BlockSpec((_SCALARS_PADDED,), lambda i, j: (0,))],
        out_specs=[plane] * 8,
        out_shape=[jax.ShapeDtypeStruct((hp, wp), jnp.float32)] * 8,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="rrt_march",
    )(camera_scalars(camera, effects, time, offset))
    ix, iy, iz, tr, hit, vx, vy, vz = [o[:height, :width] for o in outs]
    return MarchState(
        p=None, v=Vec3(vx, vy, vz), intensity=Vec3(ix, iy, iz),
        transmittance=tr, hit_horizon=hit > 0.5, active=None,
    )


def render_tile_pallas(
    scene: SceneConfig,
    settings: RenderSettings,
    camera,
    effects: CameraEffects,
    time,
    sky,
    tile: Optional[Tuple[int, int]] = None,
    offset=(0, 0),
    interpret: bool = False,
    **kernel_kw,
) -> jnp.ndarray:
    """`render/pipeline.render_tile` with the march in the GPU kernel:
    uint8 RGBA of the (tile_w, tile_h) tile (supersampled pixels) at
    `offset` of the settings' frame (default: the whole frame,
    uint8[height, width, 4]). `kernel_kw` passes block, num_warps
    and unroll through to `march_pallas` (for sweeps)."""
    from relativisticraytracer_tpu.render.pipeline import frame_epilogue

    ss = settings.supersample
    img = (settings.width * ss, settings.height * ss)
    tw, th = tile if tile is not None else img
    state = march_pallas(
        scene, camera, effects, jnp.asarray(time, jnp.float32), tw, th,
        settings.resolved_max_steps(scene), offset=offset, image=img,
        interpret=interpret, **kernel_kw,
    )
    px, py = pixel_grid(tw, th, offset)
    _, uv_x, uv_y = primary_rays(
        px, py, img[0], img[1], camera.forward, camera.right, camera.up,
        effects.use_lens_distortion, effects.distortion_amount,
    )
    return frame_epilogue(scene, effects, sky, state, uv_x, uv_y, ss)

