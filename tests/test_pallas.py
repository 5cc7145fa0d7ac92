"""The Pallas-Triton march kernel (ops/pallas_march.py) against the XLA
`while` march.

The kernel body IS render/march.march_step and its ray generation IS
render/camera.primary_rays, so on the CPU (Pallas interpreter, passed
explicitly) the uint8 frames are bitwise equal. On the card the two
differ only by libdevice vs XLA transcendentals and FMA contraction
(PERF.md parity table; `gpu`-marked tests below, and chip_smoke.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from relativisticraytracer_tpu.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu.ops.pallas_march import (
    march_pallas,
    render_tile_pallas,
)
from relativisticraytracer_tpu.render.camera import camera_state_from_pose
from relativisticraytracer_tpu.render.pipeline import render_frame, render_tile
from relativisticraytracer_tpu.render.skybox import skybox_from_array
from tests.kernel_cases import POSE, SKY, kernel_and_while_frames

@pytest.mark.parametrize("name", ["vacuum", "kerr09", "disk_only", "full_fx"])
def test_kernel_frame_equals_while(name):
    got, want, (h, w) = kernel_and_while_frames(name, block=(8, 16))
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_kernel_block_shape_does_not_change_the_frame():
    """A block that cuts the frame differently (4x8 rays, 2 steps per loop
    trip) gives the same frame: exits and media conds are exact."""
    a, _, _ = kernel_and_while_frames("disk_only", block=(8, 16))
    b, _, _ = kernel_and_while_frames("disk_only", block=(4, 8), unroll=2)
    np.testing.assert_array_equal(a, b)


def test_kernel_rejects_non_power_of_two_blocks():
    with pytest.raises(ValueError, match="powers of two"):
        kernel_and_while_frames("vacuum", block=(6, 8))


def test_march_pallas_pads_then_crops():
    """The padded grid (blocks past the frame edge) is cropped away: every
    output plane has the requested (height, width)."""
    scene = SceneConfig(max_steps=8)
    cam = camera_state_from_pose(*POSE)
    out = jax.eval_shape(
        lambda t: march_pallas(scene, cam, CameraEffects(), t, 37, 13, 8,
                               block=(8, 16), interpret=True),
        jnp.float32(0.0))
    for plane in (out.intensity.x, out.transmittance, out.hit_horizon,
                  out.v.z):
        assert plane.shape == (13, 37)
    assert out.hit_horizon.dtype == jnp.bool_
    assert out.p is None and out.active is None


def test_kernel_lowers_to_triton_for_cuda():
    """The whole kernel (full scene: noise, media conds, while exit) lowers
    through Pallas's Triton route for CUDA — checked on any machine, so an
    op without a Triton lowering fails here, not on the card."""
    scene = SceneConfig(max_steps=16)
    cam = camera_state_from_pose(*POSE)
    eff = CameraEffects()
    fn = jax.jit(lambda c, t: march_pallas(scene, c, eff, t, 64, 32, 16))
    text = fn.trace(cam, jnp.float32(1.0)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "rrt_march"' in text


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu_device):
    """On the card: kernel vs XLA within the parity budget (the two differ
    by libdevice vs XLA transcendentals and FMA contraction)."""
    scene = SceneConfig(max_steps=400)
    cam = camera_state_from_pose(*POSE)
    sky = skybox_from_array(SKY)
    eff = CameraEffects()
    ker = np.asarray(render_tile(
        scene, RenderSettings(width=192, height=108, max_steps=400,
                              loop="pallas"), cam, eff, 1.5, sky))
    xla = np.asarray(render_tile(
        scene, RenderSettings(width=192, height=108, max_steps=400,
                              loop="while"), cam, eff, 1.5, sky))
    diff = ker[..., :3].astype(int) - xla[..., :3].astype(int)
    assert np.sqrt(np.mean((diff / 255.0) ** 2)) < 1e-3


@pytest.mark.slow
def test_kernel_frame_equals_while_at_larger_size():
    """100x70 Kerr full scene, 96 steps: many blocks, a ragged edge in
    both directions, the default block shape."""
    scene = SceneConfig(max_steps=96, spin_a=0.9)
    settings = RenderSettings(width=100, height=70, max_steps=96,
                              loop="while")
    sky = skybox_from_array(SKY)
    cam = camera_state_from_pose(*POSE)
    eff = CameraEffects(use_chromatic_aberration=1.0)
    got = np.asarray(render_tile_pallas(scene, settings, cam, eff, 0.5,
                                         sky, interpret=True))
    want = np.asarray(render_frame(scene, settings, cam, eff, 0.5, sky))
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_kernel_path_traces_under_outer_jit():
    """The Renderer wraps the kernel path in an outer jit: everything that
    sizes the kernel (padding, grid) must stay static under tracing."""
    import functools

    scene = SceneConfig(max_steps=8)
    settings = RenderSettings(width=64, height=32, max_steps=8, loop="while")
    fn = jax.jit(functools.partial(render_tile_pallas, scene, settings,
                                   interpret=True))
    out = jax.eval_shape(fn, camera_state_from_pose(*POSE), CameraEffects(),
                         jnp.float32(1.0), skybox_from_array(SKY))
    assert out.shape == (32, 64, 4) and out.dtype == jnp.uint8


def test_offset_tile_equals_crop():
    """A tile at a pixel offset (what each card of a sharded frame runs)
    is bitwise the matching crop of the whole frame, through the kernel
    and through the XLA path."""
    scene = SceneConfig(max_steps=32, enable_clouds=False)
    settings = RenderSettings(width=48, height=24, max_steps=32,
                              loop="while")
    sky = skybox_from_array(SKY)
    cam = camera_state_from_pose(*POSE)
    eff = CameraEffects()
    full = np.asarray(render_frame(scene, settings, cam, eff, 1.0, sky))
    x0, y0, tw, th = 16, 8, 32, 16
    crop = full[y0:y0 + th, x0:x0 + tw]
    tile_k = np.asarray(render_tile_pallas(
        scene, settings, cam, eff, 1.0, sky, tile=(tw, th),
        offset=(jnp.float32(x0), jnp.float32(y0)), interpret=True,
        block=(8, 16)))
    tile_x = np.asarray(render_tile(scene, settings, cam, eff, 1.0, sky,
                                    tile=(tw, th), offset=(x0, y0)))
    np.testing.assert_array_equal(tile_x, crop)
    np.testing.assert_array_equal(tile_k, crop)
