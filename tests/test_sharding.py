"""Multi-card tiling: sharded render must equal single-device render
bit-for-bit (SURVEY.md §4: 'a multi-chip tile-split render is tested by
asserting tiled == untiled'). Runs on 8 virtual CPU devices (conftest)."""

import numpy as np
import pytest

import jax

from relativisticraytracer_tpu.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu.parallel.sharding import (
    make_mesh,
    make_sharded_renderer,
    render_frame_sharded,
)
from relativisticraytracer_tpu.render.camera import camera_state_from_pose
from relativisticraytracer_tpu.render.pipeline import render_frame
from relativisticraytracer_tpu.render.skybox import procedural_starfield, skybox_from_array

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices"
)


def _setup(w=64, h=48, steps=120):
    scene = SceneConfig(max_steps=steps)
    settings = RenderSettings(width=w, height=h, max_steps=steps, loop="while")
    sky = skybox_from_array(procedural_starfield(32, 64))
    cam = camera_state_from_pose((0.0, 5.0, -38.0), 0.0, -6.0)
    eff = CameraEffects()
    return scene, settings, sky, cam, eff


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_tiled_equals_untiled(shape):
    scene, settings, sky, cam, eff = _setup()
    mesh = make_mesh(shape=shape)
    tiled = np.asarray(
        render_frame_sharded(scene, settings, mesh, cam, eff, 1.0, sky)
    )
    untiled = np.asarray(render_frame(scene, settings, cam, eff, 1.0, sky))
    np.testing.assert_array_equal(tiled, untiled)


@pytest.mark.slow
def test_jitted_sharded_renderer():
    scene, settings, sky, cam, eff = _setup()
    mesh = make_mesh(shape=(4, 2))
    fn = make_sharded_renderer(scene, settings, mesh)
    out = fn(cam, eff, 1.0, sky)
    assert out.shape == (48, 64, 4)
    # output is actually sharded over the mesh
    assert len(out.sharding.device_set) == 8
    untiled = np.asarray(render_frame(scene, settings, cam, eff, 1.0, sky))
    np.testing.assert_array_equal(np.asarray(out), untiled)


def test_indivisible_image_rejected():
    scene, settings, sky, cam, eff = _setup(w=63, h=48)
    mesh = make_mesh(shape=(4, 2))
    with pytest.raises(ValueError):
        render_frame_sharded(scene, settings, mesh, cam, eff, 0.0, sky)


def test_mesh_factorization():
    m = make_mesh(shape=None)
    assert m.devices.size == len(jax.devices())
    ny, nx = m.devices.shape
    assert ny * nx == m.devices.size


@pytest.mark.slow
def test_sharded_pallas_matches_unsharded():
    """Multi-card + kernel: each device runs the march kernel (interpreted
    here) on its tile at its pixel offset; the result must equal the
    single-device kernel frame and the XLA frame bit for bit."""
    from relativisticraytracer_tpu.ops.pallas_march import render_tile_pallas

    scene, settings, sky, cam, eff = _setup(w=128, h=64, steps=48)
    mesh = make_mesh(devices=jax.devices()[:4], shape=(2, 2))
    tiled = np.asarray(render_frame_sharded(
        scene, settings, mesh, cam, eff, 1.0, sky, interpret=True))
    untiled = np.asarray(render_tile_pallas(
        scene, settings, cam, eff, 1.0, sky, interpret=True))
    np.testing.assert_array_equal(tiled, untiled)
    np.testing.assert_array_equal(
        tiled, np.asarray(render_frame(scene, settings, cam, eff, 1.0, sky)))


@pytest.mark.slow
def test_sharded_supersample_matches_unsharded():
    scene, _, sky, cam, eff = _setup(w=64, h=48, steps=32)
    settings = RenderSettings(width=64, height=48, max_steps=32,
                              loop="while", supersample=2)
    mesh = make_mesh(shape=(4, 2))
    tiled = np.asarray(
        render_frame_sharded(scene, settings, mesh, cam, eff, 1.0, sky)
    )
    untiled = np.asarray(render_frame(scene, settings, cam, eff, 1.0, sky))
    assert tiled.shape == (48, 64, 4)
    np.testing.assert_array_equal(tiled, untiled)


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["xla_while", "kernel"])
def test_small_sharded_frame_equals_untiled(interpret):
    """2x2 mesh, tiny frame: the per-shard pixel offsets (each card
    generates its own rays) reproduce the one-device frame exactly, on
    the XLA path and through the kernel."""
    scene, settings, sky, cam, eff = _setup(w=16, h=8, steps=8)
    mesh = make_mesh(devices=jax.devices()[:4], shape=(2, 2))
    tiled = np.asarray(render_frame_sharded(
        scene, settings, mesh, cam, eff, 1.0, sky, interpret=interpret))
    untiled = np.asarray(render_frame(scene, settings, cam, eff, 1.0, sky))
    np.testing.assert_array_equal(tiled, untiled)


def test_sharded_pallas_loop_raises_without_gpu():
    scene, _, sky, cam, eff = _setup(w=16, h=8, steps=8)
    settings = RenderSettings(width=16, height=8, max_steps=8, loop="pallas")
    mesh = make_mesh(devices=jax.devices()[:4], shape=(2, 2))
    with pytest.raises(ValueError, match="GPU"):
        render_frame_sharded(scene, settings, mesh, cam, eff, 1.0, sky)
