"""End-to-end frame parity and golden-image regression.

Config ladder from BASELINE.json:
  1. Schwarzschild lensed-skybox still (CPU-runnable)   -> oracle + golden
  2. Kerr a=0.9 shadow/photon ring                      -> golden
  3. volumetric disk                                    -> golden
  4. full scene + post FX                               -> golden
"""

import pathlib

import numpy as np
import pytest

import jax

from relativisticraytracer_tpu.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
    effects_off,
)
from relativisticraytracer_tpu.render.camera import camera_state_from_pose
from relativisticraytracer_tpu.render.pipeline import Renderer
from relativisticraytracer_tpu.render.skybox import procedural_starfield
from tests.oracle import numpy_ref as oracle

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"

F = np.float32


def _tex_bilinear(img, tx, ty):
    h, w, _ = img.shape
    x = (F(tx) - np.floor(F(tx))) * w
    y = min(max(F(ty), 0.0), 1.0) * h
    xb, yb = x - 0.5, y - 0.5
    x0, y0 = int(np.floor(xb)), int(np.floor(yb))
    fx, fy = F(xb - x0), F(yb - y0)
    x0i, x1i = x0 % w, (x0 + 1) % w
    y0i, y1i = min(max(y0, 0), h - 1), min(max(y0 + 1, 0), h - 1)
    out = np.zeros(3, dtype=np.float32)
    for c in range(3):
        t00 = F(img[y0i, x0i, c]) / F(255.0)
        t10 = F(img[y0i, x1i, c]) / F(255.0)
        t01 = F(img[y1i, x0i, c]) / F(255.0)
        t11 = F(img[y1i, x1i, c]) / F(255.0)
        top = t00 + fx * (t10 - t00)
        bot = t01 + fx * (t11 - t01)
        out[c] = top + fy * (bot - top)
    return out


def _oracle_frame(width, height, pose, t, sky_img, max_steps,
                  enable_disk, enable_clouds, effects_on):
    """Scalar reference render (raymarcher.cu:15-173), top-down rows."""
    pos, fwd, right, up = oracle.camera_basis(*pose)
    frame = np.zeros((height, width, 4), dtype=np.uint8)
    frame[..., 3] = 255
    for y in range(height):
        for x in range(width):
            _, rd, uv = oracle.gen_ray(
                x, y, width, height, pos, fwd, right, up,
                use_lens_distortion=effects_on, distortion_amount=0.15,
            )
            p, v, inten, trans, hit, _ = oracle.march_ray(
                pos, rd, t, max_steps,
                enable_disk=enable_disk, enable_clouds=enable_clouds,
            )
            bg = np.zeros(3, dtype=np.float32)
            if not hit:
                d = oracle.normalize(v)
                phi = F(np.arctan2(d[2], d[0]))
                theta = F(np.arcsin(np.clip(d[1], -1, 1)))
                tx = F(0.5) + phi / (F(2.0) * oracle.PI)
                ty = F(0.5) - theta / oracle.PI
                bg = _tex_bilinear(sky_img, tx, ty)
            hdr = (inten + bg * trans).astype(np.float32)
            if effects_on:
                bloom = oracle.get_bloom_contribution(hdr, 0.8)
                hdr = (hdr + bloom * F(0.5)).astype(np.float32)
                hdr = oracle.apply_vignette(hdr, uv, 0.4)
            ldr = oracle.tonemap(hdr)
            frame[y, x, :3] = (np.clip(ldr, 0, 1) * 255).astype(np.uint8)
    return frame


@pytest.fixture(scope="module")
def sky_small():
    return procedural_starfield(64, 128)


@pytest.mark.slow
def test_full_frame_matches_oracle_vacuum(sky_small):
    """BASELINE config 1 shape: Schwarzschild, skybox only, no media, no FX."""
    w, h, steps = 16, 12, 400
    scene = SceneConfig(enable_disk=False, enable_clouds=False, max_steps=steps)
    settings = RenderSettings(width=w, height=h, max_steps=steps, loop="while")
    r = Renderer(scene, settings, skybox_rgba=sky_small)
    got = r.render_np(
        camera_state_from_pose((0.0, 4.0, -35.0), 0.0, -5.0),
        effects=effects_off(),
        time=0.0,
    )
    want = _oracle_frame(
        w, h, ((0.0, 4.0, -35.0), 0.0, -5.0), 0.0, sky_small, steps,
        enable_disk=False, enable_clouds=False, effects_on=False,
    )
    diff = got[..., :3].astype(int) - want[..., :3].astype(int)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 1e-3, f"RMSE {rmse}"
    assert np.max(np.abs(diff)) <= 2


@pytest.mark.slow
def test_full_frame_matches_oracle_full_scene(sky_small):
    """Full scene: disk + clouds + skybox + bloom/vignette/distortion."""
    w, h, steps = 12, 9, 500
    scene = SceneConfig(max_steps=steps)
    settings = RenderSettings(width=w, height=h, max_steps=steps, loop="while")
    r = Renderer(scene, settings, skybox_rgba=sky_small)
    pose = ((0.0, 6.0, -40.0), 0.0, -8.0)
    got = r.render_np(camera_state_from_pose(*pose), effects=CameraEffects(), time=1.5)
    want = _oracle_frame(
        w, h, pose, 1.5, sky_small, steps,
        enable_disk=True, enable_clouds=True, effects_on=True,
    )
    diff = got[..., :3].astype(int) - want[..., :3].astype(int)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 2e-3, f"RMSE {rmse}"


def test_effect_toggles_do_not_retrace(sky_small):
    w, h, steps = 16, 12, 50
    scene = SceneConfig(max_steps=steps)
    settings = RenderSettings(width=w, height=h, max_steps=steps)
    r = Renderer(scene, settings, skybox_rgba=sky_small)
    cam = camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)
    with jax.log_compiles(False):
        a = r.render(cam, CameraEffects(), 0.0)
        n0 = r._fn._cache_size()
        b = r.render(cam, effects_off(), 0.5)
        c = r.render(
            cam, CameraEffects(use_chromatic_aberration=1.0, ca_amount=0.01), 1.0
        )
        n1 = r._fn._cache_size()
    assert n0 == n1, "effect toggle must not retrace"
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


@pytest.mark.parametrize(
    "name,scene_kw,effects_on",
    [
        ("schwarzschild_vacuum", dict(enable_disk=False, enable_clouds=False), False),
        ("kerr09_vacuum", dict(enable_disk=False, enable_clouds=False, spin_a=0.9), False),
        ("disk_only", dict(enable_clouds=False), False),
        ("full_scene_fx", dict(), True),
    ],
)
def test_golden_images(sky_small, name, scene_kw, effects_on):
    """RMSE-gated regression against committed goldens (64x48, 400 steps).
    Regenerate with tools/make_goldens.py after INTENTIONAL changes."""
    golden_path = GOLDEN_DIR / f"{name}.npy"
    if not golden_path.exists():
        pytest.skip(f"golden {name} not generated yet")
    w, h, steps = 64, 48, 400
    scene = SceneConfig(max_steps=steps, **scene_kw)
    settings = RenderSettings(width=w, height=h, max_steps=steps, loop="while")
    r = Renderer(scene, settings, skybox_rgba=sky_small)
    effects = CameraEffects() if effects_on else effects_off()
    got = r.render_np(
        camera_state_from_pose((0.0, 5.0, -38.0), 0.0, -6.0), effects, time=2.0
    )
    want = np.load(golden_path)
    diff = got[..., :3].astype(int) - want[..., :3].astype(int)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 1e-3, f"golden {name}: RMSE {rmse}"


@pytest.mark.slow
def test_supersampling(sky_small):
    """SSAA: 2x renders and box-filters; s=1 is bitwise the default path."""
    scene = SceneConfig(max_steps=40)
    cam = camera_state_from_pose((0.0, 5.0, -38.0), 0.0, -6.0)
    base = Renderer(
        scene, RenderSettings(width=32, height=24, max_steps=40),
        skybox_rgba=sky_small,
    ).render_np(cam, effects_off(), 1.0)
    ss = Renderer(
        scene, RenderSettings(width=32, height=24, max_steps=40, supersample=2),
        skybox_rgba=sky_small,
    ).render_np(cam, effects_off(), 1.0)
    assert ss.shape == base.shape
    # AA result stays close to the aliased render but differs on edges
    diff = np.abs(ss[..., :3].astype(int) - base[..., :3].astype(int))
    assert 0 < diff.mean() < 30


def test_full_frame_matches_oracle_kerr(sky_small):
    """Kerr a=0.9: frame-dragging term exercised through the whole pipeline
    (BASELINE config 2 shape)."""
    w, h, steps = 12, 9, 400
    scene = SceneConfig(spin_a=0.9, enable_disk=False, enable_clouds=False,
                        max_steps=steps)
    settings = RenderSettings(width=w, height=h, max_steps=steps, loop="while")
    r = Renderer(scene, settings, skybox_rgba=sky_small)
    pose = ((0.0, 3.0, -30.0), 0.0, -5.0)
    got = r.render_np(camera_state_from_pose(*pose), effects_off(), time=0.0)

    pos, fwd, right, up = oracle.camera_basis(*pose)
    frame = np.zeros((h, w, 4), dtype=np.uint8)
    for y in range(h):
        for x in range(w):
            _, rd, uv = oracle.gen_ray(x, y, w, h, pos, fwd, right, up)
            p, v, inten, trans, hit, _ = oracle.march_ray(
                pos, rd, 0.0, steps, enable_disk=False, enable_clouds=False,
                spin_a=np.float32(0.9),
            )
            bg = np.zeros(3, dtype=np.float32)
            if not hit:
                d = oracle.normalize(v)
                phi = F(np.arctan2(d[2], d[0]))
                theta = F(np.arcsin(np.clip(d[1], -1, 1)))
                bg = _tex_bilinear(
                    sky_small, F(0.5) + phi / (F(2.0) * oracle.PI),
                    F(0.5) - theta / oracle.PI,
                )
            ldr = oracle.tonemap((inten + bg * trans).astype(np.float32))
            frame[y, x, :3] = (np.clip(ldr, 0, 1) * 255).astype(np.uint8)
    diff = got[..., :3].astype(int) - frame[..., :3].astype(int)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 1e-3, f"RMSE {rmse}"


def test_full_frame_matches_oracle_second_full_scene_pose(sky_small):
    """VERDICT r1 #8: a second full-scene oracle pose — off-axis yaw,
    camera BELOW the disk plane looking up, later sim time (different
    noise phase + Doppler side)."""
    w, h, steps = 12, 9, 500
    scene = SceneConfig(max_steps=steps)
    settings = RenderSettings(width=w, height=h, max_steps=steps, loop="while")
    r = Renderer(scene, settings, skybox_rgba=sky_small)
    pose = ((18.0, -5.0, -32.0), -25.0, 9.0)
    t = 7.25
    got = r.render_np(camera_state_from_pose(*pose), effects=CameraEffects(),
                      time=t)
    want = _oracle_frame(
        w, h, pose, t, sky_small, steps,
        enable_disk=True, enable_clouds=True, effects_on=True,
    )
    diff = got[..., :3].astype(int) - want[..., :3].astype(int)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 2e-3, f"RMSE {rmse}"


def test_explicit_pallas_loop_raises_without_gpu(sky_small):
    """loop='pallas' off a GPU is an error at the first render — no
    fallback to the Pallas interpreter, to another loop, or to the CPU."""
    scene = SceneConfig(max_steps=8, enable_clouds=False)
    cam = camera_state_from_pose((0.0, 5.0, -38.0), 0.0, -6.0)
    with pytest.raises(ValueError, match="GPU"):
        Renderer(scene, RenderSettings(width=16, height=8, loop="pallas"),
                 skybox_rgba=sky_small).render(cam)


def test_settings_max_steps_falls_back_to_scene():
    """RenderSettings.max_steps=None derives the cap from SceneConfig — a
    scene with a reduced budget must not silently render at 2000 steps."""
    scene = SceneConfig(max_steps=8, enable_disk=False, enable_clouds=False)
    assert RenderSettings().resolved_max_steps(scene) == 8
    assert RenderSettings(max_steps=16).resolved_max_steps(scene) == 16
    cam = camera_state_from_pose((0.0, 5.0, -38.0), 0.0, -6.0)
    r8 = Renderer(scene, RenderSettings(width=32, height=16, loop="while"))
    rx = Renderer(SceneConfig(max_steps=2000, enable_disk=False,
                              enable_clouds=False),
                  RenderSettings(width=32, height=16, max_steps=8,
                                 loop="while"))
    np.testing.assert_array_equal(
        r8.render_np(cam, CameraEffects(), 1.0),
        rx.render_np(cam, CameraEffects(), 1.0),
    )
