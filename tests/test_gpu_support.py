"""The pieces around the GPU kernel that run anywhere: the compile-cache
location, the kernel's scalar ABI and block reduction, and chip_smoke.py's
refusal to report success off a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from relativisticraytracer_tpu import compile_cache
from relativisticraytracer_tpu.config import CameraEffects
from relativisticraytracer_tpu.ops.pallas_march import camera_scalars
from relativisticraytracer_tpu.render.camera import camera_state_from_pose
from relativisticraytracer_tpu.render.march import block_any

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_cache_dir_honours_jax_compilation_cache_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("RRT_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_a_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("RRT_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = pathlib.Path(compile_cache.cache_dir())
    assert path == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_cache_can_be_turned_off(monkeypatch, tmp_path):
    monkeypatch.setenv("RRT_COMPILE_CACHE", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() is None
    assert compile_cache.enable_compile_cache() is None


def test_enable_sets_the_default_dir_only_without_the_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR unset, the fixed directory goes into
    JAX's config; with it set, JAX's own reading of it stands."""
    import jax

    updates = {}
    monkeypatch.delenv("RRT_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.enable_compile_cache() == str(REPO / ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == str(REPO / ".jax_cache")
    updates.clear()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert "jax_compilation_cache_dir" not in updates


def test_camera_scalars_layout():
    cam = camera_state_from_pose((1.0, 2.0, 3.0), 10.0, -5.0)
    eff = CameraEffects(use_lens_distortion=1.0, distortion_amount=0.25)
    s = np.asarray(camera_scalars(cam, eff, 4.5, offset=(96, 32)))
    assert s.shape == (32,) and s.dtype == np.float32  # a power of two
    assert s[0] == 4.5
    np.testing.assert_array_equal(s[1:4], np.asarray(cam.pos))
    np.testing.assert_array_equal(s[4:7], np.asarray(cam.forward))
    np.testing.assert_array_equal(s[7:10], np.asarray(cam.right))
    np.testing.assert_array_equal(s[10:13], np.asarray(cam.up))
    assert (s[13], s[14], s[15], s[16]) == (1.0, 0.25, 96.0, 32.0)
    assert not s[17:].any()


@pytest.mark.parametrize("mask", [[[False, False], [False, False]],
                                  [[False, False], [False, True]],
                                  [[True, True], [True, True]]])
def test_block_any_matches_any(mask):
    m = jnp.asarray(mask)
    assert bool(block_any(m)) == bool(jnp.any(m))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", RRT_COMPILE_CACHE="0")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "not 'gpu'" in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
