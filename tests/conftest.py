"""Test harness config: the CPU backend with 8 virtual devices, so the
sharding tests exercise a multi-card mesh on any machine, and the GPU
kernel runs in the Pallas interpreter where a test asks for it explicitly.

    JAX_PLATFORMS=cpu python -m pytest tests/ -m 'not slow'   # fast tier

The platform is also forced through the config flag after import, which
wins over any installed accelerator plugin (XLA_FLAGS must still be set
before the first backend init). Tests that need a real NVIDIA GPU take the
`gpu_device` fixture and carry the `gpu` marker: they skip here, and
`python chip_smoke.py` runs the same checks on the card."""

import os
import tempfile

# Keep tests hermetic: the CLI enables a persistent compilation cache by
# default (relativisticraytracer_tpu/compile_cache.py).
os.environ.setdefault("RRT_COMPILE_CACHE", "0")
# Auto-named recordings (an R-toggle in a Session test) go to a temp dir,
# never the source tree.
os.environ.setdefault(
    "RRT_RECORDING_DIR", tempfile.mkdtemp(prefix="rrt_recordings_")
)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU, or a skip. Decided here, at run time, never
    at import: every xdist worker must collect the same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return gpus[0]
