"""Config knobs must fail loudly, not silently degrade: a loop typo used
to surface only at trace time, noise_octave_cap <= 0 silently erased the
disk/cloud structure, odd dims with yuv420p crashed mid-run after
destructive sink setup, and loop="pallas" off a GPU used to fall back to
the Pallas interpreter."""

import pytest

from relativisticraytracer_tpu import config
from relativisticraytracer_tpu.config import RenderSettings, SceneConfig


def test_loop_typo_rejected():
    with pytest.raises(ValueError, match="loop"):
        RenderSettings(loop="whlie")
    for loop in ("auto", "scan", "while", "pallas"):
        RenderSettings(loop=loop)


def test_auto_loop_is_the_kernel_on_a_gpu(monkeypatch):
    monkeypatch.setattr(config, "_platform", lambda: "gpu")
    assert RenderSettings().resolved_loop() == "pallas"
    assert RenderSettings(loop="pallas").resolved_loop() == "pallas"
    assert RenderSettings(loop="while").resolved_loop() == "while"


def test_auto_loop_is_while_on_the_cpu():
    assert config._platform() == "cpu"
    assert RenderSettings().resolved_loop() == "while"
    assert RenderSettings(loop="scan").resolved_loop() == "scan"


def test_pallas_loop_raises_without_a_gpu():
    with pytest.raises(ValueError, match="GPU"):
        RenderSettings(loop="pallas").resolved_loop()


def test_octave_cap_validated_at_the_source():
    """The >=1 guard must live on SceneConfig itself, not only in the CLI
    (__main__._positive_int) — a library caller passing 0 used to get a
    silently noiseless render."""
    with pytest.raises(ValueError, match="noise_octave_cap"):
        SceneConfig(noise_octave_cap=0)
    assert SceneConfig(noise_octave_cap=1).octaves(5) == 1
    assert SceneConfig().octaves(5) == 5


def test_yuv420_recorder_rejects_odd_dims():
    """Both recorders route through io.video._frame_bytes: odd dims with
    yuv420p must fail at CONSTRUCTION, before any sink opens or stale
    segments are cleaned up."""
    from relativisticraytracer_tpu.io.video import (
        SegmentedRecorder,
        VideoRecorder,
    )

    for cls in (VideoRecorder, SegmentedRecorder):
        with pytest.raises(ValueError, match="even"):
            cls(333, 272, pix_fmt="yuv420p")
        cls(332, 272, pix_fmt="yuv420p")   # even dims fine
        cls(333, 271, pix_fmt="rgba")      # rgba has no parity constraint
