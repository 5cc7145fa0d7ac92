"""Scene / render configuration.

`SceneConfig` mirrors the reference compile-time constants name-for-name
(reference: include/config.h:6-49) — it is the pixel-parity contract.
It is a frozen, hashable dataclass passed as a *static* argument to jitted
renders (the reference requires a recompile to change the scene; we retrace,
which is the XLA analog and lets every constant fold into the kernel).

`CameraEffects` mirrors the runtime-mutable effects struct
(reference: include/camera_effects/camera_settings.h:4-17). It is a JAX
pytree of scalars so toggling an effect does NOT retrace the frame program.

`RenderSettings` holds shape-affecting quality knobs (resolution, step cap)
that are static by necessity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Window defaults (reference: include/config.h:7-9)
WINDOW_WIDTH = 1000
WINDOW_HEIGHT = 700
RECORDING_FPS = 24

PI = 3.1415926535  # reference: include/math_utils.h:7 (float32 literal)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Physics + scene constants (reference: include/config.h:11-48).

    All values are geometric units (1.0 = M, the black-hole mass) unless
    noted. Defaults reproduce the reference scene (Sagittarius A*).
    """

    # --- physical constants (SI), kept for unit conversions ---
    c_light: float = 299792458.0          # config.h:12
    g_constant: float = 6.67430e-11       # config.h:13
    solar_mass: float = 1.98847e30        # config.h:14

    # --- target object ---
    bh_mass_solar: float = 4.154e6        # config.h:17
    disk_temp_ref: float = 1.5e7          # [K] config.h:18

    # --- Kerr parameters ---
    spin_a: float = 0.0                   # config.h:21 (dimensionless, 0..1)
    spin_axis: Tuple[float, float, float] = (0.0, 1.0, 0.0)  # config.h:22

    # --- geometric units ---
    event_horizon: float = 2.0            # [M] Rs = 2M, config.h:29
    mass_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)   # config.h:30

    # --- disk tuning ---
    isco_radius: float = 10.0             # config.h:33
    disk_out_m: float = 25.0              # config.h:34
    disk_h_m: float = 0.8                 # config.h:35
    disk_luminosity: float = 6.0          # config.h:36
    disk_opacity: float = 0.4             # config.h:37
    exposure: float = 0.8                 # config.h:38

    # --- dust-cloud layer ---
    cloud_h_m: float = 0.5                # config.h:41
    cloud_out_m: float = 25.0             # config.h:42
    cloud_opacity: float = 0.3            # config.h:43
    cloud_luminosity: float = 0.4         # config.h:44

    # --- integration quality ---
    step_size_m: float = 0.3              # config.h:47
    max_steps: int = 2000                 # config.h:48

    # --- escape condition (reference: src/raymarcher.cu:120) ---
    escape_radius: float = 250.0

    # --- feature gates (static: fold entire subsystems out of the program) ---
    enable_disk: bool = True
    enable_clouds: bool = True

    # --- quality knob: cap every fbm/ridge octave count in the media noise
    # stack (None = the reference's exact counts, bitwise reference
    # semantics). A stylized-preview knob: any cap changes the image, and
    # its cost/RMSE trade on the GPU is not measured. ---
    noise_octave_cap: Optional[int] = None

    def __post_init__(self):
        # Validate at the source, not only in the CLI: a cap of 0 would
        # run every fbm/ridge loop for zero iterations — the disk/cloud
        # structure silently vanishes instead of erroring.
        if self.noise_octave_cap is not None and self.noise_octave_cap < 1:
            raise ValueError(
                f"noise_octave_cap must be >= 1 or None, got "
                f"{self.noise_octave_cap}"
            )

    def octaves(self, n: int) -> int:
        """Effective octave count for a reference count of `n`."""
        return n if self.noise_octave_cap is None else min(n, self.noise_octave_cap)

    @property
    def m_unit(self) -> float:
        """Mass in meters, M = G*Mass/c^2 (reference: config.h:26)."""
        return self.g_constant * (self.bh_mass_solar * self.solar_mass) / (
            self.c_light * self.c_light
        )


DEFAULT_SCENE = SceneConfig()

# Kerr a=0.9 variant used by the BASELINE config ladder (BASELINE.json configs[1]).
KERR_SCENE = dataclasses.replace(DEFAULT_SCENE, spin_a=0.9)


def _platform() -> str:
    """JAX's default device platform ("gpu", "cpu", ...)."""
    return jax.devices()[0].platform


def _register_dataclass(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


@dataclasses.dataclass
class CameraEffects:
    """Runtime-togglable post effects (reference: camera_settings.h:4-17).

    A pytree of scalars: flags are 0.0/1.0 floats so toggling at runtime
    re-uses the compiled program (no retrace), matching the reference's
    hotkey toggles (reference: src/main.cpp:286-301).
    """

    use_bloom: jnp.ndarray = None
    bloom_threshold: jnp.ndarray = None
    bloom_intensity: jnp.ndarray = None
    use_vignette: jnp.ndarray = None
    vignette_intensity: jnp.ndarray = None
    use_chromatic_aberration: jnp.ndarray = None
    ca_amount: jnp.ndarray = None
    use_lens_distortion: jnp.ndarray = None
    distortion_amount: jnp.ndarray = None

    def __post_init__(self):
        # Reference defaults (camera_settings.h:5-16).
        defaults = dict(
            use_bloom=1.0,
            bloom_threshold=0.8,
            bloom_intensity=0.5,
            use_vignette=1.0,
            vignette_intensity=0.4,
            use_chromatic_aberration=0.0,
            ca_amount=0.005,
            use_lens_distortion=1.0,
            distortion_amount=0.15,
        )
        for name, default in defaults.items():
            value = getattr(self, name)
            if value is None:
                value = default
            # Leave non-array leaves alone: pytree unflattening also builds
            # this class from placeholders (e.g. `jit(...).lower`'s ArgInfo).
            if isinstance(value, (int, float, np.ndarray, np.generic, jax.Array)):
                value = jnp.asarray(value, dtype=jnp.float32)
            object.__setattr__(self, name, value)

    def replace(self, **kwargs) -> "CameraEffects":
        return dataclasses.replace(self, **kwargs)


_register_dataclass(
    CameraEffects,
    data_fields=[f.name for f in dataclasses.fields(CameraEffects)],
    meta_fields=[],
)


def effects_off() -> CameraEffects:
    """All post effects disabled (BASELINE configs 1-4 before the animation)."""
    return CameraEffects(
        use_bloom=0.0,
        use_vignette=0.0,
        use_chromatic_aberration=0.0,
        use_lens_distortion=0.0,
    )


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static, shape-affecting render quality knobs."""

    width: int = WINDOW_WIDTH
    height: int = WINDOW_HEIGHT
    # Step-cap override. None (default) = use the scene's max_steps
    # (config.h:48) — one source of truth; setting BOTH SceneConfig and
    # RenderSettings used to be required and silently diverged otherwise.
    max_steps: Optional[int] = None
    # March loop strategy: "auto" (the GPU kernel on a GPU, while
    # elsewhere), "scan" (fixed trip count, differentiable-friendly),
    # "while" (chunked scan + all-rays-done early exit), or "pallas" (the
    # fused Pallas-Triton march kernel with per-block early exit,
    # ops/pallas_march.py; GPU only).
    loop: str = "auto"
    chunk: int = 64                # steps per chunk for loop="while"
    # Supersampling AA factor (beyond the reference, which renders 1 ray per
    # pixel): rays are traced on an (s*H, s*W) grid and box-filtered after
    # tone mapping. 1 = reference behavior.
    supersample: int = 1

    def __post_init__(self):
        # A typo would otherwise surface only at trace time, deep inside
        # the march, as "unknown loop strategy".
        if self.loop not in ("auto", "scan", "while", "pallas"):
            raise ValueError(
                f"loop must be 'auto', 'scan', 'while' or 'pallas', got "
                f"{self.loop!r}"
            )

    def resolved_loop(self) -> str:
        """The march strategy this process runs. "pallas" needs a GPU:
        anywhere else it raises instead of falling back to the
        interpreter or another loop."""
        platform = _platform()
        if self.loop == "pallas" and platform != "gpu":
            raise ValueError(
                f"loop='pallas' is the GPU march kernel, but JAX's backend "
                f"here is {platform!r}; use loop='while' (or 'auto')"
            )
        if self.loop != "auto":
            return self.loop
        return "pallas" if platform == "gpu" else "while"

    def resolved_max_steps(self, scene: SceneConfig) -> int:
        """The march step cap: this override if set, else the scene's."""
        return self.max_steps if self.max_steps is not None else scene.max_steps
