"""Parity tests: volumetric media vs the NumPy oracle
(reference: include/densities.h)."""

import numpy as np

import jax.numpy as jnp

from relativisticraytracer_tpu.config import SceneConfig
from relativisticraytracer_tpu.core.vecmath import Vec3
from relativisticraytracer_tpu.media.densities import (
    accretion_density,
    disk_temperature,
    dust_cloud_density,
)
from tests.oracle import numpy_ref as oracle

SCENE = SceneConfig()


def _as_vec3(a):
    return Vec3(jnp.asarray(a[..., 0]), jnp.asarray(a[..., 1]), jnp.asarray(a[..., 2]))


def _disk_points(rng, n=512):
    """Points concentrated in/near the disk annulus (incl. out-of-gate points)."""
    r = rng.uniform(5.0, 30.0, size=n).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, size=n).astype(np.float32)
    y = rng.uniform(-2.0, 2.0, size=n).astype(np.float32)
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=-1).astype(np.float32)


def test_disk_temperature_matches_oracle(rng):
    r = rng.uniform(0.0, 40.0, size=256).astype(np.float32)
    got = np.asarray(disk_temperature(SCENE, jnp.asarray(r)))
    want = oracle.get_disk_temperature(r)
    np.testing.assert_allclose(got, want, rtol=3e-5)


def test_disk_temperature_power_law():
    r = np.array([10.0, 20.0, 40.0], dtype=np.float32)
    t = np.asarray(disk_temperature(SCENE, jnp.asarray(r)))
    # T(2r)/T(r) = 2^-0.75
    np.testing.assert_allclose(t[1] / t[0], 2.0 ** -0.75, rtol=1e-4)
    np.testing.assert_allclose(t[2] / t[1], 2.0 ** -0.75, rtol=1e-4)
    assert float(disk_temperature(SCENE, jnp.asarray(np.float32(9.99)))) == 0.0


def test_accretion_density_matches_oracle(rng):
    pts = _disk_points(rng)
    for t in (0.0, 1.7, 12.3):
        got = np.asarray(accretion_density(SCENE, _as_vec3(pts), jnp.float32(t)))
        want = oracle.get_accretion_density(pts, t)
        # Transcendental ulp differences get amplified by the high-contrast
        # streak shaping ((x*2.8)^1.6 after thresholding) — ~2e-3 relative.
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


def test_accretion_density_gates():
    inside = np.array([[9.9, 0.0, 0.0]], dtype=np.float32)
    outside = np.array([[25.1, 0.0, 0.0]], dtype=np.float32)
    assert float(accretion_density(SCENE, _as_vec3(inside), 0.0)[0]) == 0.0
    assert float(accretion_density(SCENE, _as_vec3(outside), 0.0)[0]) == 0.0


def test_dust_cloud_density_matches_oracle(rng):
    pts = _disk_points(rng, n=256)
    pts[:, 1] *= 0.2  # clouds are thin; keep some points alive
    for t in (0.0, 3.1):
        got = np.asarray(dust_cloud_density(SCENE, _as_vec3(pts), jnp.float32(t)))
        want = oracle.get_dust_cloud_density(pts, t)
        # strands^4 after smoothstep steepens relative error; see disk note.
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


def test_dust_cloud_base_early_out():
    # Far off the midplane the base envelope < 0.001 -> exactly zero.
    p = np.array([[15.0, 3.0, 0.0]], dtype=np.float32)
    assert float(dust_cloud_density(SCENE, _as_vec3(p), 0.0)[0]) == 0.0


def test_densities_no_nan_everywhere(rng):
    # Including pathological points: origin, on-axis, huge radii.
    pts = np.concatenate(
        [
            _disk_points(rng, 64),
            np.array(
                [[0, 0, 0], [0, 5, 0], [1e6, 0, 0], [0, 0, 1e-8]], dtype=np.float32
            ),
        ]
    )
    for fn in (accretion_density, dust_cloud_density):
        out = np.asarray(fn(SCENE, _as_vec3(pts), jnp.float32(1.0)))
        assert np.all(np.isfinite(out))


def test_probe_bounds_are_conservative(rng):
    """The per-step skip probes (render/march.media_probes) may only be
    False where the density provably cannot pass the 0.001 emission gate —
    fuzz the bound over the whole media volume and several times."""
    from relativisticraytracer_tpu.media.densities import (
        cloud_probe_bounds,
        disk_probe_bounds,
    )

    n = 4096
    pts = np.stack(
        [
            rng.uniform(-30, 30, n),
            rng.uniform(-5, 5, n),
            rng.uniform(-30, 30, n),
        ],
        axis=-1,
    ).astype(np.float32)
    p = _as_vec3(pts)
    r_cyl2 = p.x * p.x + p.z * p.z
    y2 = p.y * p.y
    y4 = y2 * y2

    k2, rlo2, rhi2 = disk_probe_bounds(SCENE)
    probe_disk = np.asarray(
        (y4 * r_cyl2 < k2) & (r_cyl2 >= rlo2) & (r_cyl2 <= rhi2)
    )
    k2c, rlo2c, rhi2c = cloud_probe_bounds(SCENE)
    probe_cloud = np.asarray(
        ((y4 * y4 * y2) * r_cyl2 < k2c) & (r_cyl2 >= rlo2c) & (r_cyl2 <= rhi2c)
    )

    for t in (0.0, 1.7, 42.0):
        d_disk = np.asarray(accretion_density(SCENE, p, jnp.float32(t)))
        d_cloud = np.asarray(dust_cloud_density(SCENE, p, jnp.float32(t)))
        assert np.all(d_disk[~probe_disk] <= 0.001), (
            f"disk probe missed density {d_disk[~probe_disk].max()} at t={t}"
        )
        assert np.all(d_cloud[~probe_cloud] <= 0.001), (
            f"cloud probe missed density {d_cloud[~probe_cloud].max()} at t={t}"
        )
    # and the probes are not trivially always-on: a decent share of the
    # sampled box is proven skippable
    assert probe_disk.mean() < 0.6
    assert probe_cloud.mean() < 0.35


def test_noise_octave_cap_knob(rng):
    """noise_octave_cap: None/large caps are bitwise reference-exact; a low
    cap actually changes the fields (the stylized-preview knob is live).
    Its ms/RMSE per cap on the card: tools/precision_trades.py."""
    pts = _disk_points(rng)
    p = _as_vec3(pts)
    exact_d = np.asarray(accretion_density(SCENE, p, jnp.float32(1.7)))
    exact_c = np.asarray(dust_cloud_density(SCENE, p, jnp.float32(1.7)))
    capped_hi = SceneConfig(noise_octave_cap=5)
    np.testing.assert_array_equal(
        np.asarray(accretion_density(capped_hi, p, jnp.float32(1.7))), exact_d
    )
    np.testing.assert_array_equal(
        np.asarray(dust_cloud_density(capped_hi, p, jnp.float32(1.7))), exact_c
    )
    capped_lo = SceneConfig(noise_octave_cap=2)
    lo_d = np.asarray(accretion_density(capped_lo, p, jnp.float32(1.7)))
    lo_c = np.asarray(dust_cloud_density(capped_lo, p, jnp.float32(1.7)))
    assert np.any(lo_d != exact_d)
    assert np.any(lo_c != exact_c)
