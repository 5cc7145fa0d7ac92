"""Pseudo-Kerr photon dynamics (reference: include/geodesics.h).

The reference is NOT a full Kerr metric integration: it is the classic
h^2-conserving weak-field photon acceleration
    a = -1.5 * Rs * |p x v|^2 / r^5 * p          (geodesics.h:35-38)
plus an ad-hoc Lense-Thirring frame-dragging term
    a += (2 * a_spin * Rs / r^3) * (axis x p)    (geodesics.h:40-42)
with a hard zero inside r < Rs/2 (geodesics.h:33). Pixel parity requires
reproducing exactly this formula, so we do.

All functions are masked/branch-free (array lanes run lock-step): guards are
`jnp.where` selects, with safe denominators so no Inf/NaN is ever produced
even in masked-off lanes (keeps `jax_debug_nans` clean).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from relativisticraytracer_tpu.config import SceneConfig
from relativisticraytracer_tpu.core.vecmath import Vec3, dot, normalize

_TINY = 1e-12


def geodesic_acc(scene: SceneConfig, p_rel: Vec3, v: Vec3) -> Vec3:
    """Photon acceleration at BH-relative position `p_rel` with coordinate
    velocity `v` (reference: geodesics.h:30-45). Returns zero inside
    r < Rs/2."""
    eh = scene.event_horizon
    r2 = dot(p_rel, p_rel)
    inside = r2 < (eh * 0.5) * (eh * 0.5)

    # L = p x v;  radial term -1.5 * Rs * |L|^2 / r^5 * p.
    # 1/r^5 via a single rsqrt + multiplies: one hardware op instead of
    # sqrt + divide — this runs 4x per RK4 step, the hottest site in the
    # whole framework (2-ulp deviation, far inside the march's f32 drift).
    lx = p_rel.y * v.z - p_rel.z * v.y
    ly = p_rel.z * v.x - p_rel.x * v.z
    lz = p_rel.x * v.y - p_rel.y * v.x
    l2 = lx * lx + ly * ly + lz * lz
    inv_r = jax.lax.rsqrt(jnp.maximum(r2, _TINY))
    inv_r2 = inv_r * inv_r
    inv_r5 = inv_r2 * inv_r2 * inv_r
    radial_mag = -1.5 * eh * l2 * inv_r5

    # Fold the inside-guard into the scalar magnitude (1 select, not 3).
    radial_mag = jnp.where(inside, jnp.zeros_like(r2), radial_mag)
    ax = p_rel.x * radial_mag
    ay = p_rel.y * radial_mag
    az = p_rel.z * radial_mag

    if scene.spin_a != 0.0:
        # Frame dragging: (2 a Rs / r^3) * (axis x p)  (geodesics.h:40-42).
        sx, sy, sz = scene.spin_axis
        dx = sy * p_rel.z - sz * p_rel.y
        dy = sz * p_rel.x - sx * p_rel.z
        dz = sx * p_rel.y - sy * p_rel.x
        strength = (2.0 * scene.spin_a * eh) * (inv_r2 * inv_r)
        strength = jnp.where(inside, jnp.zeros_like(r2), strength)
        ax = ax + dx * strength
        ay = ay + dy * strength
        az = az + dz * strength

    return Vec3(ax, ay, az)


def redshift_factor(scene: SceneConfig, p_rel: Vec3, ray_vel: Vec3) -> jnp.ndarray:
    """Combined gravitational-redshift x Doppler-beaming factor g
    (reference: geodesics.h:11-25). Returns 0 inside r < 1.01*Rs.

    g_grav    = sqrt(1 - Rs/r)
    gas speed v = 1 / (r^1.5 + a), direction (-z, 0, x)/|.| (Keplerian)
    g_doppler = 1 / (gamma * (1 - v * cos(theta)))   with coordinate ray_vel.
    """
    eh = scene.event_horizon
    r = jnp.sqrt(dot(p_rel, p_rel))
    dead = r < eh * 1.01

    r_safe = jnp.maximum(r, eh * 1.005)  # masked lanes only; keeps sqrt real
    g_gravity = jnp.sqrt(1.0 - eh / r_safe)

    v_mag = 1.0 / (r_safe * jnp.sqrt(r_safe) + scene.spin_a)  # r^1.5
    gas_dir = normalize(Vec3(-p_rel.z, jnp.zeros_like(r), p_rel.x))
    cos_theta = dot(ray_vel, gas_dir)

    gamma = 1.0 / jnp.sqrt(1.0 - v_mag * v_mag)
    g_doppler = 1.0 / (gamma * (1.0 - v_mag * cos_theta))

    return jnp.where(dead, jnp.zeros_like(r), g_gravity * g_doppler)
