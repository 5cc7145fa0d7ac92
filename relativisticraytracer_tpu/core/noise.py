"""Procedural hash/value/cellular noise (reference: include/math_utils.h:65-133).

Exact float32 transcriptions — the hashes use C `fmodf`, which is
sign-preserving (truncated division); `jnp.fmod` has the same semantics.
The sequential component updates in `hash33` are order-dependent and kept
verbatim. These functions drive the accretion-disk / dust-cloud structure,
so bit-level fidelity here is what bounds the golden-image RMSE budget.

All functions take SoA `Vec3` inputs of any shape and are pure
elementwise pipelines (no gathers, no transcendentals beyond floor/abs),
safe to inline into Pallas kernel bodies.
"""

from __future__ import annotations

import jax.numpy as jnp

from relativisticraytracer_tpu.core.vecmath import Vec3, length, lerp

_K = 0.1031    # hash multiplier (math_utils.h:66,92)
_C = 33.33     # hash offset (math_utils.h:67-69,93)


def _frac_signed(x):
    """C fmodf(x, 1.0f): truncated-division remainder, sign of the dividend.
    For divisor 1 this is exactly x - trunc(x) (trunc is exact; when
    |x| >= 2^23 trunc(x) == x so the result is an exact 0) — bitwise equal
    to fmodf but with no division, and this runs ~160x per 5-octave fbm."""
    return x - jnp.trunc(x)


def hash33(p: Vec3) -> Vec3:
    """3->3 hash (reference: math_utils.h:65-71). Component updates are
    sequential: p.x is updated before p.y's dot product reads it."""
    x = _frac_signed(p.x * _K)
    y = _frac_signed(p.y * _K)
    z = _frac_signed(p.z * _K)
    # p.x += dot(p, (p.y+C, p.z+C, p.x+C))
    x = x + (x * (y + _C) + y * (z + _C) + z * (x + _C))
    # p.y += dot(p, (p.x+C, p.z+C, p.y+C))  [uses updated x]
    y = y + (x * (x + _C) + y * (z + _C) + z * (y + _C))
    # p.z += dot(p, (p.x+C, p.y+C, p.z+C))  [uses updated x, y]
    z = z + (x * (x + _C) + y * (y + _C) + z * (z + _C))
    return Vec3(
        _frac_signed((x + y) * z),
        _frac_signed((x + z) * y),
        _frac_signed((y + z) * x),
    )


def hash31(p: Vec3) -> jnp.ndarray:
    """3->1 hash (reference: math_utils.h:91-96)."""
    x = _frac_signed(p.x * _K)
    y = _frac_signed(p.y * _K)
    z = _frac_signed(p.z * _K)
    d = x * (y + _C) + y * (z + _C) + z * (x + _C)
    x = x + d
    y = y + d
    z = z + d
    return _frac_signed((x + y) * z)


def noise3D(p: Vec3) -> jnp.ndarray:
    """Trilinear value noise with smoothstep fade (reference: math_utils.h:98-110)."""
    ix = jnp.floor(p.x)
    iy = jnp.floor(p.y)
    iz = jnp.floor(p.z)
    fx = p.x - ix
    fy = p.y - iy
    fz = p.z - iz
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    uz = fz * fz * (3.0 - 2.0 * fz)

    def corner(cx, cy, cz):
        return hash31(Vec3(ix + cx, iy + cy, iz + cz))

    # Lerp order matches the reference exactly (x, then y, then z).
    n000, n100 = corner(0.0, 0.0, 0.0), corner(1.0, 0.0, 0.0)
    n010, n110 = corner(0.0, 1.0, 0.0), corner(1.0, 1.0, 0.0)
    n001, n101 = corner(0.0, 0.0, 1.0), corner(1.0, 0.0, 1.0)
    n011, n111 = corner(0.0, 1.0, 1.0), corner(1.0, 1.0, 1.0)
    front = lerp(lerp(n000, n100, ux), lerp(n010, n110, ux), uy)
    back = lerp(lerp(n001, n101, ux), lerp(n011, n111, ux), uy)
    return lerp(front, back, uz)


def fbm(p: Vec3, octaves: int) -> jnp.ndarray:
    """N-octave fractal noise, lacunarity 2.05, gain 0.5, +10 domain shift
    per octave (reference: math_utils.h:112-121). `octaves` is static."""
    v = jnp.zeros_like(p.x)
    a = 0.5
    for _ in range(octaves):
        v = v + a * noise3D(p)
        p = Vec3(p.x * 2.05 + 10.0, p.y * 2.05 + 10.0, p.z * 2.05 + 10.0)
        a *= 0.5
    return v


def fbm_billow(p: Vec3, octaves: int) -> jnp.ndarray:
    """Ridge/billow fbm variant (reference: math_utils.h:123-133; unused by
    the reference kernel — the dust-cloud ridging is inlined there — but part
    of the public math surface)."""
    v = jnp.zeros_like(p.x)
    a = 0.5
    for _ in range(octaves):
        n = noise3D(p)
        v = v + a * (1.0 - jnp.abs(n * 2.0 - 1.0))
        p = Vec3(p.x * 2.05 + 10.0, p.y * 2.05 + 10.0, p.z * 2.05 + 10.0)
        a *= 0.5
    return v


def worley3D(p: Vec3) -> jnp.ndarray:
    """Cellular noise over the 3x3x3 neighborhood (reference: math_utils.h:73-89)."""
    ix = jnp.floor(p.x)
    iy = jnp.floor(p.y)
    iz = jnp.floor(p.z)
    f = Vec3(p.x - ix, p.y - iy, p.z - iz)
    min_dist = jnp.full_like(p.x, 1.0)
    for z in (-1.0, 0.0, 1.0):
        for y in (-1.0, 0.0, 1.0):
            for x in (-1.0, 0.0, 1.0):
                point = hash33(Vec3(ix + x, iy + y, iz + z))
                diff = Vec3(x + point.x - f.x, y + point.y - f.y, z + point.z - f.z)
                min_dist = jnp.minimum(min_dist, length(diff))
    return min_dist
