"""Structure-of-arrays 3-vector math (reference: include/math_utils.h:11-61).

Structure-of-arrays representation: a `Vec3` is a NamedTuple of three
same-shaped float32 arrays (x, y, z planes). Every op is a full-width
elementwise op on planes (coalesced in device memory, one register per
component per ray inside a kernel), and the same code runs verbatim inside
Pallas kernel bodies.

All functions mirror the reference device helpers exactly (same guards,
same operation order) — they are the parity bedrock.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Array = jnp.ndarray
Scalar = Union[float, Array]


class Vec3(NamedTuple):
    x: Array
    y: Array
    z: Array

    # Elementwise arithmetic sugar (shapes must broadcast).
    def __add__(self, o: "Vec3") -> "Vec3":  # type: ignore[override]
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s: Scalar) -> "Vec3":  # type: ignore[override]
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)


def vec3(x, y, z, dtype=jnp.float32) -> Vec3:
    return Vec3(
        jnp.asarray(x, dtype=dtype),
        jnp.asarray(y, dtype=dtype),
        jnp.asarray(z, dtype=dtype),
    )


def from_array(a: Array) -> Vec3:
    """[..., 3] array -> Vec3 (API boundary only; never in the hot path)."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3) -> Array:
    """Vec3 -> [..., 3] array (API boundary only)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def dot(a: Vec3, b: Vec3) -> Array:
    """reference: math_utils.h:11-13"""
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    """reference: math_utils.h:15-17"""
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(v: Vec3) -> Array:
    """reference: math_utils.h:19-21"""
    return jnp.sqrt(v.x * v.x + v.y * v.y + v.z * v.z)


def normalize(v: Vec3) -> Vec3:
    """reference: math_utils.h:23-27 — returns the zero vector when |v| < 1e-6."""
    mag = length(v)
    small = mag < 1e-6
    safe = jnp.where(small, 1.0, mag)
    inv = 1.0 / safe
    zero = jnp.zeros_like(mag)
    return Vec3(
        jnp.where(small, zero, v.x * inv),
        jnp.where(small, zero, v.y * inv),
        jnp.where(small, zero, v.z * inv),
    )


def lerp(a: Scalar, b: Scalar, t: Scalar) -> Array:
    """reference: math_utils.h:41-43"""
    return a + t * (b - a)


def smoothstep(edge0: Scalar, edge1: Scalar, x: Scalar) -> Array:
    """reference: math_utils.h:45-48 (note: callers sometimes pass edge0 > edge1)."""
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def rotate_3d(p: Vec3, axis: Vec3, angle: Scalar) -> Vec3:
    """Axis-angle rotation (reference: math_utils.h:52-61; unused by the
    reference kernel but part of its public math surface)."""
    s = jnp.sin(angle)
    c = jnp.cos(angle)
    oc = 1.0 - c
    ax, ay, az = axis.x, axis.y, axis.z
    return Vec3(
        (oc * ax * ax + c) * p.x + (oc * ax * ay - az * s) * p.y + (oc * az * ax + ay * s) * p.z,
        (oc * ax * ay + az * s) * p.x + (oc * ay * ay + c) * p.y + (oc * ay * az - ax * s) * p.z,
        (oc * az * ax - ay * s) * p.x + (oc * ay * az + ax * s) * p.y + (oc * az * az + c) * p.z,
    )
