"""Polynomial atan2/asin for the sky lookup.

`atan2` is a minimax-polynomial implementation (max abs error 2.4e-7 in
float32, ~2 ulp of atan2f) built only from mul/add/div/select, so the same
code lowers inside Pallas kernels and in plain XLA. The golden images
(tests/goldens/) embed its exact values, so it stays the one definition.

Signed-zero caveat: y = -0.0 is treated as non-negative (jnp comparisons do
not distinguish +/-0), so atan2(-0.0, x<0) returns +pi where libm returns
-pi. sin/cos of +/-pi agree to ~1 ulp, so rendered output is unaffected.
"""

from __future__ import annotations

import jax.numpy as jnp

_PI = 3.14159265358979
_PI_2 = 1.5707963267948966

# atan(t)/t as a degree-8 polynomial in s = t^2, minimax-fit on t in [0, 1]
# (f32 evaluation error <= 1e-7; see tools/fit_atan.py provenance in git).
_ATAN_COEF = (
    0.9999999937528704,
    -0.3333313796574813,
    0.19993694134109075,
    -0.1421110450729569,
    0.10667480453561796,
    -0.07556885545726152,
    0.04327805721553666,
    -0.016413069634952718,
    0.002932729905334909,
)


def _atan_unit(t):
    """atan(t) for t in [0, 1]."""
    s = t * t
    acc = jnp.full_like(t, _ATAN_COEF[-1])
    for c in _ATAN_COEF[-2::-1]:
        acc = acc * s + c
    return acc * t


def atan2(y, x):
    """Four-quadrant arctangent (~2 ulp). atan2(0, 0) = 0; see the module
    docstring for the signed-zero caveat."""
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    mx = jnp.maximum(ax, ay)
    mn = jnp.minimum(ax, ay)
    t = mn / jnp.maximum(mx, 1e-37)          # in [0, 1]; 0 at the origin
    a = _atan_unit(t)
    a = jnp.where(ay > ax, _PI_2 - a, a)      # reflect past 45 degrees
    a = jnp.where(x < 0.0, _PI - a, a)        # quadrants II/III
    return jnp.where(y < 0.0, -a, a)          # sign of y


def arcsin(x):
    """asin via atan2(x, sqrt(1-x^2)); |x| clamped to 1."""
    xc = jnp.clip(x, -1.0, 1.0)
    return atan2(xc, jnp.sqrt(jnp.maximum(1.0 - xc * xc, 0.0)))
