"""Equirectangular skybox sampling.

The reference binds the skybox as a CUDA texture object — RGBA8,
normalized-float reads, bilinear filtering, wrap on U / clamp on V,
normalized coordinates (reference: src/main.cpp:250-263) — and samples it
with phi/theta mapping plus optional chromatic-aberration phi offsets
(reference: src/raymarcher.cu:128-146).

Instead of a texture unit, the texture is stored quad-packed: for each
channel, one uint32 plane whose entry at (y0, x0) holds the full 2x2
bilinear footprint — texels (x0, x1) x (ya, yb) at 8 bits each, with
U-wrap (x1 = (x0+1) mod W) and V-clamp baked in at build time (the plane
has H+1 rows indexed by y0+1, covering the half-texel bands past both
poles). A full bilinear RGB sample is exactly 3 gathered elements (4
texels x 3 channels x 8 bits = 96 bits), with unpack + filtering as
elementwise math. The chromatic-aberration R/B resamples run under a
`lax.cond` and are skipped entirely while the effect is off — when off the
reference samples all three channels at offset 0
(raymarcher.cu:132,142-144), which is bitwise the G sample. On the H100
the whole sky fetch, post FX and pack take under 1 ms of a 30 ms 1080p
frame (PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from relativisticraytracer_tpu.config import PI
from relativisticraytracer_tpu.core.fastmath import arcsin as _arcsin
from relativisticraytracer_tpu.core.fastmath import atan2 as _atan2
from relativisticraytracer_tpu.core.noise import fbm, hash31
from relativisticraytracer_tpu.core.vecmath import Vec3


class Skybox(NamedTuple):
    """Device-resident quad-packed equirect texture: per channel, a uint32
    [H+1, W] plane where entry (y0+1, x0) packs the 2x2 bilinear footprint
    c(x0,ya) | c(x1,ya)<<8 | c(x0,yb)<<16 | c(x1,yb)<<24 with x1 = (x0+1)
    mod W (U-wrap) and (ya, yb) = (clip(y0), clip(y0+1)) (V-clamp); y0 spans
    [-1, H-1]. Alpha is unused by the reference shading and dropped."""

    qr: jnp.ndarray
    qg: jnp.ndarray
    qb: jnp.ndarray

    @property
    def shape(self):
        """Logical texture (H, W)."""
        hq, w = self.qr.shape
        return (hq - 1, w)


def _quad_pack(plane: np.ndarray) -> np.ndarray:
    """uint8 [H, W] channel -> uint32 [H+1, W] quad plane (see Skybox)."""
    h, w = plane.shape
    p = plane.astype(np.uint32)
    right = np.roll(p, -1, axis=1)                      # x1 = (x0+1) mod W
    ya = np.clip(np.arange(-1, h), 0, h - 1)            # top row, clamped
    yb = np.clip(np.arange(0, h + 1), 0, h - 1)         # bottom row, clamped
    return p[ya] | (right[ya] << 8) | (p[yb] << 16) | (right[yb] << 24)


def skybox_from_array(rgba: np.ndarray) -> Skybox:
    """uint8 [H, W, 3or4] host image -> device Skybox (the one-time upload,
    analog of cudaMemcpy2DToArray at main.cpp:247-248)."""
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        raise ValueError(f"skybox must be uint8, got {rgba.dtype}")
    return Skybox(*(jnp.asarray(_quad_pack(rgba[..., c])) for c in range(3)))


def sky_coords_from_uv(h: int, w: int, tx: jnp.ndarray, ty: jnp.ndarray):
    """CUDA tex2D addressing (main.cpp:255-261) -> (flat quad index, fx, fy).

    u in [0,1) wraps (u - floor(u)); the filtered sample sits at
    (u*W - 0.5, v*H - 0.5) between texel centers; U taps wrap mod W, V taps
    clamp to [0, H-1]. Built from floor / select / int convert only (no
    mod).
    """
    # wrap-U on the normalized coordinate, clamp-V
    ux = (tx - jnp.floor(tx)) * jnp.float32(w)
    vy = jnp.clip(ty, 0.0, 1.0) * jnp.float32(h)

    xb = ux - 0.5
    yb = vy - 0.5
    x0 = jnp.floor(xb)
    y0 = jnp.floor(yb)
    fx = xb - x0
    fy = yb - y0

    # ux in [0, W] => x0 in [-1, W-1]: one add-if-negative IS the mod.
    x0i = x0.astype(jnp.int32)
    x0i = jnp.where(x0i < 0, x0i + w, x0i)
    # vy in [0, H] => y0 in [-1, H-1]; quad planes are indexed by y0+1.
    yq = y0.astype(jnp.int32) + 1
    return yq * w + x0i, fx, fy


def quad_bilinear(t: jnp.ndarray, fx: jnp.ndarray, fy: jnp.ndarray) -> jnp.ndarray:
    """Unpack one gathered uint32 quad (see Skybox) and bilinear-filter it
    with fractional weights (fx, fy). Normalized-float read (uint8/255)."""
    c00 = (t & jnp.uint32(0xFF)).astype(jnp.float32)
    c10 = ((t >> 8) & jnp.uint32(0xFF)).astype(jnp.float32)
    c01 = ((t >> 16) & jnp.uint32(0xFF)).astype(jnp.float32)
    c11 = (t >> 24).astype(jnp.float32)
    top = c00 + fx * (c10 - c00)
    bot = c01 + fx * (c11 - c01)
    return (top + fy * (bot - top)) * jnp.float32(1.0 / 255.0)


def sample_bilinear(tex: Skybox, tx: jnp.ndarray, ty: jnp.ndarray) -> Vec3:
    """CUDA tex2D<float4> with normalized coords, linear filter, wrap-U,
    clamp-V, normalized-float reads (main.cpp:255-261). One gather per
    channel fetches the whole pre-packed 2x2 quad."""
    h, w = tex.shape
    idx, fx, fy = sky_coords_from_uv(h, w, tx, ty)
    return Vec3(
        quad_bilinear(jnp.take(tex.qr.reshape(-1), idx), fx, fy),
        quad_bilinear(jnp.take(tex.qg.reshape(-1), idx), fx, fy),
        quad_bilinear(jnp.take(tex.qb.reshape(-1), idx), fx, fy),
    )


def _equirect_uv(d: Vec3, phi_offset):
    """Direction -> equirect uv (raymarcher.cu:134-138):
    tx = 0.5 + (atan2(z, x) + off) / 2pi;  ty = 0.5 - asin(y) / pi.

    Uses the framework's polynomial atan2/asin (~2 ulp; core/fastmath.py),
    whose exact values the golden images embed."""
    phi = _atan2(d.z, d.x) + phi_offset
    theta = _arcsin(d.y)
    tx = 0.5 + phi / (2.0 * PI)
    ty = 0.5 - theta / PI
    return tx, ty


def sample_sky(tex: Skybox, d: Vec3, effects) -> Vec3:
    """Background color for escape direction d, with chromatic aberration as
    +/- phi offsets on the R/B channels (raymarcher.cu:131-145). The G
    sample always runs; the R/B resamples run under a lax.cond on the CA
    flag (off => they equal the G sample bitwise, as in the reference where
    offset is 0)."""
    tg_x, tg_y = _equirect_uv(d, jnp.float32(0.0))
    s_g = sample_bilinear(tex, tg_x, tg_y)

    def with_ca(_):
        offset = effects.ca_amount
        tr_x, tr_y = _equirect_uv(d, offset)
        tb_x, tb_y = _equirect_uv(d, -offset)
        s_r = sample_bilinear(tex, tr_x, tr_y)
        s_b = sample_bilinear(tex, tb_x, tb_y)
        return s_r.x, s_b.z

    def without_ca(_):
        return s_g.x, s_g.z

    r, b = jax.lax.cond(
        effects.use_chromatic_aberration > 0.5, with_ca, without_ca, None
    )
    return Vec3(r, s_g.y, b)


def procedural_starfield(height: int = 1024, width: int = 2048, seed: float = 7.0) -> np.ndarray:
    """Deterministic procedural equirect starfield + nebula, built from the
    framework's own hash/fbm stack (no external asset needed — the reference
    ships a JPEG we do not copy). Returns uint8 [height, width, 4]."""
    ys = jnp.arange(height, dtype=jnp.float32)
    xs = jnp.arange(width, dtype=jnp.float32)
    ty = (ys[:, None] + 0.5) / height
    tx = (xs[None, :] + 0.5) / width
    phi = (tx - 0.5) * (2.0 * PI)
    theta = (0.5 - ty) * PI
    d = Vec3(
        jnp.cos(theta) * jnp.cos(phi),
        jnp.broadcast_to(jnp.sin(theta), (height, width)),
        jnp.cos(theta) * jnp.sin(phi),
    )
    # Star layer: thresholded hash on a quantized direction grid.
    cell = Vec3(d.x * 384.0 + seed, d.y * 384.0 - seed, d.z * 384.0 + 2.0 * seed)
    hq = hash31(Vec3(jnp.floor(cell.x), jnp.floor(cell.y), jnp.floor(cell.z)))
    stars = jnp.clip((jnp.abs(hq) - 0.9985) * 700.0, 0.0, 1.0)
    # Faint nebula: low-frequency fbm tinted blue/purple.
    neb = fbm(Vec3(d.x * 3.0 + seed, d.y * 3.0, d.z * 3.0 - seed), 4)
    neb = jnp.clip(neb - 0.45, 0.0, 1.0)
    r = jnp.clip(stars + 0.30 * neb, 0.0, 1.0)
    g = jnp.clip(stars + 0.18 * neb, 0.0, 1.0)
    b = jnp.clip(stars + 0.45 * neb, 0.0, 1.0)
    img = jnp.stack(
        [r * 255.0, g * 255.0, b * 255.0, jnp.full_like(r, 255.0)], axis=-1
    ).astype(jnp.uint8)
    return np.asarray(img)
