"""Post-processing chain (reference: include/camera_effects/post_processing.h
and the kernel epilogue, src/raymarcher.cu:152-173).

All effects are per-pixel closed forms (the reference "bloom" is a luma
threshold self-add with NO blur — post_processing.h:27-31); the whole chain
fuses into the frame program as pure elementwise work.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from relativisticraytracer_tpu.core.vecmath import Vec3, smoothstep

# Rec.709 luma weights (post_processing.h:28)
_LUMA_R = 0.2126
_LUMA_G = 0.7152
_LUMA_B = 0.0722


def grain_hash(px, py):
    """Film-grain hash (reference: post_processing.h:9-11; unused by the
    reference kernel, kept for API parity)."""
    d = px * 12.9898 + py * 78.233
    return jnp.fmod(jnp.sin(d) * 43758.5453, 1.0)


def apply_lens_distortion(uv_x, uv_y, k) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Barrel distortion uv' = t*(1 + k*r^2) + 0.5, t = uv - 0.5
    (reference: post_processing.h:19-24). Applied BEFORE ray generation
    (raymarcher.cu:22-25)."""
    tx = uv_x - 0.5
    ty = uv_y - 0.5
    r2 = tx * tx + ty * ty
    f = 1.0 + r2 * k
    return tx * f + 0.5, ty * f + 0.5


def apply_vignette(color: Vec3, uv_x, uv_y, intensity) -> Vec3:
    """Radial smoothstep(0.8 -> 0.2) multiplier on |uv - 0.5| * intensity
    (reference: post_processing.h:13-17). Uses the distorted uv
    (raymarcher.cu:160)."""
    dx = uv_x - 0.5
    dy = uv_y - 0.5
    d = jnp.sqrt(dx * dx + dy * dy)
    v = smoothstep(0.8, 0.2, d * intensity)
    return Vec3(color.x * v, color.y * v, color.z * v)


def bloom_contribution(color: Vec3, threshold) -> Vec3:
    """Luma-threshold pass-through — the reference bloom has no blur
    (post_processing.h:27-31)."""
    brightness = color.x * _LUMA_R + color.y * _LUMA_G + color.z * _LUMA_B
    keep = brightness > threshold
    zero = jnp.zeros_like(brightness)
    return Vec3(
        jnp.where(keep, color.x, zero),
        jnp.where(keep, color.y, zero),
        jnp.where(keep, color.z, zero),
    )


def tonemap(color: Vec3, exposure) -> Vec3:
    """Exponential tone map 1 - exp(-c * EXPOSURE) (raymarcher.cu:164-166)."""
    return Vec3(
        1.0 - jnp.exp(-color.x * exposure),
        1.0 - jnp.exp(-color.y * exposure),
        1.0 - jnp.exp(-color.z * exposure),
    )


def apply_effects_and_tonemap(hdr: Vec3, uv_x, uv_y, effects, exposure) -> Vec3:
    """Full kernel epilogue (raymarcher.cu:152-166) with runtime 0/1 effect
    flags (no retrace on toggle)."""
    bloom = bloom_contribution(hdr, effects.bloom_threshold)
    gain = effects.use_bloom * effects.bloom_intensity
    hdr = Vec3(hdr.x + bloom.x * gain, hdr.y + bloom.y * gain, hdr.z + bloom.z * gain)

    vig = apply_vignette(hdr, uv_x, uv_y, effects.vignette_intensity)
    on = effects.use_vignette > 0.5
    hdr = Vec3(
        jnp.where(on, vig.x, hdr.x),
        jnp.where(on, vig.y, hdr.y),
        jnp.where(on, vig.z, hdr.z),
    )
    return tonemap(hdr, exposure)


def pack_rgba8(ldr: Vec3) -> jnp.ndarray:
    """float [0,1) -> uint8[H, W, 4], alpha=255. The reference C cast
    truncates toward zero ((unsigned char)(x*255), raymarcher.cu:168-172);
    XLA's float->int convert also truncates, so the cast matches."""
    def chan(c):
        return jnp.clip(c * 255.0, 0.0, 255.0).astype(jnp.uint8)

    r = chan(ldr.x)
    g = chan(ldr.y)
    b = chan(ldr.z)
    a = jnp.full_like(r, 255)
    return jnp.stack([r, g, b, a], axis=-1)


def downsample_box(ldr: Vec3, s: int) -> Vec3:
    """SSAA resolve: (s*H, s*W) -> (H, W) box filter (post-tonemap).
    s is static; s=1 is the identity (reference behavior)."""
    if s == 1:
        return ldr

    def d(c):
        hs, ws = c.shape
        return c.reshape(hs // s, s, ws // s, s).mean(axis=(1, 3))

    return Vec3(d(ldr.x), d(ldr.y), d(ldr.z))


def yuv420_from_rgba8(frame: jnp.ndarray) -> jnp.ndarray:
    """uint8[H, W, 4] RGBA -> flat uint8[H*W*3//2] planar YUV420 (BT.601
    limited range): the byte stream FFmpeg expects for
    `-f rawvideo -pix_fmt yuv420p` (Y plane, then 2x2-subsampled U, V).

    Rationale: the animation transfer format. An RGBA frame is 4 B/px over
    the device->host link; this is 1.5 B/px computed ON DEVICE (one
    elementwise pass + 2x2 box reduce), a 2.67x cut that keeps slow links
    (and PCIe at scale) out of the frame loop. Information-wise it matches
    the reference pipeline, which also hands FFmpeg 8-bit frames that the
    encoder converts to yuv420p before H.264 (main.cpp:60-72: rawvideo
    rgba in, -pix_fmt yuv420p out); doing the conversion on-device just
    moves swscale's work to the accelerator. H and W must be even."""
    h, w, _ = frame.shape
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs even dims, got {w}x{h}")
    rgb = frame[..., :3].astype(jnp.float32) * (1.0 / 255.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yp = 0.299 * r + 0.587 * g + 0.114 * b
    y8 = jnp.clip(16.0 + 219.0 * yp + 0.5, 0.0, 255.0).astype(jnp.uint8)
    u = 128.0 + 112.0 * (b - yp) / 0.886
    v = 128.0 + 112.0 * (r - yp) / 0.701

    def sub(c):  # 2x2 box average, then quantize
        c = c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        return jnp.clip(c + 0.5, 0.0, 255.0).astype(jnp.uint8)

    return jnp.concatenate(
        [y8.reshape(-1), sub(u).reshape(-1), sub(v).reshape(-1)]
    )
