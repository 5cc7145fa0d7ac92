"""The geodesic ray march — the hot loop of the whole framework.

Re-designs the reference per-pixel CUDA march (src/raymarcher.cu:41-121)
as array code: CUDA thread divergence (per-thread `break` on horizon
capture or escape) becomes lock-step masked iteration — every ray carries
an `active` mask and all updates are `where`-selected. Step semantics match the
reference exactly:

  per step (raymarcher.cu:41-121):
    1. r from the PRE-step position; horizon capture r < 1.01*Rs
       -> transmittance = 0, ray done (raymarcher.cu:47-51);
    2. adaptive step size from PRE-step zone flags: x0.1 near the BH
       (r < 18), else x0.3 in the disk zone, else x0.5 in the cloud zone
       (raymarcher.cu:54-62);
    3. RK4 step updates position AND velocity (raymarcher.cu:64);
    4. radiative transfer evaluated at the PRE-step position with the
       POST-step velocity (raymarcher.cu:67-117) — emission/absorption
       with front-to-back compositing;
    5. escape when r > 250 moving outward (POST-step velocity,
       raymarcher.cu:120).

Loop strategies:
  * "scan":  lax.scan over a fixed max_steps trip count;
  * "while": lax.while_loop over chunks of scan steps, exiting as soon as
    every ray is done — early thread exit at whole-frame granularity (the
    GPU kernel in ops/pallas_march.py refines this to one block of rays).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from relativisticraytracer_tpu.config import SceneConfig
from relativisticraytracer_tpu.core.utils import largest_divisor_at_most
from relativisticraytracer_tpu.core.vecmath import Vec3, normalize
from relativisticraytracer_tpu.media import densities as densities_mod
from relativisticraytracer_tpu.media.densities import (
    accretion_envelope,
    accretion_streaks,
    disk_temperature,
    dust_base,
    dust_strands,
)
from relativisticraytracer_tpu.physics.geodesics import redshift_factor
from relativisticraytracer_tpu.physics.integrators import rk4_step


class MarchState(NamedTuple):
    p: Vec3                 # position (world)
    v: Vec3                 # coordinate velocity (unit at launch)
    intensity: Vec3         # accumulated RGB emission
    transmittance: jnp.ndarray
    hit_horizon: jnp.ndarray  # bool
    active: jnp.ndarray       # bool


def init_state(origin: Vec3, direction: Vec3) -> MarchState:
    zeros = jnp.zeros_like(origin.x)
    return MarchState(
        p=origin,
        v=direction,
        intensity=Vec3(zeros, zeros, zeros),
        transmittance=jnp.ones_like(zeros),
        # *_like keeps shard_map varying-axis tags attached to the inputs.
        hit_horizon=jnp.zeros_like(zeros, dtype=bool),
        active=jnp.ones_like(zeros, dtype=bool),
    )


def _select(mask, a, b):
    return jnp.where(mask, a, b)


def media_probes(scene: SceneConfig, rel: Vec3, in_disk_zone, in_cloud_zone,
                 active):
    """~10-op per-ray masks that are False wherever the media provably
    cannot pass the 0.001 emission gate (see densities.disk_probe_bounds /
    cloud_probe_bounds). Skipping steps where no ray probes True is exact."""
    r_cyl2 = rel.x * rel.x + rel.z * rel.z
    y2 = rel.y * rel.y
    y4 = y2 * y2
    probe_disk = probe_cloud = None
    if scene.enable_disk:
        k2, rlo2, rhi2 = densities_mod.disk_probe_bounds(scene)
        probe_disk = jnp.logical_and(
            jnp.logical_and(active, in_disk_zone),
            jnp.logical_and(
                y4 * r_cyl2 < k2,
                jnp.logical_and(r_cyl2 >= rlo2, r_cyl2 <= rhi2),
            ),
        )
    if scene.enable_clouds:
        k2, rlo2, rhi2 = densities_mod.cloud_probe_bounds(scene)
        probe_cloud = jnp.logical_and(
            jnp.logical_and(active, in_cloud_zone),
            jnp.logical_and(
                (y4 * y4 * y2) * r_cyl2 < k2,
                jnp.logical_and(r_cyl2 >= rlo2, r_cyl2 <= rhi2),
            ),
        )
    return probe_disk, probe_cloud


def _media_contribution(scene: SceneConfig, rel: Vec3, r2, v_new: Vec3,
                        in_disk_zone, in_cloud_zone, time,
                        disk_pred=None, cloud_pred=None):
    """Per-step emission/opacity (raymarcher.cu:67-105). `rel`/`r2` are the
    PRE-step position (and its squared radius; the sqrt happens inside the
    gated blocks); `v_new` is the POST-step velocity.

    disk_pred/cloud_pred: optional traced scalar bools — when given, each
    component block (envelope + multi-octave noise + emission) runs under a
    `lax.cond`, so a kernel block whose probe is all-False skips it."""
    zero = jnp.zeros_like(r2)
    emit_r = zero
    emit_g = zero
    emit_b = zero
    opacity = zero

    if scene.enable_disk:
        def disk_block(emit_r, emit_g, emit_b, opacity):
            envelope, in_annulus, r_cyl, safe_r = accretion_envelope(scene, rel)
            disk_gate = jnp.logical_and(in_disk_zone, in_annulus)
            d_disk = jnp.where(
                disk_gate,
                envelope * accretion_streaks(scene, rel, r_cyl, safe_r, time),
                zero,
            )
            lit = d_disk > 0.001
            # g with the post-step velocity (raymarcher.cu:77)
            g = redshift_factor(scene, rel, v_new)
            temp = disk_temperature(scene, jnp.sqrt(r2))
            t_ratio = temp / scene.disk_temp_ref
            t_norm = jnp.sqrt(t_ratio)
            g2 = g * g
            bol_i = (g2 * g2) * t_norm * d_disk * scene.disk_luminosity
            color_t = g * t_ratio ** 0.4 * 2.5
            emit_r = emit_r + _select(lit, 1.0 * bol_i, zero)
            emit_g = emit_g + _select(lit, jnp.minimum(0.25, 0.12 * color_t) * bol_i, zero)
            emit_b = emit_b + _select(
                lit, jnp.maximum(0.0, 0.01 * (color_t - 2.0)) * bol_i, zero
            )
            opacity = opacity + _select(lit, d_disk * scene.disk_opacity, zero)
            return emit_r, emit_g, emit_b, opacity

        if disk_pred is not None:
            emit_r, emit_g, emit_b, opacity = jax.lax.cond(
                disk_pred, disk_block,
                lambda *xs: xs, emit_r, emit_g, emit_b, opacity,
            )
        else:
            emit_r, emit_g, emit_b, opacity = disk_block(
                emit_r, emit_g, emit_b, opacity
            )

    if scene.enable_clouds:
        def cloud_block(emit_r, emit_g, emit_b, opacity):
            base, in_annulus_c, alive, r_cyl_c, safe_r_c = dust_base(scene, rel)
            cloud_gate = jnp.logical_and(
                in_cloud_zone, jnp.logical_and(in_annulus_c, alive)
            )
            d_cloud = jnp.where(
                cloud_gate,
                base * dust_strands(scene, rel, r_cyl_c, safe_r_c, time),
                zero,
            )
            lit = d_cloud > 0.001
            g = redshift_factor(scene, rel, v_new)  # recomputed, as in cu:92
            lighting = 0.5 + 3.0 * (
                scene.isco_radius / jnp.maximum(jnp.sqrt(r2), scene.isco_radius)
            ) ** 1.2
            cloud_i = d_cloud * scene.cloud_luminosity * lighting
            # redshift color grading (raymarcher.cu:96-102)
            t = jnp.clip((g - 0.7) / (1.3 - 0.7), 0.0, 1.0)
            shift = t * t * (3.0 - 2.0 * t)
            emit_r = emit_r + _select(lit, 0.60 * cloud_i * (1.2 + shift * (0.8 - 1.2)), zero)
            emit_g = emit_g + _select(lit, 0.65 * cloud_i * (0.8 + shift * (1.1 - 0.8)), zero)
            emit_b = emit_b + _select(lit, 0.80 * cloud_i * (0.6 + shift * (1.4 - 0.6)), zero)
            opacity = opacity + _select(lit, d_cloud * scene.cloud_opacity, zero)
            return emit_r, emit_g, emit_b, opacity

        if cloud_pred is not None:
            emit_r, emit_g, emit_b, opacity = jax.lax.cond(
                cloud_pred, cloud_block,
                lambda *xs: xs, emit_r, emit_g, emit_b, opacity,
            )
        else:
            emit_r, emit_g, emit_b, opacity = cloud_block(
                emit_r, emit_g, emit_b, opacity
            )

    return Vec3(emit_r, emit_g, emit_b), opacity


def compose_step(intensity: Vec3, trans, ex, ey, ez, opacity, in_media, h):
    """Front-to-back emission/absorption compositing for one step
    (raymarcher.cu:107-115)."""
    d_tau = opacity * h
    step_trans = jnp.exp(-d_tau)
    factor = (1.0 - step_trans) * trans
    intensity = Vec3(
        intensity.x + _select(in_media, ex * factor, 0.0),
        intensity.y + _select(in_media, ey * factor, 0.0),
        intensity.z + _select(in_media, ez * factor, 0.0),
    )
    trans = _select(in_media, trans * step_trans, trans)
    return intensity, trans


def adaptive_h(scene: SceneConfig, r2, in_disk_zone, in_cloud_zone, active):
    """The reference's adaptive step size from PRE-step zone flags
    (raymarcher.cu:54-62), with finished rays frozen via h = 0."""
    near_bh = r2 < 18.0 ** 2
    h = scene.step_size_m * jnp.where(
        near_bh, 0.1,
        jnp.where(in_disk_zone, 0.3, jnp.where(in_cloud_zone, 0.5, 1.0)),
    )
    return jnp.where(active, h, 0.0)


def media_zones(scene: SceneConfig, rel: Vec3, r2):
    """PRE-step zone flags (raymarcher.cu:54-62)."""
    abs_y = jnp.abs(rel.y)
    in_disk_zone = jnp.logical_and(
        abs_y < scene.disk_h_m * 5.0, r2 < (scene.disk_out_m + 5.0) ** 2
    )
    in_cloud_zone = jnp.logical_and(
        abs_y < scene.cloud_h_m * 1.5, r2 < scene.cloud_out_m ** 2
    )
    return in_disk_zone, in_cloud_zone


def block_any(mask) -> jnp.ndarray:
    """`jnp.any` as an int32 max-reduction: Pallas's Triton lowering has
    no reduce_or, so the GPU kernel's block-wide tests go through this."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def march_step(scene: SceneConfig, state: MarchState, time,
               media_cond: bool = False) -> MarchState:
    """One reference march iteration (raymarcher.cu:41-121), fully masked.

    media_cond=True wraps the radiative-transfer block in a `lax.cond` on
    "any ray in this array may be lit by a medium" (the conservative
    `media_probes`, tests/test_densities.py::test_probe_bounds_are_conservative)
    — a whole-array skip of the expensive density evaluation. The GPU
    kernel (ops/pallas_march.py) uses it with the array = one block of
    rays, so a block pays for media only when one of its rays needs it:
    the reference's divergent media branch (raymarcher.cu:67-117) at
    block granularity. The skip is exact."""
    p, v, intensity, trans, hit, active = state
    eh = scene.event_horizon
    mp = scene.mass_pos

    if mp == (0.0, 0.0, 0.0):
        rel = p  # x - 0 == x bitwise; skip 3 subs in the hot loop
    else:
        rel = Vec3(p.x - mp[0], p.y - mp[1], p.z - mp[2])
    r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    # All radius tests compare r^2 against squared thresholds (both sides
    # non-negative; differs from sqrt-then-compare only in a 1-ulp boundary
    # band), deferring the sqrt to the media blocks that actually need r.

    # 1. horizon capture (raymarcher.cu:47-51) — BEFORE stepping, so captured
    # rays keep their pre-step velocity for the (black) background.
    hit_now = jnp.logical_and(active, r2 < (eh * 1.01) ** 2)
    hit = jnp.logical_or(hit, hit_now)
    trans = _select(hit_now, jnp.zeros_like(trans), trans)
    active = jnp.logical_and(active, jnp.logical_not(hit_now))

    # 2. adaptive step size from PRE-step zone flags (raymarcher.cu:54-62).
    # Finished rays are frozen by stepping with h = 0 (p + 0 == p bitwise):
    # cheaper than 6 per-component selects after the step.
    in_disk_zone, in_cloud_zone = media_zones(scene, rel, r2)
    h = adaptive_h(scene, r2, in_disk_zone, in_cloud_zone, active)

    # 3. RK4 (raymarcher.cu:64)
    p, v = rk4_step(scene, p, v, h)

    # 4. radiative transfer (raymarcher.cu:67-117): PRE-step position,
    # POST-step velocity
    if scene.enable_disk or scene.enable_clouds:
        in_media = jnp.logical_and(
            active, jnp.logical_or(in_disk_zone, in_cloud_zone)
        )
        if media_cond:
            probe_disk, probe_cloud = media_probes(
                scene, rel, in_disk_zone, in_cloud_zone, active
            )
            pd = block_any(probe_disk) if probe_disk is not None else None
            pc = block_any(probe_cloud) if probe_cloud is not None else None
            any_pred = pd if pc is None else (
                pc if pd is None else jnp.logical_or(pd, pc))
            emit, opacity = _media_contribution(
                scene, rel, r2, v, in_disk_zone, in_cloud_zone, time,
                disk_pred=pd, cloud_pred=pc,
            )
            intensity, trans = jax.lax.cond(
                any_pred,
                lambda i, t: compose_step(i, t, emit.x, emit.y, emit.z,
                                          opacity, in_media, h),
                lambda i, t: (i, t),
                intensity, trans,
            )
        else:
            emit, opacity = _media_contribution(
                scene, rel, r2, v, in_disk_zone, in_cloud_zone, time
            )
            intensity, trans = compose_step(
                intensity, trans, emit.x, emit.y, emit.z, opacity,
                in_media, h,
            )

    # 5. escape to infinity (raymarcher.cu:120) — POST-step velocity,
    # PRE-step position
    outward = rel.x * v.x + rel.y * v.y + rel.z * v.z > 0.0
    escaped = jnp.logical_and(
        active, jnp.logical_and(r2 > scene.escape_radius ** 2, outward)
    )
    active = jnp.logical_and(active, jnp.logical_not(escaped))

    return MarchState(p, v, intensity, trans, hit, active)


def march(
    scene: SceneConfig,
    origin: Vec3,
    direction: Vec3,
    time,
    max_steps: int | None = None,
    loop: str = "while",
    chunk: int = 64,
) -> MarchState:
    """March every ray to termination or the step cap.

    loop="scan": fixed max_steps trip count (fastest to compile, runs every
    step). loop="while": chunks of scan steps under a lax.while_loop that
    stops as soon as no ray is active — frames whose slowest ray finishes
    early skip the remaining chunks entirely.
    """
    max_steps = scene.max_steps if max_steps is None else max_steps
    state = init_state(origin, direction)
    time = jnp.asarray(time, dtype=jnp.float32)

    def body(st, _):
        return march_step(scene, st, time), None

    if loop == "scan":
        state, _ = jax.lax.scan(body, state, None, length=max_steps)
        return state

    if loop == "while":
        chunk = largest_divisor_at_most(max_steps, chunk)
        n_chunks = max_steps // chunk

        def chunk_body(carry):
            i, st = carry
            st, _ = jax.lax.scan(body, st, None, length=chunk)
            return i + 1, st

        def cond(carry):
            i, st = carry
            return jnp.logical_and(i < n_chunks, jnp.any(st.active))

        _, state = jax.lax.while_loop(cond, chunk_body, (jnp.int32(0), state))
        return state

    raise ValueError(f"unknown loop strategy {loop!r}")


def composite_background(state: MarchState, sky_fn) -> Vec3:
    """Final HDR color of marched rays: emission plus the background seen
    along the final direction through the remaining transmittance
    (raymarcher.cu:123-150). Shared by the XLA march and the GPU kernel's
    epilogue, so the two paths differ only inside the march."""
    d = normalize(state.v)
    bg = sky_fn(d)
    zero = jnp.zeros_like(state.transmittance)
    bg = Vec3(
        _select(state.hit_horizon, zero, bg.x),
        _select(state.hit_horizon, zero, bg.y),
        _select(state.hit_horizon, zero, bg.z),
    )
    return Vec3(
        state.intensity.x + bg.x * state.transmittance,
        state.intensity.y + bg.y * state.transmittance,
        state.intensity.z + bg.z * state.transmittance,
    )
