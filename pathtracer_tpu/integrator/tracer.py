"""The path-tracing integrator: progressive Monte-Carlo with NEE + MIS.

Batched rebuild of Tracer (rust-pathtracer/src/tracer.rs:22-220). The
reference runs one pixel per rayon task with data-dependent `break`s; here
the whole frame is a flat ray batch walked by a fixed-trip lax.scan over
bounces with an `alive` mask — every lane executes every bounce, masked
lanes contribute exact zeros. RNG is counter-based (threefry), keyed by
(frame, bounce, lane): reproducible, and bit-identical between the batched
path and the float64 CPU oracle (the reference's per-thread ThreadRng,
tracer.rs:44, is not reproducible at all).

Quirk ledger replicated verbatim (flag-gated via `Quirks`):
- `state.hit_dist` persists across bounces and gates emitter intersection
  (scene.rs:66 reads it, nothing resets it): a bounce that misses geometry
  compares light distances against the PREVIOUS bounce's hit distance
  (-1.0 on the primary ray, so camera-visible lights never register as
  emitters and render as background).
- The MIS gate `state.depth > 0` (tracer.rs:80) is always true (depth is
  never decremented), so a primary-ray emitter hit is weighted by
  power_heuristic(0, light_pdf) = 0.
- The sample-side Fresnel stale-l quirk (see ops/bsdf.py).
- any_hit ignoring max_dist is a scene-level quirk (models/analytical.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.camera import gen_ray, pixel_coords
from ..models.light import Lights, gather_light
from ..models.material import Material, finalize_material
from ..models.scene import Scene
from ..ops.bsdf import disney_eval, disney_sample
from ..ops.intersect import ray_rect, ray_sphere
from ..ops.sampling import (
    hg_phase,
    power_heuristic,
    sample_hg,
    uniform_sample_hemisphere,
)
from ..ops.vecmath import (
    V2,
    V3,
    dot,
    onb,
    safe_normalize,
    splat3,
    to_world,
    where3,
    zeros3,
)

EPS = 0.005  # tracer.rs:16

# Uniforms consumed per bounce: [light pick, light r1, light r2,
# bsdf r1, bsdf r2, reflect/refract coin, alpha coin, scatter-distance].
# On a volumetric scatter bounce the surface never runs, so the NEE triple
# u[0:3] re-targets the scatter point and the BSDF pair u[3:4] drives HG
# direction sampling — every uniform is consumed at most once per lane.
U_PER_BOUNCE = 8


@dataclasses.dataclass(frozen=True)
class Quirks:
    """Keep/fix switches for the reference's port bugs (SURVEY.md §7).

    Defaults replicate the reference verbatim; the CPU oracle honors the
    same flags so allclose is well-defined under either setting.
    """

    # Carry state.hit_dist across bounces as the emitter-distance gate
    # (scene.rs:66 + globals.rs:28). False: gate on this bounce's geometry
    # distance only (the GLSL original's behavior).
    stale_emitter_gate: bool = True
    # MIS-weight emitter hits with the previous scatter pdf even on primary
    # rays (tracer.rs:80's always-true depth gate). False: primary hits get
    # weight 1 (GLSL original).
    primary_mis: bool = True


VERBATIM = Quirks()
FIXED = Quirks(stale_emitter_gate=False, primary_mis=False)


class EmitterHit(NamedTuple):
    """Result of the emitter pass (Scene::sample_lights default method,
    scene.rs:36-86) over the light table."""

    hit: jnp.ndarray  # bool[N]
    dist: jnp.ndarray  # [N]
    pdf: jnp.ndarray  # [N]
    emission: V3  # [N]


def sample_lights_emitter(lights: Lights, ro: V3, rd: V3, gate_dist) -> EmitterHit:
    """Ray-vs-light emitter intersection (scene.rs:36-86).

    Sequential `d < dist` semantics over the light list are reproduced by a
    static unroll (L is small). The reference implements only Spherical
    here (scene.rs:69); Rectangular is added following the GLSL original's
    RectIntersect path (pdf = d^2/(area*|cos|), no 0.5 hemisphere factor).
    Distant lights are never hittable (area = 0).
    """
    n = jnp.shape(rd.x)
    dtype = jnp.asarray(rd.x).dtype
    dist = jnp.broadcast_to(jnp.asarray(gate_dist, dtype), n)
    hit = jnp.zeros(n, bool)
    pdf = jnp.zeros(n, dtype)
    emission = zeros3(n, dtype)

    for i in range(lights.count):
        pos = V3(lights.position.x[i], lights.position.y[i], lights.position.z[i])
        is_spherical = lights.light_type[i] == 1  # LightType.SPHERICAL
        is_rect = lights.light_type[i] == 0  # LightType.RECTANGULAR

        # Spherical candidate (scene.rs:38-63).
        d_s = ray_sphere(ro, rd, pos, lights.radius[i])
        # Rectangular candidate (GLSL RectIntersect).
        u_i = V3(lights.u.x[i], lights.u.y[i], lights.u.z[i])
        v_i = V3(lights.v.x[i], lights.v.y[i], lights.v.z[i])
        d_r = ray_rect(ro, rd, pos, u_i, v_i)

        d = jnp.where(is_spherical, d_s, jnp.where(is_rect, d_r, jnp.inf))
        take = jnp.isfinite(d) & (d < dist) & (is_spherical | is_rect)
        # d is +inf on miss; square only a guarded copy — the backward of
        # d*d is cot * 2d, and 0-cotangent * inf = NaN would leak into
        # sphere/light geometry gradients through ray_sphere's VJP.
        d_safe = jnp.where(take, d, 1.0)
        hit_point = ro + rd * jnp.where(take, d_safe, 0.0)
        sph_normal = safe_normalize(hit_point - pos)
        rect_normal = safe_normalize(u_i.cross(v_i))
        normal = where3(is_spherical, sph_normal, rect_normal)
        cos_theta = dot(-rd, normal)
        # Spherical pdf has the 0.5 hemisphere factor (scene.rs:74);
        # rectangular is plain d^2/(area*cos).
        half = jnp.where(is_spherical, 0.5, 1.0)
        denom = lights.area[i] * cos_theta * half
        pdf_i = (d_safe * d_safe) / jnp.where(denom != 0.0, denom, 1.0)
        dist = jnp.where(take, d_safe, dist)
        pdf = jnp.where(take, pdf_i, pdf)
        em_i = V3(lights.emission.x[i], lights.emission.y[i], lights.emission.z[i])
        emission = where3(take, emission * 0.0 + em_i, emission)
        hit = hit | take

    return EmitterHit(hit=hit, dist=dist, pdf=pdf, emission=emission)


class LightSample(NamedTuple):
    """LightSampleRec (globals.rs:109-130)."""

    normal: V3
    emission: V3
    direction: V3
    dist: jnp.ndarray
    pdf: jnp.ndarray


def sample_light_spherical(
    lights: Lights, idx: jnp.ndarray, scatter_pos: V3, r1, r2,
    detach: bool = False,
) -> LightSample:
    """Spherical light surface sampling (tracer.rs:173-220).

    Verbatim: uniform hemisphere about the center->shading-point axis,
    emission pre-multiplied by the light count (tracer.rs:214), pdf
    d^2/(area * 0.5 * |n.l|) (tracer.rs:215).

    detach=True stop-gradients the sampled geometry (direction, distance,
    normal, pdf) for the detached estimator; emission keeps its gradient so
    light-intensity recovery works (BASELINE config 4).
    """
    sg = jax.lax.stop_gradient if detach else (lambda x: x)
    lt = gather_light(lights, idx)

    center_to_surf = scatter_pos - lt.position
    dist_to_center = center_to_surf.length()
    axis = center_to_surf / splat3(jnp.where(dist_to_center > 0.0, dist_to_center, 1.0))

    sampled = uniform_sample_hemisphere(r1, r2)
    t, b = onb(axis)
    sampled_dir = to_world(t, b, axis, sampled)

    light_surface = lt.position + sampled_dir * splat3(lt.radius)
    direction = light_surface - scatter_pos
    dist = direction.length()
    dist_sq = dist * dist
    direction = direction / splat3(jnp.where(dist > 0.0, dist, 1.0))
    normal = safe_normalize(light_surface - lt.position)

    n_lights = lights.count
    emission = lt.emission * float(n_lights)
    denom = lt.area * 0.5 * jnp.abs(dot(normal, direction))
    pdf = dist_sq / jnp.where(denom != 0.0, denom, 1.0)
    return LightSample(
        normal=sg(normal),
        emission=emission,
        direction=sg(direction),
        dist=sg(dist),
        pdf=sg(pdf),
    )


def sample_light_rect(
    lights: Lights, idx: jnp.ndarray, scatter_pos: V3, r1, r2,
    detach: bool = False,
) -> LightSample:
    """Rectangular light surface sampling (GLSL SampleRectLight; the
    reference declares LightType::Rectangular but never implements it,
    globals.rs:70): uniform point on the quad, pdf = d^2/(area*|n.l|)."""
    sg = jax.lax.stop_gradient if detach else (lambda x: x)
    lt = gather_light(lights, idx)

    light_surface = lt.position + lt.u * splat3(r1) + lt.v * splat3(r2)
    direction = light_surface - scatter_pos
    dist = direction.length()
    dist_sq = dist * dist
    direction = direction / splat3(jnp.where(dist > 0.0, dist, 1.0))
    normal = safe_normalize(lt.u.cross(lt.v))

    emission = lt.emission * float(lights.count)
    denom = lt.area * jnp.abs(dot(normal, direction))
    pdf = dist_sq / jnp.where(denom != 0.0, denom, 1.0)
    return LightSample(
        normal=sg(normal),
        emission=emission,
        direction=sg(direction),
        dist=sg(dist),
        pdf=sg(pdf),
    )


def sample_light_distant(
    lights: Lights, idx: jnp.ndarray, scatter_pos: V3,
    detach: bool = False,
) -> LightSample:
    """Distant light sampling (GLSL SampleDistantLight): fixed direction
    (stored in `position`), dist = inf, pdf = 1. area = 0 keeps it out of
    MIS (tracer.rs:157-160) and out of the emitter pass."""
    sg = jax.lax.stop_gradient if detach else (lambda x: x)
    lt = gather_light(lights, idx)
    direction = safe_normalize(lt.position)
    normal = safe_normalize(scatter_pos - lt.position)
    emission = lt.emission * float(lights.count)
    big = jnp.full_like(lt.area, jnp.inf)
    return LightSample(
        normal=sg(normal),
        emission=emission,
        direction=sg(direction),
        dist=big,
        pdf=jnp.ones_like(lt.area),
    )


def sample_light(
    lights: Lights, idx: jnp.ndarray, scatter_pos: V3, r1, r2,
    detach: bool = False,
) -> LightSample:
    """Type-dispatched light sampling (tracer.rs:173-220 `sample_light`):
    all three candidates are cheap closed forms, selected per lane by the
    picked light's type — the batched replacement for the reference's
    match on LightType."""
    t = gather_light(lights, idx).light_type
    sph = sample_light_spherical(lights, idx, scatter_pos, r1, r2, detach)
    rect = sample_light_rect(lights, idx, scatter_pos, r1, r2, detach)
    dst = sample_light_distant(lights, idx, scatter_pos, detach)

    def pick(a, b, c):  # rect=0, spherical=1, distant=2
        return jnp.where(t == 1, b, jnp.where(t == 0, a, c))

    def pick3(a, b, c):
        return V3(pick(a.x, b.x, c.x), pick(a.y, b.y, c.y), pick(a.z, b.z, c.z))

    return LightSample(
        normal=pick3(rect.normal, sph.normal, dst.normal),
        emission=pick3(rect.emission, sph.emission, dst.emission),
        direction=pick3(rect.direction, sph.direction, dst.direction),
        dist=pick(rect.dist, sph.dist, dst.dist),
        pdf=pick(rect.pdf, sph.pdf, dst.pdf),
    )


def direct_light(
    scene: Scene, rd: V3, fhp: V3, ffnormal: V3, material: Material, eta, u,
    detach: bool = False, mis: bool = True,
) -> V3:
    """Next-event estimation (tracer.rs:126-170): pick one light uniformly,
    sample its surface, shadow-test, MIS-weight against the BSDF pdf.

    mis=False drops the power-heuristic weight (weight 1): the NEE-only
    estimator used by the physics invariants (SURVEY.md §4 item 3)."""
    u_pick, r1, r2 = u[..., 0], u[..., 1], u[..., 2]
    n_lights = scene.num_lights
    if n_lights == 0:
        return zeros3(jnp.shape(rd.x), jnp.asarray(rd.x).dtype)

    scatter_pos = fhp + ffnormal * EPS  # tracer.rs:131

    idx = jnp.clip((u_pick * n_lights).astype(jnp.int32), 0, n_lights - 1)
    ls = sample_light(scene.lights, idx, scatter_pos, r1, r2, detach)

    # Single-sided gate (tracer.rs:148).
    facing = dot(ls.direction, ls.normal) < 0.0

    in_shadow = scene.any_hit(scatter_pos, ls.direction, ls.dist - EPS)

    f, bsdf_pdf = disney_eval(material, eta, -rd, ffnormal, ls.direction)

    # MIS weight stays differentiable even under detach: it is a continuous
    # function of params at the (detached) light direction, its gradient is
    # pointwise-correct, and the weight-derivative terms cancel against the
    # BSDF-sampling estimator in expectation (w_light + w_bsdf = 1).
    area = gather_light(scene.lights, idx).area
    if mis:
        mis_w = jnp.where(
            area > 0.0, power_heuristic(ls.pdf, bsdf_pdf), 1.0
        )  # tracer.rs:157-160
    else:
        mis_w = jnp.ones_like(ls.pdf)

    ok = facing & (~in_shadow) & (bsdf_pdf > 0.0) & (ls.pdf > 0.0)
    scale = jnp.where(ok, mis_w / jnp.where(ls.pdf != 0.0, ls.pdf, 1.0), 0.0)
    return ls.emission * f * scale


def _scatter_direct_light(
    scene: Scene, rd: V3, scatter_pos: V3, g, u,
    detach: bool = False, mis: bool = True,
) -> V3:
    """Next-event estimation from a volumetric scatter point: identical to
    direct_light except the HG phase function p(cosθ; g) replaces the
    surface BSDF (value AND pdf — HG importance sampling is exact, so the
    same scalar plays both roles in the MIS weight)."""
    u_pick, r1, r2 = u[..., 0], u[..., 1], u[..., 2]
    n_lights = scene.num_lights
    if n_lights == 0:
        return zeros3(jnp.shape(rd.x), jnp.asarray(rd.x).dtype)

    idx = jnp.clip((u_pick * n_lights).astype(jnp.int32), 0, n_lights - 1)
    ls = sample_light(scene.lights, idx, scatter_pos, r1, r2, detach)

    facing = dot(ls.direction, ls.normal) < 0.0  # tracer.rs:148
    in_shadow = scene.any_hit(scatter_pos, ls.direction, ls.dist - EPS)

    p = hg_phase(dot(rd, ls.direction), g)
    area = gather_light(scene.lights, idx).area
    if mis:
        mis_w = jnp.where(area > 0.0, power_heuristic(ls.pdf, p), 1.0)
    else:
        mis_w = jnp.ones_like(ls.pdf)
    ok = facing & (~in_shadow) & (p > 0.0) & (ls.pdf > 0.0)
    scale = jnp.where(ok, mis_w * p / jnp.where(ls.pdf != 0.0, ls.pdf, 1.0), 0.0)
    return ls.emission * splat3(scale)


class PathState(NamedTuple):
    """Per-lane bounce-loop carry: Ray + State + ScatterSampleRec
    (ray.rs:6-48, globals.rs:6-104) flattened into scan carry."""

    ro: V3
    rd: V3
    radiance: V3
    throughput: V3
    alive: jnp.ndarray  # bool
    prev_pdf: jnp.ndarray  # scatter_sample.pdf of previous bounce
    prev_l: V3  # scatter_sample.l of previous bounce (stale-l quirk)
    prev_hit_dist: jnp.ndarray  # state.hit_dist carry (stale gate quirk)
    # Volumetric medium the ray currently travels in (State.medium,
    # globals.rs:21/37 — declared in the reference, never integrated;
    # implemented here per the GLSL original: Absorb = Beer-Lambert
    # extinction exp(-(1-color)·density·t), Emissive = color·density·t
    # added along the segment). med_type 0 (None) = vacuum.
    med_type: jnp.ndarray  # int32
    med_density: jnp.ndarray
    med_color: V3
    med_aniso: jnp.ndarray  # HG g (Medium.anisotropy, clamped ±0.9)


def _mask3(mask, v: V3) -> V3:
    zero = jnp.zeros_like(v.x)
    return V3(
        jnp.where(mask, v.x, zero),
        jnp.where(mask, v.y, zero),
        jnp.where(mask, v.z, zero),
    )


def make_bounce_step(
    scene: Scene, quirks: Quirks = VERBATIM, detach: bool = False,
    estimator: str = "mis",
):
    """One bounce of the per-pixel loop (tracer.rs:61-103), batched.

    detach=True applies the detached-sampling gradient policy (see
    ops/bsdf.disney_sample): discrete lobe/light choices and sampled
    directions are treated as constants under differentiation; BSDF values,
    emissions, background, and geometry terms keep parameter gradients.

    estimator selects the direct-lighting estimator (SURVEY.md §4 item 3 —
    the three must agree in expectation, which is the physics gate parity
    tests cannot provide):
    - "mis"  (default): NEE + BSDF sampling, MIS power-heuristic weighted —
      the reference's estimator (tracer.rs:77-89).
    - "bsdf": BSDF sampling only — no NEE; emitter hits counted at weight 1.
    - "nee":  next-event estimation only — emitter hits contribute 0 (the
      path still terminates there, tracer.rs:87); all direct light arrives
      via light-surface sampling.
    """
    if estimator not in ("mis", "bsdf", "nee"):
        raise ValueError(f"unknown estimator {estimator!r}")

    def bounce(state: PathState, u_bounce) -> tuple[PathState, None]:
        ro, rd = state.ro, state.rd
        radiance, throughput = state.radiance, state.throughput
        alive = state.alive

        geo = scene.closest_hit(ro, rd)
        geo_hit = jnp.isfinite(geo.t)

        # state.hit_dist after the geometry pass; the emitter gate
        # (scene.rs:66) reads it — stale carry on geometry miss (quirk).
        if quirks.stale_emitter_gate:
            gate_dist = jnp.where(geo_hit, geo.t, state.prev_hit_dist)
        else:
            gate_dist = jnp.where(geo_hit, geo.t, jnp.inf)
        em = sample_lights_emitter(scene.lights, ro, rd, gate_dist)

        hit = geo_hit | em.hit
        hit_dist = jnp.where(em.hit, em.dist, gate_dist)

        # Volumetric segment effects (the reference's State.medium,
        # globals.rs:21, declared but never integrated; GLSL-original
        # semantics): while traveling inside a participating medium,
        # Absorb applies Beer-Lambert extinction exp(-(1-color)·density·t)
        # over the segment just traveled and Emissive adds
        # color·density·t·throughput. Scatter media are not yet
        # implemented (treated as vacuum; see models/material.py).
        seg = jnp.where(hit, hit_dist, 0.0)
        seg_on = alive & hit & (state.med_type != 0)
        absorbing = seg_on & (state.med_type == 1)  # MediumType.ABSORB
        emitting = seg_on & (state.med_type == 3)  # MediumType.EMISSIVE
        ext = splat3(state.med_density * seg)
        att = V3(
            jnp.exp(-(1.0 - state.med_color.x) * ext.x),
            jnp.exp(-(1.0 - state.med_color.y) * ext.y),
            jnp.exp(-(1.0 - state.med_color.z) * ext.z),
        )
        radiance = radiance + _mask3(
            emitting,
            state.med_color * splat3(state.med_density * seg) * throughput,
        )
        throughput = where3(absorbing, throughput * att, throughput)

        # MediumType::Scatter (material.rs:8-13, declared in the reference
        # but never integrated; GLSL-family single-scattering semantics):
        # sample a free-flight distance s ~ Exp(density); if s lands inside
        # the segment the path scatters there instead of reaching the
        # surface — the exponential pdf cancels the transmittance exactly,
        # so throughput picks up only the single-scatter albedo (color).
        # The scatter event gets its own NEE (HG phase replaces the BSDF)
        # and an HG-sampled continuation; it consumes the bounce.
        u_dist = u_bounce[..., 7]
        sigma = jnp.maximum(state.med_density, 1e-12)
        s_free = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-12)) / sigma
        scat = (
            alive & hit & (state.med_type == 2) & (state.med_density > 0.0)
            & (s_free < hit_dist)
        )
        sg_ = jax.lax.stop_gradient if detach else (lambda x: x)
        scatter_pos = ro + rd * sg_(jnp.where(scat, s_free, 0.0))
        throughput = where3(scat, throughput * state.med_color, throughput)
        if estimator != "bsdf":
            ld_s = _scatter_direct_light(
                scene, rd, scatter_pos, state.med_aniso, u_bounce[..., 0:3],
                detach, mis=(estimator == "mis"),
            )
            radiance = radiance + _mask3(scat, ld_s * throughput)
        l_hg = sample_hg(rd, state.med_aniso, u_bounce[..., 3], u_bounce[..., 4])
        l_hg = sg_(l_hg)
        pdf_hg = hg_phase(dot(rd, l_hg), state.med_aniso)

        # Miss -> background * throughput, path dies (tracer.rs:66-69).
        bg = scene.background(rd)
        radiance = radiance + _mask3(alive & ~hit, bg * throughput)

        # State::finalize (globals.rs:50-62) + Material::finalize.
        material = finalize_material(geo.material)
        fhp = ro + rd * jnp.where(hit, hit_dist, 0.0)
        entering = dot(geo.normal, rd) <= 0.0
        ffnormal = where3(entering, geo.normal, -geo.normal)
        eta = jnp.where(
            dot(rd, geo.normal) < 0.0, 1.0 / material.ior, material.ior
        )

        # Alpha pass-through (AlphaMode Blend/Mask, material.rs:38-44 —
        # declared in the reference but never wired to its integrator;
        # implemented here per the GLSL original's semantics): a Blend
        # surface is skipped stochastically when the alpha coin exceeds
        # opacity, a Mask surface deterministically when opacity <
        # alpha_cutoff. Skipped lanes re-emit the SAME ray from the hit
        # point, collect nothing, and consume the bounce (fixed trip
        # count). Emitter hits are lights, never alpha-tested.
        u_alpha = u_bounce[..., 6]
        am = material.alpha_mode
        alpha_fail = ((am == 1) & (u_alpha > material.opacity)) | (
            (am == 2) & (material.opacity < material.alpha_cutoff)
        )
        passthru = alive & hit & ~em.hit & alpha_fail & ~scat

        # Surface emission (tracer.rs:74).
        radiance = radiance + _mask3(
            alive & hit & ~passthru & ~scat, material.emission * throughput
        )

        # Emitter hit: MIS with the previous bounce's scatter pdf
        # (tracer.rs:77-87). With quirks.primary_mis the weight is
        # power_heuristic(prev_pdf, light_pdf) ALWAYS (prev_pdf = 0 on the
        # primary ray -> weight 0); the fixed variant gives primaries
        # weight 1 by seeding prev_pdf appropriately in trace().
        # Differentiable even under detach (see direct_light); prev_pdf is
        # already stop-gradiented by disney_sample when detach=True.
        mis_w = power_heuristic(jnp.maximum(state.prev_pdf, 0.0), em.pdf)
        if not quirks.primary_mis:
            mis_w = jnp.where(state.prev_pdf < 0.0, 1.0, mis_w)
        if estimator == "bsdf":
            mis_w = jnp.ones_like(mis_w)
        elif estimator == "nee":
            mis_w = jnp.zeros_like(mis_w)
        radiance = radiance + _mask3(
            alive & em.hit & ~scat, em.emission * (mis_w * 1.0) * throughput
        )

        live = alive & hit & ~em.hit & ~scat
        shade = live & ~passthru

        # NEE (tracer.rs:89).
        if estimator != "bsdf":
            ld = direct_light(
                scene, rd, fhp, ffnormal, material, eta, u_bounce[..., 0:3],
                detach, mis=(estimator == "mis"),
            )
            radiance = radiance + _mask3(shade, ld * throughput)

        # BSDF sampling (tracer.rs:92-101).
        bs = disney_sample(
            material, eta, -rd, ffnormal, state.prev_l, u_bounce[..., 3:6], detach
        )
        cont = shade & (bs.pdf > 0.0)
        safe_pdf = jnp.where(bs.pdf > 0.0, bs.pdf, 1.0)
        throughput = where3(cont, throughput * bs.f / splat3(safe_pdf), throughput)

        ro_next = where3(cont, fhp + bs.l * EPS, ro)
        rd_next = where3(cont, bs.l, rd)
        # Alpha skip: continue straight through the surface.
        ro_next = where3(passthru, fhp + rd * EPS, ro_next)
        rd_next = where3(passthru, rd, rd_next)
        # Volumetric scatter: continue from the scatter point along the
        # HG-sampled direction (still inside the medium).
        ro_next = where3(scat, scatter_pos, ro_next)
        rd_next = where3(scat, l_hg, rd_next)
        cont = cont | passthru | scat

        # scatter_sample.{l, pdf} update verbatim: written whenever
        # disney_sample ran, i.e. on shaded lanes (tracer.rs:92); a
        # volumetric scatter records the HG pdf for next-bounce emitter MIS.
        prev_pdf = jnp.where(shade, bs.pdf, state.prev_pdf)
        prev_pdf = jnp.where(scat, sg_(pdf_hg), prev_pdf)
        prev_l = where3(shade, bs.l, state.prev_l)
        prev_l = where3(scat, l_hg, prev_l)
        # state.hit_dist persists; closest_hit only ran on alive lanes.
        prev_hit_dist = jnp.where(alive & hit, hit_dist, state.prev_hit_dist)

        # Medium transition on refraction through the surface (GLSL
        # original: entering a front face adopts the hit material's
        # medium, exiting returns to vacuum). Alpha pass-through ignores
        # the surface entirely, media included.
        transmitted = shade & cont & (dot(bs.l, ffnormal) < 0.0)
        enter_m = transmitted & entering
        exit_m = transmitted & ~entering
        mmed = material.medium
        med_type = jnp.where(
            enter_m, mmed.medium_type, jnp.where(exit_m, 0, state.med_type)
        )
        med_density = jnp.where(
            enter_m, mmed.density, jnp.where(exit_m, 0.0, state.med_density)
        )
        zero3 = zeros3(jnp.shape(bs.pdf), jnp.asarray(bs.pdf).dtype)
        med_color = where3(
            enter_m, mmed.color, where3(exit_m, zero3, state.med_color)
        )
        med_aniso = jnp.where(
            enter_m, mmed.anisotropy, jnp.where(exit_m, 0.0, state.med_aniso)
        )

        return (
            PathState(
                ro=ro_next,
                rd=rd_next,
                radiance=radiance,
                throughput=throughput,
                alive=cont,
                prev_pdf=prev_pdf,
                prev_l=prev_l,
                prev_hit_dist=prev_hit_dist,
                med_type=med_type,
                med_density=med_density,
                med_color=med_color,
                med_aniso=med_aniso,
            ),
            None,
        )

    return bounce


def init_state(ro: V3, rd: V3, quirks: Quirks = VERBATIM) -> PathState:
    """Fresh per-lane path state for a batch of primary rays
    (State::new / ScatterSampleRec::new, globals.rs:23-39, 97-103)."""
    n = jnp.shape(rd.x)
    dtype = jnp.asarray(rd.x).dtype
    if quirks.primary_mis:
        prev_pdf0 = jnp.zeros(n, dtype)
    else:
        # -1 sentinel: "no previous bounce" -> emitter weight 1.
        prev_pdf0 = jnp.full(n, -1.0, dtype)
    return PathState(
        ro=ro,
        rd=rd,
        radiance=zeros3(n, dtype),
        throughput=splat3(jnp.ones(n, dtype)),
        alive=jnp.ones(n, bool),
        prev_pdf=prev_pdf0,
        prev_l=zeros3(n, dtype),
        prev_hit_dist=jnp.full(n, -1.0, dtype),  # State::new (globals.rs:28)
        med_type=jnp.zeros(n, jnp.int32),  # vacuum (MediumType::None)
        med_density=jnp.zeros(n, dtype),
        med_color=zeros3(n, dtype),
        med_aniso=jnp.zeros(n, dtype),
    )


def trace(
    scene: Scene,
    ro: V3,
    rd: V3,
    uniforms: jnp.ndarray,  # [depth, N, U_PER_BOUNCE]
    quirks: Quirks = VERBATIM,
    unroll: int | bool = 1,
    detach: bool = False,
    remat: bool = False,
    estimator: str = "mis",
) -> V3:
    """Trace a batch of primary rays to radiance (the bounce loop of
    tracer.rs:51-103).

    remat=True checkpoints each bounce under reverse-mode AD: the backward
    pass recomputes bounce intermediates instead of materializing
    depth x N live values in HBM — the FLOPs-for-memory trade that makes
    high-resolution inverse rendering fit on chip."""
    n = jnp.shape(rd.x)
    dtype = jnp.asarray(rd.x).dtype

    init = init_state(ro, rd, quirks)
    bounce = make_bounce_step(scene, quirks, detach, estimator)
    if remat:
        bounce = jax.checkpoint(bounce)
    final, _ = jax.lax.scan(bounce, init, uniforms, unroll=unroll)
    return final.radiance


@partial(jax.jit, static_argnames=("width", "height", "spp", "quirks"))
def measure_occupancy(
    scene: Scene, key, width: int, height: int, spp: int = 1,
    quirks: Quirks = VERBATIM,
) -> jnp.ndarray:
    """Masked-lane occupancy: the fraction of lanes still alive ENTERING
    each bounce, [depth] floats (first entry is 1.0 by construction).

    This is the measurement SURVEY.md §7 "hard part 2" calls for before any
    compaction engineering: the reference's per-pixel `break`s
    (tracer.rs:66-97) become masked lanes here, and wasted-lane fraction =
    1 - occupancy is the ceiling on what ray compaction could recover at a
    given depth. Logged by app/render.py --occupancy.
    """
    dtype = scene.lights.radius.dtype
    n = width * height * spp
    coords = pixel_coords(width, height, dtype)
    if spp > 1:
        coords = V2(jnp.repeat(coords.x, spp), jnp.repeat(coords.y, spp))
    depth = scene.recursion_depth
    cam_u, bounce_u = draw_uniforms(key, n, depth, dtype)
    offset = V2(cam_u[:, 0], cam_u[:, 1])
    ro, rd = gen_ray(scene.camera, coords, offset, float(width), float(height))
    bounce = make_bounce_step(scene, quirks)

    def step(state, u):
        frac = jnp.mean(state.alive.astype(dtype))
        new, _ = bounce(state, u)
        return new, frac

    _, fracs = jax.lax.scan(step, init_state(ro, rd, quirks), bounce_u)
    return fracs


def draw_uniforms(key, n: int, depth: int, dtype=jnp.float32):
    """Counter-based per-frame randomness: (cam_jitter [N,2],
    bounce uniforms [depth, N, 6]).

    Replaces ThreadRng (tracer.rs:44-45,137,191-192,446-447,534) with
    threefry — deterministic, backend-independent, so the CPU oracle
    consumes bit-identical uniforms.
    """
    kc, kb = jax.random.split(key)
    cam = jax.random.uniform(kc, (n, 2), dtype)
    bounce = jax.random.uniform(kb, (depth, n, U_PER_BOUNCE), dtype)
    return cam, bounce


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "quirks", "unroll", "detach", "remat",
        "estimator",
    ),
)
def render_frame(
    scene: Scene,
    key,
    width: int,
    height: int,
    spp: int = 1,
    quirks: Quirks = VERBATIM,
    unroll: int | bool = 1,
    detach: bool = False,
    remat: bool = False,
    estimator: str = "mis",
) -> jnp.ndarray:
    """Render one progressive frame -> [H, W, 4] linear RGBA (alpha = 1).

    The per-pixel work of Tracer::render (tracer.rs:33-118) for all pixels
    (and spp samples) at once; accumulation into the ColorBuffer is the
    caller's `accumulate` (progressive running mean, tracer.rs:105-121).
    """
    dtype = scene.lights.radius.dtype
    n = width * height
    coords = pixel_coords(width, height, dtype)
    depth = scene.recursion_depth

    def one_sample(k):
        cam_u, bounce_u = draw_uniforms(k, n, depth, dtype)
        offset = V2(cam_u[:, 0], cam_u[:, 1])
        ro, rd = gen_ray(scene.camera, coords, offset, float(width), float(height))
        return trace(
            scene, ro, rd, bounce_u, quirks, unroll, detach, remat, estimator
        )

    if spp == 1:
        radiance = one_sample(key)
    else:
        keys = jax.random.split(key, spp)
        acc = jax.lax.map(one_sample, keys)  # [spp] V3 of [N]
        radiance = V3(
            jnp.mean(acc.x, axis=0), jnp.mean(acc.y, axis=0), jnp.mean(acc.z, axis=0)
        )

    img = jnp.stack(
        [
            radiance.x.reshape(height, width),
            radiance.y.reshape(height, width),
            radiance.z.reshape(height, width),
            jnp.ones((height, width), dtype),  # alpha = 1 (tracer.rs:59)
        ],
        axis=-1,
    )
    return img


def accumulate(pixels: jnp.ndarray, frame: jnp.ndarray, frames: jnp.ndarray):
    """Progressive running mean, weight 1/(frames+1) (tracer.rs:105-121).

    Returns (new_pixels, frames+1). Resumable by construction: the whole
    render state is (pixels, frames) — the checkpoint/resume story the
    reference never built (SURVEY.md §5).
    """
    w = 1.0 / (frames + 1.0)
    return pixels * (1.0 - w) + frame * w, frames + 1
