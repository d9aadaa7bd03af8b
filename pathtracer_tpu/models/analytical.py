"""The analytical demo scene: two spheres + checker plane + sky gradient.

Batched rebuild of renderer/src/analytical.rs:4-213 — but where the
reference hardcodes geometry and material values in code, here everything is
a differentiable parameter pytree: sphere centers/radii, the material table,
checker albedos, plane placement, sky colors, and the light. Inverse
rendering against any of them works out of the box.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops.intersect import MISS, ray_plane, ray_sphere
from ..ops.vecmath import V3, dot, mix, safe_normalize, splat3, v3, where3
from .camera import default_pinhole
from .light import spherical_light
from .material import (
    Material,
    default_material,
    gather_material,
    make_material,
    select_material,
    stack_materials,
)
from .scene import Scene, SurfaceHit


class AnalyticalParams(NamedTuple):
    """Differentiable scene parameters (values from analytical.rs)."""

    sphere_center: V3  # [2] (analytical.rs:41, 70: (-1.1,0,0), (1.1,0,0))
    sphere_radius: jnp.ndarray  # [2] (unit spheres)
    materials: Material  # [3]: sphere0, sphere1, plane base
    checker_scale: jnp.ndarray  # 0.5 (analytical.rs:113)
    checker_offset: jnp.ndarray  # 100.0 (analytical.rs:113)
    checker_albedo: jnp.ndarray  # [2]: 0.25 / 0.1 (analytical.rs:110)
    plane_point: V3  # (0,-1,0) (analytical.rs:198)
    plane_normal: V3  # (0,1,0) (analytical.rs:194)
    sky_horizon: V3  # (1,1,1) (analytical.rs:31)
    sky_zenith: V3  # (0.5,0.7,1.0)
    sky_scale: jnp.ndarray  # 0.5


def default_params(dtype=jnp.float32) -> AnalyticalParams:
    """Verbatim demo values (analytical.rs:13-119)."""
    mat_left = make_material(  # analytical.rs:56-58: white metal
        dtype, rgb=(1.0, 1.0, 1.0), roughness=0.05, metallic=1.0
    )
    mat_right = make_material(  # analytical.rs:82-85: orange clearcoat
        dtype, rgb=(1.0, 0.186, 0.0), clearcoat=1.0, clearcoat_gloss=1.0, roughness=0.1
    )
    mat_plane = make_material(dtype, roughness=1.0)  # analytical.rs:116 (rgb is
    # overridden per-ray by the checker, analytical.rs:107-115)
    return AnalyticalParams(
        sphere_center=v3(
            jnp.asarray([-1.1, 1.1], dtype),
            jnp.asarray([0.0, 0.0], dtype),
            jnp.asarray([0.0, 0.0], dtype),
        ),
        sphere_radius=jnp.asarray([1.0, 1.0], dtype),
        materials=stack_materials([mat_left, mat_right, mat_plane]),
        checker_scale=jnp.asarray(0.5, dtype),
        checker_offset=jnp.asarray(100.0, dtype),
        checker_albedo=jnp.asarray([0.25, 0.1], dtype),
        plane_point=v3(0.0, -1.0, 0.0, dtype=dtype),
        plane_normal=v3(0.0, 1.0, 0.0, dtype=dtype),
        sky_horizon=v3(1.0, 1.0, 1.0, dtype=dtype),
        sky_zenith=v3(0.5, 0.7, 1.0, dtype=dtype),
        sky_scale=jnp.asarray(0.5, dtype),
    )


def background(p: AnalyticalParams, rd: V3) -> V3:
    """Sky gradient (analytical.rs:28-32, after RTiOW): gamma-2.2-decoded
    lerp scaled by sky_scale."""
    t = 0.5 * (rd.y + 1.0)
    c = mix(p.sky_horizon, p.sky_zenith, t)
    return c.to_linear() * splat3(p.sky_scale)


def _checker(p: AnalyticalParams, x, y):
    """Procedural checker from ray direction (analytical.rs:107-113).

    Verbatim including Rust float `%` (truncation-signed remainder = fmod).
    """
    x1 = jnp.fmod(jnp.floor(x), 2.0)
    y1 = jnp.fmod(jnp.floor(y), 2.0)
    return jnp.where(
        jnp.fmod(x1 + y1, 2.0) < 1.0, p.checker_albedo[0], p.checker_albedo[1]
    )


def closest_hit(p: AnalyticalParams, ro: V3, rd: V3) -> SurfaceHit:
    """Vectorized closest_hit (analytical.rs:36-127, minus the emitter pass —
    that default-method logic lives in the integrator).

    The reference's sequential if-chains with strict `d < dist` become a
    first-occurrence argmin over [sphere0, sphere1, plane] — identical
    winner, including ties going to the earlier primitive.
    """
    dtype = jnp.asarray(rd.x).dtype
    n = jnp.shape(rd.x)

    c0 = V3(p.sphere_center.x[0], p.sphere_center.y[0], p.sphere_center.z[0])
    c1 = V3(p.sphere_center.x[1], p.sphere_center.y[1], p.sphere_center.z[1])
    t0 = ray_sphere(ro, rd, c0, p.sphere_radius[0])
    t1 = ray_sphere(ro, rd, c1, p.sphere_radius[1])
    tp = ray_plane(ro, rd, p.plane_normal, p.plane_point)

    ts = jnp.stack([t0, t1, tp], axis=0)  # [3, N]
    idx = jnp.argmin(ts, axis=0)  # first min wins, like the strict < chain
    t = jnp.min(ts, axis=0)
    hit = jnp.isfinite(t)

    # Normals: sphere -> normalize(hp - center); plane -> plane_normal
    # (analytical.rs:46, 77, 105).
    hp = ro + rd * jnp.where(hit, t, 0.0)
    center = where3(idx == 0, c0, c1)  # jnp.where broadcasts scalar centers
    n_sphere = safe_normalize(hp - center)
    n_plane = V3(
        jnp.broadcast_to(p.plane_normal.x, n),
        jnp.broadcast_to(p.plane_normal.y, n),
        jnp.broadcast_to(p.plane_normal.z, n),
    )
    normal = where3(idx == 2, n_plane, n_sphere)

    # Materials: gather from the table; plane rgb overridden by the checker
    # computed from the *ray direction* (analytical.rs:113).
    mat = gather_material(p.materials, idx)
    safe_dy = jnp.where(rd.y != 0.0, rd.y, 1.0)
    cx = rd.x / safe_dy * p.checker_scale + p.checker_offset
    cy = rd.z / safe_dy * p.checker_scale + p.checker_offset
    c = _checker(p, cx, cy)
    mat = select_material(
        idx == 2, mat._replace(rgb=splat3(c)), mat
    )
    # Missed lanes must carry Material::new defaults (tracer.rs:63 reset).
    mat = select_material(hit, mat, default_material(n, dtype))

    return SurfaceHit(t=jnp.where(hit, t, MISS), normal=normal, material=mat)


def any_hit(p: AnalyticalParams, ro: V3, rd: V3, max_dist) -> jnp.ndarray:
    """Shadow-ray occlusion (analytical.rs:130-145).

    Verbatim quirk preserved: the reference IGNORES max_dist — any hit at any
    distance occludes, even beyond the light. Pass
    `respect_max_dist=True` via make_scene to fix.
    """
    del max_dist
    c0 = V3(p.sphere_center.x[0], p.sphere_center.y[0], p.sphere_center.z[0])
    c1 = V3(p.sphere_center.x[1], p.sphere_center.y[1], p.sphere_center.z[1])
    t0 = ray_sphere(ro, rd, c0, p.sphere_radius[0])
    t1 = ray_sphere(ro, rd, c1, p.sphere_radius[1])
    tp = ray_plane(ro, rd, p.plane_normal, p.plane_point)
    return jnp.isfinite(t0) | jnp.isfinite(t1) | jnp.isfinite(tp)


def any_hit_respecting_max_dist(p: AnalyticalParams, ro: V3, rd: V3, max_dist):
    """Fixed-semantics occlusion (the flag-gated deviation)."""
    c0 = V3(p.sphere_center.x[0], p.sphere_center.y[0], p.sphere_center.z[0])
    c1 = V3(p.sphere_center.x[1], p.sphere_center.y[1], p.sphere_center.z[1])
    t0 = ray_sphere(ro, rd, c0, p.sphere_radius[0])
    t1 = ray_sphere(ro, rd, c1, p.sphere_radius[1])
    tp = ray_plane(ro, rd, p.plane_normal, p.plane_point)
    t = jnp.minimum(jnp.minimum(t0, t1), tp)
    return t < max_dist


def make_scene(
    dtype=jnp.float32,
    recursion_depth: int = 4,
    respect_max_dist: bool = False,
    params: AnalyticalParams | None = None,
    lights=None,
) -> Scene:
    """Assemble the demo scene: 1 spherical light at (3,2,2), r=1,
    emission (3,3,3) (analytical.rs:15-16), Pinhole defaults
    (pinhole.rs:14-25), recursion depth 4 (scene.rs:28-30).

    `lights` overrides the default light table (any mix of spherical /
    rectangular / distant lights via models.light constructors)."""
    return Scene(
        params=params if params is not None else default_params(dtype),
        camera=default_pinhole(dtype),
        lights=lights if lights is not None else spherical_light(
            (3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0), dtype=dtype
        ),
        background_fn=background,
        closest_hit_fn=closest_hit,
        any_hit_fn=any_hit_respecting_max_dist if respect_max_dist else any_hit,
        recursion_depth=recursion_depth,
    )


def make_media_scene(dtype=jnp.float32, recursion_depth: int = 6) -> Scene:
    """The demo scene with sphere 1 turned into glass holding an HG-phase
    scattering medium (the reference declares Medium but never uses it,
    material.rs:16-34; here free flight, phase-function NEE and HG
    continuation all run). Depth 6: media paths need the extra bounces
    through the interface. The benchmark's media cell."""
    from .material import MediumType

    scene = make_scene(dtype=dtype, recursion_depth=recursion_depth)
    mats = scene.params.materials
    mats = mats._replace(
        spec_trans=mats.spec_trans.at[1].set(1.0),
        metallic=mats.metallic.at[1].set(0.0),
        roughness=mats.roughness.at[1].set(0.05),
        ior=mats.ior.at[1].set(1.5),
    )
    med = mats.medium
    med = med._replace(
        medium_type=med.medium_type.at[1].set(int(MediumType.SCATTER)),
        density=med.density.at[1].set(0.6),
        color=med.color._replace(
            x=med.color.x.at[1].set(0.9),
            y=med.color.y.at[1].set(0.6),
            z=med.color.z.at[1].set(0.3),
        ),
        anisotropy=med.anisotropy.at[1].set(0.4),
    )
    return scene.replace(
        params=scene.params._replace(materials=mats._replace(medium=med))
    )
