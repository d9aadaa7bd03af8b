"""Fused path-tracing kernel: the whole per-ray path loop in one Pallas call.

Where the XLA integrator (integrator/tracer.py) walks the bounce loop as a
lax.scan whose carry (the path state, about 22 planes) and the per-frame
uniform tensor round-trip device memory every bounce, this kernel keeps each
ray's state in registers for the ENTIRE path — camera ray generation, scene
intersection, the emitter pass, next-event estimation with MIS, and
four-lobe Disney BSDF sampling (reference: rust-pathtracer/src/tracer.rs:
22-220 + 441-626, renderer/src/analytical.rs:28-145) — writing only the final
radiance back. It is lowered through Triton (`backend="triton"`): one block
is a (tile_rows, LANES) tile of rays, one ray per thread. Two randomness
modes:

- uniforms="hbm": consumes the SAME threefry uniforms as the XLA path
  (integrator.tracer.draw_uniforms), loaded per tile. Identical sampling
  decisions, so the kernel is validated against the XLA integrator, which
  is itself validated against the f64 CPU oracle.
- uniforms="inkernel": the counter-based hash of ops/rng.py, evaluated
  where each uniform is consumed — no uniform tensor touches device memory.

Scene support is pluggable via `KernelBackend` (the in-kernel analog of the
reference's `trait Scene`, rust-pathtracer/src/scene.rs:5-90): this module
ships the analytical demo backend (2 spheres + checker plane + sky + L
lights of any type, any material table size M, specialized by static
unrolling — where-chains, no per-lane gathers); ops/megakernel_sdf.py,
ops/megakernel_mesh.py and ops/megakernel_bigmesh.py add the sphere-traced
SDF, small-mesh and kilo-triangle backends. Volumetric media (compiled in
only when the material table declares one) and procedural material hooks
(Scene.procedural_fn, traced into the kernel) run fused too.

The kernel reuses the SAME pure jnp building blocks as the XLA path
(ops.bsdf disney_sample/disney_eval, ops.sampling, ops.intersect,
models.material.finalize_material), so there is one implementation of the
BSDF math.

Differentiable: `render_frame_pallas` routes through a jax.custom_vjp whose
backward pass is the VJP of the XLA integrator on the kernel's own sample
stream (the same threefry rows, or the hash evaluated in XLA) for the same
rays — the detached-sampling estimator (integrator.tracer detach=True).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as _np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..integrator.tracer import EPS, U_PER_BOUNCE, VERBATIM, Quirks, draw_uniforms
from ..models.analytical import AnalyticalParams
from ..models.material import Material, Medium, default_material, finalize_material
from ..models.scene import Scene, SurfaceHit
from ..ops import rng
from ..ops.bsdf import disney_eval, disney_sample
from ..ops.intersect import ray_plane, ray_rect, ray_sphere
from ..ops.sampling import (
    hg_phase,
    power_heuristic,
    sample_hg,
    uniform_sample_hemisphere,
)
from ..ops.vecmath import (
    V3,
    dot,
    mix,
    normalize,
    onb,
    safe_normalize,
    splat3,
    to_world,
    where3,
    zeros3,
)

LANES = 32  # rays per tile row: one warp's width.
TILE_ROWS = 4  # default tile height: 128 rays per block, one per thread.

# ---------------------------------------------------------------------------
# Scene parameter packing: host pytree -> flat f32 vector -> in-kernel scalars
# ---------------------------------------------------------------------------

_MAT_FIELDS = (
    # (field, arity) — the Material fields the integrator consumes
    # (material.rs:48-78; medium is declared-but-unused, parity).
    ("rgb", 3),
    ("anisotropic", 1),
    ("emission", 3),
    ("metallic", 1),
    ("roughness", 1),
    ("subsurface", 1),
    ("specular_tint", 1),
    ("sheen", 1),
    ("sheen_tint", 1),
    ("clearcoat", 1),
    ("clearcoat_gloss", 1),
    ("spec_trans", 1),
    ("ior", 1),
    ("opacity", 1),
    ("alpha_mode", 1),  # packed as f32, cast back to i32 in-kernel
    ("alpha_cutoff", 1),
    # Medium (material.rs:16-34), flattened into the material record.
    ("medium_type", 1),  # packed as f32, cast back to i32 in-kernel
    ("medium_density", 1),
    ("medium_color", 3),
    ("medium_anisotropy", 1),
)
_MAT_STRIDE = sum(a for _, a in _MAT_FIELDS)  # 25
_MEDIUM_FIELDS = ("medium_type", "medium_density", "medium_color", "medium_anisotropy")


def _mat_leaf(materials: Material, name: str):
    """Field lookup that flattens the nested Medium record."""
    if name in _MEDIUM_FIELDS:
        attr = "medium_type" if name == "medium_type" else name.removeprefix("medium_")
        return getattr(materials.medium, attr)
    return getattr(materials, name)


def _v3_list(v: V3):
    return [v.x, v.y, v.z]


def pack_camera(scene: Scene, width: int, height: int) -> list:
    """Camera basis exactly as Pinhole::gen_ray precomputes it
    (camera/pinhole.rs:38-61): lower_left / horizontal / vertical / origin.
    Pure jnp on scene leaves — camera gradients flow through this pack."""
    cam = scene.camera
    f32 = jnp.float32
    ratio = width / height
    half_width = jnp.tan(jnp.deg2rad(cam.fov) * 0.5)
    half_height = half_width / ratio
    up = V3(jnp.asarray(0.0, f32), jnp.asarray(1.0, f32), jnp.asarray(0.0, f32))
    w = normalize(cam.origin - cam.center)
    u = up.cross(w)  # unnormalized, verbatim (pinhole.rs:49)
    v = w.cross(u)
    lower_left = cam.origin - u * half_width - v * half_height - w
    horizontal = u * (half_width * 2.0)
    vertical = v * (half_height * 2.0)
    return (
        _v3_list(lower_left)
        + _v3_list(horizontal)
        + _v3_list(vertical)
        + _v3_list(cam.origin)
    )


def pack_lights(scene: Scene) -> list:
    """Light table (globals.rs:75-84):
    L x [pos(3), emission(3), u(3), v(3), radius, area, type]."""
    f32 = jnp.float32
    vals: list = []
    lt = scene.lights
    for i in range(lt.count):
        vals += [lt.position.x[i], lt.position.y[i], lt.position.z[i]]
        vals += [lt.emission.x[i], lt.emission.y[i], lt.emission.z[i]]
        vals += [lt.u.x[i], lt.u.y[i], lt.u.z[i]]
        vals += [lt.v.x[i], lt.v.y[i], lt.v.z[i]]
        vals += [lt.radius[i], lt.area[i], lt.light_type[i].astype(f32)]
    return vals


def pack_materials(materials: Material, with_medium: bool = True) -> list:
    """Material table [M] (material.rs:48-78). The Medium fields are packed
    only for media-declaring scenes (with_medium == cfg.has_media) so
    media-free kernels keep the lean 19-scalar record."""
    f32 = jnp.float32
    vals: list = []
    M = int(materials.roughness.shape[0])
    for i in range(M):
        for name, arity in _MAT_FIELDS:
            if name in _MEDIUM_FIELDS and not with_medium:
                continue
            leaf = _mat_leaf(materials, name)
            if arity == 3:
                vals += [leaf.x[i], leaf.y[i], leaf.z[i]]
            elif name in ("alpha_mode", "medium_type"):
                vals.append(leaf[i].astype(f32))
            else:
                vals.append(leaf[i])
    return vals


def pack_scene(scene: Scene, width: int, height: int,
               with_medium: bool = True) -> jnp.ndarray:
    """Flatten camera-derived vectors + analytical params + lights into one
    f32 vector read by the kernel as scalars (one load per value)."""
    p: AnalyticalParams = scene.params
    f32 = jnp.float32

    vals: list = pack_camera(scene, width, height)

    # Spheres (analytical.rs:41,70).
    for i in range(2):
        vals += [p.sphere_center.x[i], p.sphere_center.y[i], p.sphere_center.z[i]]
    vals += [p.sphere_radius[0], p.sphere_radius[1]]

    # Plane + checker (analytical.rs:101-119).
    vals += _v3_list(p.plane_point) + _v3_list(p.plane_normal)
    vals += [p.checker_scale, p.checker_offset, p.checker_albedo[0], p.checker_albedo[1]]

    # Sky (analytical.rs:28-32).
    vals += _v3_list(p.sky_horizon) + _v3_list(p.sky_zenith) + [p.sky_scale]

    vals += pack_lights(scene)
    vals += pack_materials(p.materials, with_medium)

    flat = jnp.stack([jnp.asarray(x, f32) for x in vals])
    return flat[None, :]  # (1, P)


class _LaneRef:
    """Read adapter for the packed scalar ref: every value comes back
    broadcast to the tile shape. On the GPU a thread computes a "scalar"
    once either way, so this costs nothing there; it keeps scene-derived
    selects (e.g. `jnp.where(light_type == 1.0, 0.5, 1.0)`) off the Triton
    lowering's scalar select_n path, which types a weak float literal
    operand as the predicate's i1."""

    def __init__(self, ref, shape):
        self._ref = ref
        self._shape = shape

    def __getitem__(self, idx):
        return jnp.broadcast_to(self._ref[idx], self._shape)


class _CommonScalars:
    """Shared unpack of the (camera, lights, materials) segments."""

    def _read_camera(self):
        get = self._get
        self.lower_left = V3(get(), get(), get())
        self.horizontal = V3(get(), get(), get())
        self.vertical = V3(get(), get(), get())
        self.cam_origin = V3(get(), get(), get())

    def _read_lights(self, n_lights: int):
        get = self._get
        self.lights = []
        for _ in range(n_lights):
            self.lights.append(
                dict(
                    position=V3(get(), get(), get()),
                    emission=V3(get(), get(), get()),
                    u=V3(get(), get(), get()),
                    v=V3(get(), get(), get()),
                    radius=get(),
                    area=get(),
                    light_type=get(),
                )
            )

    def _read_materials(self, n_materials: int, with_medium: bool = True):
        get = self._get
        self.materials = []
        for _ in range(n_materials):
            m = {}
            for name, arity in _MAT_FIELDS:
                if name in _MEDIUM_FIELDS and not with_medium:
                    # Medium not packed (media-free kernel): constants with
                    # Medium::new defaults; every consumer DCEs away.
                    m[name] = (
                        zeros3((), jnp.float32) if arity == 3
                        else jnp.float32(0.0)
                    )
                    continue
                m[name] = V3(get(), get(), get()) if arity == 3 else get()
            self.materials.append(m)

    def _get(self):
        val = self._ref[0, self._off]
        self._off += 1
        return val

    def _material_table(self) -> Material:
        """Rebuild the material table as a Material pytree of _ScalarRow
        leaves ([M] per field, static indexing only) — the `params.materials`
        seen by in-kernel procedural hooks."""
        mats = self.materials
        M = len(mats)

        def row(name):
            return _ScalarRow([m[name] for m in mats])

        def row3(name):
            return V3(
                _ScalarRow([m[name].x for m in mats]),
                _ScalarRow([m[name].y for m in mats]),
                _ScalarRow([m[name].z for m in mats]),
            )

        zero = _ScalarRow([jnp.zeros((), jnp.float32)] * M)
        return Material(
            rgb=row3("rgb"),
            anisotropic=row("anisotropic"),
            emission=row3("emission"),
            metallic=row("metallic"),
            roughness=row("roughness"),
            subsurface=row("subsurface"),
            specular_tint=row("specular_tint"),
            sheen=row("sheen"),
            sheen_tint=row("sheen_tint"),
            clearcoat=row("clearcoat"),
            clearcoat_gloss=row("clearcoat_gloss"),
            clearcoat_roughness=zero,  # derived by finalize, not packed
            spec_trans=row("spec_trans"),
            ior=row("ior"),
            opacity=row("opacity"),
            alpha_mode=_ScalarRow(
                [m["alpha_mode"].astype(jnp.int32) for m in mats]
            ),
            alpha_cutoff=row("alpha_cutoff"),
            ax=zero,  # derived by finalize, not packed
            ay=zero,
            medium=Medium(
                medium_type=_ScalarRow(
                    [m["medium_type"].astype(jnp.int32) for m in mats]
                ),
                density=row("medium_density"),
                color=row3("medium_color"),
                anisotropy=row("medium_anisotropy"),
            ),
        )


class _ScalarRow:
    """A list of traced scalars posing as a 1-D array leaf for in-kernel
    procedural hooks (Scene.procedural_fn): supports static integer
    indexing (`leaf[i]`) and len/shape, nothing else. Hooks that need full
    array semantics (dynamic gathers, whole-leaf jnp ops) run through the
    XLA integrator instead."""

    def __init__(self, vals):
        self._vals = list(vals)

    def __getitem__(self, i):
        return self._vals[i]

    def __len__(self):
        return len(self._vals)

    @property
    def shape(self):
        return (len(self._vals),)


class _SceneScalars(_CommonScalars):
    """In-kernel view: reads pack_scene's layout back as traced scalars."""

    def __init__(self, ref, n_lights: int, n_materials: int,
                 with_medium: bool = True):
        self._ref = ref
        self._off = 0
        get = self._get

        self._read_camera()

        self.sphere_center = [V3(get(), get(), get()) for _ in range(2)]
        self.sphere_radius = [get() for _ in range(2)]

        self.plane_point = V3(get(), get(), get())
        self.plane_normal = V3(get(), get(), get())
        self.checker_scale = get()
        self.checker_offset = get()
        self.checker_albedo = [get(), get()]

        self.sky_horizon = V3(get(), get(), get())
        self.sky_zenith = V3(get(), get(), get())
        self.sky_scale = get()

        self._read_lights(n_lights)
        self._read_materials(n_materials, with_medium)

    def to_params(self) -> AnalyticalParams:
        """Rebuild the AnalyticalParams view handed to in-kernel procedural
        hooks — same pytree structure as the host scene.params, with array
        leaves as static-index _ScalarRow shims over the packed scalars
        (so hook reads stay differentiable through pack_scene)."""
        return AnalyticalParams(
            sphere_center=V3(
                _ScalarRow([c.x for c in self.sphere_center]),
                _ScalarRow([c.y for c in self.sphere_center]),
                _ScalarRow([c.z for c in self.sphere_center]),
            ),
            sphere_radius=_ScalarRow(self.sphere_radius),
            materials=self._material_table(),
            checker_scale=self.checker_scale,
            checker_offset=self.checker_offset,
            checker_albedo=_ScalarRow(self.checker_albedo),
            plane_point=self.plane_point,
            plane_normal=self.plane_normal,
            sky_horizon=self.sky_horizon,
            sky_zenith=self.sky_zenith,
            sky_scale=self.sky_scale,
        )


# ---------------------------------------------------------------------------
# Kernel-local scene functions (pallas-safe: where-chains, no gathers)
# ---------------------------------------------------------------------------


def _background(sc: _SceneScalars, rd: V3) -> V3:
    """Sky gradient (analytical.rs:28-32)."""
    t = 0.5 * (rd.y + 1.0)
    c = mix(sc.sky_horizon, sc.sky_zenith, t)
    return c.to_linear() * splat3(sc.sky_scale)


def _pick_material(sc, idx, shape) -> Material:
    """Material table lookup as a static where-chain — the gather-free
    replacement for models.material.gather_material inside the kernel."""
    M = len(sc.materials)

    def chain(field, arity):
        if arity == 3:
            out = sc.materials[M - 1][field] * splat3(jnp.ones(shape, jnp.float32))
            for i in reversed(range(M - 1)):
                out = where3(idx == i, splat3(jnp.ones(shape, jnp.float32)) * sc.materials[i][field], out)
            return out
        out = jnp.broadcast_to(sc.materials[M - 1][field], shape)
        for i in reversed(range(M - 1)):
            out = jnp.where(idx == i, sc.materials[i][field], out)
        return out

    base = default_material(shape, jnp.float32)
    fields = {name: chain(name, arity) for name, arity in _MAT_FIELDS}
    fields["alpha_mode"] = fields["alpha_mode"].astype(jnp.int32)
    medium = Medium(
        medium_type=fields.pop("medium_type").astype(jnp.int32),
        density=fields.pop("medium_density"),
        color=fields.pop("medium_color"),
        anisotropy=fields.pop("medium_anisotropy"),
    )
    return base._replace(medium=medium, **fields)


def _closest_hit(sc: _SceneScalars, ro: V3, rd: V3):
    """Vectorized closest_hit (analytical.rs:36-127): 2 spheres + plane with
    a procedural checker computed from the ray direction."""
    shape = jnp.shape(rd.x)
    c0, c1 = sc.sphere_center
    t0 = ray_sphere(ro, rd, c0, sc.sphere_radius[0])
    t1 = ray_sphere(ro, rd, c1, sc.sphere_radius[1])
    tp = ray_plane(ro, rd, sc.plane_normal, sc.plane_point)

    t = jnp.minimum(jnp.minimum(t0, t1), tp)
    # First-min-wins tie order matches the reference's strict `<` chains.
    idx = jnp.where(t == t0, 0, jnp.where(t == t1, 1, 2))
    hit = jnp.isfinite(t)

    hp = ro + rd * jnp.where(hit, t, 0.0)
    center = where3(idx == 0, c0, c1)
    n_sphere = safe_normalize(hp - center)
    n_plane = V3(
        jnp.broadcast_to(sc.plane_normal.x, shape),
        jnp.broadcast_to(sc.plane_normal.y, shape),
        jnp.broadcast_to(sc.plane_normal.z, shape),
    )
    normal = where3(idx == 2, n_plane, n_sphere)

    mat = _pick_material(sc, idx, shape)
    # Checker from ray direction (analytical.rs:107-115), incl. Rust fmod.
    safe_dy = jnp.where(rd.y != 0.0, rd.y, 1.0)
    cx = rd.x / safe_dy * sc.checker_scale + sc.checker_offset
    cy = rd.z / safe_dy * sc.checker_scale + sc.checker_offset
    x1 = jnp.fmod(jnp.floor(cx), 2.0)
    y1 = jnp.fmod(jnp.floor(cy), 2.0)
    checker = jnp.where(
        jnp.fmod(x1 + y1, 2.0) < 1.0, sc.checker_albedo[0], sc.checker_albedo[1]
    )
    mat = jax.tree_util.tree_map(
        lambda a, b: jnp.where(idx == 2, a, b),
        mat._replace(rgb=splat3(checker)),
        mat,
    )
    # Missed lanes carry Material::new defaults (tracer.rs:63 reset).
    defaults = default_material(shape, jnp.float32)
    mat = jax.tree_util.tree_map(lambda a, b: jnp.where(hit, a, b), mat, defaults)

    t = jnp.where(hit, t, jnp.inf)
    return t, normal, mat


def _any_hit(sc: _SceneScalars, ro: V3, rd: V3, max_dist):
    """Occlusion (analytical.rs:130-145) — verbatim quirk: ignores max_dist."""
    del max_dist
    c0, c1 = sc.sphere_center
    t0 = ray_sphere(ro, rd, c0, sc.sphere_radius[0])
    t1 = ray_sphere(ro, rd, c1, sc.sphere_radius[1])
    tp = ray_plane(ro, rd, sc.plane_normal, sc.plane_point)
    return jnp.isfinite(t0) | jnp.isfinite(t1) | jnp.isfinite(tp)


def _any_hit_respect(sc: _SceneScalars, ro: V3, rd: V3, max_dist):
    """Fixed-semantics occlusion (models/analytical.py
    any_hit_respecting_max_dist)."""
    c0, c1 = sc.sphere_center
    t0 = ray_sphere(ro, rd, c0, sc.sphere_radius[0])
    t1 = ray_sphere(ro, rd, c1, sc.sphere_radius[1])
    tp = ray_plane(ro, rd, sc.plane_normal, sc.plane_point)
    t = jnp.minimum(jnp.minimum(t0, t1), tp)
    return t < max_dist


def _sample_lights_emitter(sc, ro: V3, rd: V3, gate_dist):
    """Emitter-intersection pass (scene.rs:36-86), statically unrolled over
    the light list. Mirrors integrator.tracer.sample_lights_emitter:
    spherical verbatim, rectangular per the GLSL original, distant never
    hittable."""
    shape = jnp.shape(rd.x)
    dist = gate_dist
    hit = jnp.zeros(shape, bool)
    pdf = jnp.zeros(shape, jnp.float32)
    emission = zeros3(shape, jnp.float32)
    for lt in sc.lights:
        is_spherical = lt["light_type"] == 1.0
        is_rect = lt["light_type"] == 0.0
        d_s = ray_sphere(ro, rd, lt["position"], lt["radius"])
        d_r = ray_rect(ro, rd, lt["position"], lt["u"], lt["v"])
        d = jnp.where(is_spherical, d_s, jnp.where(is_rect, d_r, jnp.inf))
        take = jnp.isfinite(d) & (d < dist) & (is_spherical | is_rect)
        d_safe = jnp.where(take, d, 1.0)
        hit_point = ro + rd * jnp.where(take, d_safe, 0.0)
        sph_n = safe_normalize(hit_point - lt["position"])
        rect_n = safe_normalize(lt["u"].cross(lt["v"]))
        normal = where3(is_spherical, sph_n, rect_n)
        cos_theta = dot(-rd, normal)
        half = jnp.where(is_spherical, 0.5, 1.0)
        denom = lt["area"] * cos_theta * half
        pdf_i = (d_safe * d_safe) / jnp.where(denom != 0.0, denom, 1.0)
        dist = jnp.where(take, d_safe, dist)
        pdf = jnp.where(take, pdf_i, pdf)
        emission = where3(take, emission * 0.0 + lt["emission"], emission)
        hit = hit | take
    return hit, dist, pdf, emission


def _sample_light_unrolled(sc, scatter_pos: V3, u):
    """Uniform light pick + type-dispatched surface sampling
    (tracer.rs:136-145 + 173-220) unrolled as a where-chain over the
    static light list. Returns (normal, emission, direction, dist, pdf,
    area) for the picked light, all lanes."""
    u_pick, r1, r2 = u
    shape = jnp.shape(scatter_pos.x)
    L = len(sc.lights)

    idx = jnp.clip((u_pick * L).astype(jnp.int32), 0, L - 1)

    sampled = uniform_sample_hemisphere(r1, r2)

    def one(lt):
        """Type-dispatched sample_light (tracer.rs:173-220 + GLSL rect /
        distant variants) for one light, all lanes."""
        is_sph = lt["light_type"] == 1.0
        is_rect = lt["light_type"] == 0.0

        # Spherical candidate (tracer.rs:176-216).
        center_to_surf = scatter_pos - lt["position"]
        dist_to_center = center_to_surf.length()
        axis = center_to_surf / splat3(
            jnp.where(dist_to_center > 0.0, dist_to_center, 1.0)
        )
        t, b = onb(axis)
        sampled_dir = to_world(t, b, axis, sampled)
        sph_surface = lt["position"] + sampled_dir * splat3(lt["radius"])
        # Rect candidate (GLSL SampleRectLight).
        rect_surface = lt["position"] + lt["u"] * splat3(r1) + lt["v"] * splat3(r2)

        light_surface = where3(is_sph, sph_surface, rect_surface)
        direction = light_surface - scatter_pos
        dist = direction.length()
        dist_sq = dist * dist
        direction = direction / splat3(jnp.where(dist > 0.0, dist, 1.0))
        sph_n = safe_normalize(light_surface - lt["position"])
        rect_n = safe_normalize(lt["u"].cross(lt["v"]))
        normal = where3(is_sph, sph_n, rect_n)
        half = jnp.where(is_sph, 0.5, 1.0)
        denom = lt["area"] * half * jnp.abs(dot(normal, direction))
        pdf = dist_sq / jnp.where(denom != 0.0, denom, 1.0)

        # Distant candidate (GLSL SampleDistantLight): direction stored in
        # `position`, dist = inf, pdf = 1, area = 0 keeps MIS weight 1.
        dst_dir = safe_normalize(lt["position"])
        dst_n = safe_normalize(scatter_pos - lt["position"])
        is_dst = (~is_sph) & (~is_rect)
        direction = where3(is_dst, dst_dir, direction)
        normal = where3(is_dst, dst_n, normal)
        dist = jnp.where(is_dst, jnp.inf, dist)
        pdf = jnp.where(is_dst, 1.0, pdf)

        emission = lt["emission"] * float(L)  # tracer.rs:214
        return normal, emission, direction, dist, pdf, lt["area"]

    normal, emission, direction, dist, pdf, area = one(sc.lights[L - 1])
    # broadcast the last light's sample to full lanes, then select
    bcast = lambda v: jnp.broadcast_to(v, shape)
    b3 = lambda v: V3(bcast(v.x), bcast(v.y), bcast(v.z))
    normal, emission, direction = b3(normal), b3(emission), b3(direction)
    dist, pdf, area = bcast(dist), bcast(pdf), bcast(area)
    for i in reversed(range(L - 1)):
        ni, ei, di, si, pi, ai = one(sc.lights[i])
        take = idx == i
        normal = where3(take, ni, normal)
        emission = where3(take, ei, emission)
        direction = where3(take, di, direction)
        dist = jnp.where(take, si, dist)
        pdf = jnp.where(take, pi, pdf)
        area = jnp.where(take, ai, area)
    return normal, emission, direction, dist, pdf, area


def _direct_light(
    sc, any_hit_fn, rd: V3, fhp: V3, ffnormal: V3, material, eta, u,
    active=None,
):
    """NEE (tracer.rs:126-170) — surface variant: Disney BSDF eval + MIS.

    `active` (optional lane mask): lanes that are masked out by the caller
    or fail the light-facing test get max_dist = 0 for the occlusion query
    — boolean-identical (a non-facing/inactive lane's contribution is
    zeroed by `ok` / the caller's mask regardless of in_shadow), and for
    march-based backends it stops their shadow march after one block
    instead of marching the full light distance."""
    shape = jnp.shape(rd.x)
    if len(sc.lights) == 0:
        return zeros3(shape, jnp.float32)
    scatter_pos = fhp + ffnormal * EPS
    normal, emission, direction, dist, pdf, area = _sample_light_unrolled(
        sc, scatter_pos, u
    )
    facing = dot(direction, normal) < 0.0  # tracer.rs:148
    relevant = facing if active is None else (facing & active)
    in_shadow = any_hit_fn(
        sc, scatter_pos, direction, jnp.where(relevant, dist - EPS, 0.0)
    )
    f, bsdf_pdf = disney_eval(material, eta, -rd, ffnormal, direction)
    mis = jnp.where(area > 0.0, power_heuristic(pdf, bsdf_pdf), 1.0)
    ok = facing & (~in_shadow) & (bsdf_pdf > 0.0) & (pdf > 0.0)
    scale = jnp.where(ok, mis / jnp.where(pdf != 0.0, pdf, 1.0), 0.0)
    return emission * f * scale


def _scatter_direct_light(
    sc, any_hit_fn, rd: V3, scatter_pos: V3, g, u, active=None,
):
    """NEE from a volumetric scatter point (integrator.tracer
    _scatter_direct_light): the HG phase function p(cosθ; g) replaces the
    surface BSDF as both value and pdf in the MIS weight. `active` as in
    _direct_light (shadow-march cap gating, boolean-identical)."""
    shape = jnp.shape(rd.x)
    if len(sc.lights) == 0:
        return zeros3(shape, jnp.float32)
    normal, emission, direction, dist, pdf, area = _sample_light_unrolled(
        sc, scatter_pos, u
    )
    facing = dot(direction, normal) < 0.0  # tracer.rs:148
    relevant = facing if active is None else (facing & active)
    in_shadow = any_hit_fn(
        sc, scatter_pos, direction, jnp.where(relevant, dist - EPS, 0.0)
    )
    p = hg_phase(dot(rd, direction), g)
    mis = jnp.where(area > 0.0, power_heuristic(pdf, p), 1.0)
    ok = facing & (~in_shadow) & (p > 0.0) & (pdf > 0.0)
    scale = jnp.where(ok, mis * p / jnp.where(pdf != 0.0, pdf, 1.0), 0.0)
    return emission * splat3(scale)


# ---------------------------------------------------------------------------
# Backend protocol: the in-kernel `trait Scene`
# ---------------------------------------------------------------------------


class KernelBackend(NamedTuple):
    """Everything the generic kernel body needs from a scene type.

    meta is a hashable tuple of static structure (counts) produced by
    `meta_of(scene)`; `view(ref, meta)` rebuilds the scalar view inside the
    kernel; the three scene fns mirror trait Scene (scene.rs:5-90).

    `matches(scene) -> bool` claims a Scene for this backend (dispatch is
    first-registered-wins over `register_backend` order); `specialize`, if
    set, returns a per-scene variant of the backend (the analytical backend
    uses it to swap in the max_dist-respecting any_hit when the scene opts
    into the fixed shadow semantics). Third-party backends register with
    `register_backend` and need no edits here — see
    tests/test_backend_plugin.py for a complete out-of-tree example."""

    name: str
    pack: Callable  # (scene, width, height) -> (1, P) f32
    meta_of: Callable  # (scene) -> hashable tuple
    view: Callable  # (ref, meta) -> scalar view object (has .lights, camera)
    closest_hit: Callable  # (sc, ro, rd) -> (t, normal, material)
    any_hit: Callable  # (sc, ro, rd, max_dist) -> bool
    background: Callable  # (sc, rd) -> V3
    matches: Callable | None = None  # (scene) -> bool: claim this Scene
    specialize: Callable | None = None  # (scene, backend) -> backend
    march_based: bool = False  # intersection cost scales with ray length
    # Large-table backends (ops/megakernel_bigmesh.py) ship per-scene
    # tables too big for the packed scalar vector: `extra_of(scene)`
    # returns a tuple of f32 arrays handed to the kernel as whole-array
    # refs read by index; `view` then receives them as a third argument.
    extra_of: Callable | None = None  # (scene) -> tuple of arrays


def _analytical_meta(scene: Scene) -> tuple:
    return (
        scene.lights.count,
        int(scene.params.materials.roughness.shape[0]),
        scene.any_hit_fn.__name__ == "any_hit_respecting_max_dist",
    )


def _analytical_view(ref, meta):
    # meta = meta_of(scene) + (has_media,), appended by _render_tiles_pallas
    return _SceneScalars(ref, meta[0], meta[1], with_medium=meta[-1])


def _analytical_any_hit_dispatch(sc, ro, rd, max_dist, respect=False):
    return (_any_hit_respect if respect else _any_hit)(sc, ro, rd, max_dist)


def _analytical_matches(scene: Scene) -> bool:
    from ..models import analytical as _ana

    return scene.closest_hit_fn is _ana.closest_hit


def _analytical_specialize(scene: Scene, b: "KernelBackend") -> "KernelBackend":
    from ..models import analytical as _ana

    if scene.any_hit_fn is _ana.any_hit_respecting_max_dist:
        return b._replace(any_hit=_any_hit_respect)
    return b


ANALYTICAL_BACKEND = KernelBackend(
    name="analytical",
    pack=pack_scene,
    meta_of=_analytical_meta,
    view=_analytical_view,
    closest_hit=_closest_hit,
    any_hit=_any_hit,  # swapped per-scene by specialize
    background=_background,
    matches=_analytical_matches,
    specialize=_analytical_specialize,
)

_BACKENDS: dict[str, KernelBackend] = {"analytical": ANALYTICAL_BACKEND}


def register_backend(backend: KernelBackend) -> None:
    """Register a kernel scene backend (the in-kernel `impl Scene`).

    Dispatch is by `backend.matches(scene)`; anything a test or downstream
    package registers here is reachable from render_frame_pallas without
    edits to this module."""
    _BACKENDS[backend.name] = backend


def kernel_family(scene: Scene) -> str | None:
    """The family device.use_kernel routes on: the claiming backend's name,
    "media" for the analytical backend with media compiled in, or None when
    no backend claims the scene."""
    try:
        name = _resolve_backend(scene).name
    except NotImplementedError:
        return None
    if name == "analytical" and _detect_media(scene):
        return "media"
    return name


def _resolve_backend(scene: Scene) -> KernelBackend:
    """Pick the kernel backend whose `matches` claims this Scene."""
    try:
        from . import megakernel_bigmesh, megakernel_mesh, megakernel_sdf  # noqa: F401  (register "sdf"/"mesh"/"bigmesh")
    except ImportError:
        pass
    for b in _BACKENDS.values():
        if b.matches is not None and b.matches(scene):
            return b.specialize(scene, b) if b.specialize is not None else b
    raise NotImplementedError(
        "no Pallas kernel backend claims this scene's closest_hit_fn; "
        "register one via ops.megakernel.register_backend(KernelBackend(...))"
        " or use integrator.tracer.render_frame (XLA path)"
    )


# ---------------------------------------------------------------------------
# The generic path loop (shared by every backend)
# ---------------------------------------------------------------------------


def _mask3(mask, v: V3) -> V3:
    zero = jnp.zeros_like(v.x)
    return V3(
        jnp.where(mask, v.x, zero),
        jnp.where(mask, v.y, zero),
        jnp.where(mask, v.z, zero),
    )


def num_warps_for(tile_rows: int) -> int:
    """Warps per block for a (tile_rows, LANES) tile: one ray per thread.

    Triton blocks must have power-of-two sides, and the path state (about
    70 live values per ray) has to fit in a thread's registers, so a tile
    row is one warp and tile_rows must be a power of two up to 16."""
    if tile_rows < 1 or tile_rows > 16 or tile_rows & (tile_rows - 1):
        raise ValueError(
            f"tile_rows must be a power of two in [1, 16], got {tile_rows}"
        )
    return tile_rows * LANES // 32


def pad_pow2(sv: jnp.ndarray) -> jnp.ndarray:
    """Pad the packed (1, P) scalar vector to (1, 2^k) >= P: Triton block
    shapes are powers of two. Padding is zeros, never read."""
    p = int(sv.shape[1])
    p2 = 1 << max(0, (p - 1).bit_length())
    return jnp.pad(sv, ((0, 0), (0, p2 - p)))


def _tile_width(tiling: str, spp: int) -> int | None:
    """Pixel width of one tile under 2-D "block" tiling, or None for flat
    ray ranges. A block tile covers tile_rows pixel rows x LANES/spp pixel
    columns, a pixel's spp samples in adjacent lanes."""
    if tiling == "flat":
        return None
    if LANES % spp != 0:
        raise ValueError(
            f"tiling='block' requires spp to divide {LANES}, got {spp}"
        )
    return LANES // spp


def resolve_tiling(tiling: str, spp: int) -> str:
    """"auto" -> compact 2-D pixel blocks whenever spp divides the lane
    width (spatially coherent tiles keep the SDF march's block-level early
    exit tight), else flat ray ranges."""
    if tiling == "auto":
        return "block" if LANES % spp == 0 else "flat"
    if tiling not in ("flat", "block"):
        raise ValueError(f"tiling must be 'auto'|'flat'|'block', got {tiling!r}")
    return tiling


def num_tiles_for(width: int, height: int, spp: int, tile_rows: int,
                  tiling: str) -> int:
    """Tiles (blocks) covering the frame."""
    bw = _tile_width(tiling, spp)
    if bw is None:
        return -(-(width * height * spp) // (tile_rows * LANES))
    return -(-width // bw) * -(-height // tile_rows)


def _lane_rays(tile, row, col, tile_rows, width, height, spp, tiling,
               xp=jnp):
    """Global ray index (pixel * spp + sample) of lane (row, col) of tile
    `tile`. Broadcasting jnp: the kernel passes a scalar tile and iota
    planes, the XLA twin whole [T, tile_rows, LANES] grids (xp=numpy for
    the static lane map). Flat tiling
    leaves padded lanes past the frame's last ray (cropped on output);
    block tiling clamps edge tiles to the frame border."""
    bw = _tile_width(tiling, spp)
    if bw is None:
        return tile * (tile_rows * LANES) + row * LANES + col
    nbx = -(-width // bw)
    by = tile // nbx
    bx = tile - by * nbx
    px = xp.minimum(bx * bw + col // spp, width - 1)
    py = xp.minimum(by * tile_rows + row, height - 1)
    return (py * width + px) * spp + col % spp


def _raygen(sc, ray, spp, width, height, ox, oy):
    """Camera ray generation (tracer.rs:36-47 + pinhole.rs:38-61) for rays
    with global indices `ray`."""
    pid = jnp.minimum(ray // spp, width * height - 1)
    px = (pid % width).astype(jnp.float32)
    py = (pid // width).astype(jnp.float32)
    cx = px * jnp.float32(1.0 / width)
    cy = (jnp.float32(height - 1) - py) * jnp.float32(1.0 / height)

    rd = (
        (sc.lower_left - sc.cam_origin)
        + sc.horizontal * (jnp.float32(1.0 / width) * ox + cx)
        + sc.vertical * (jnp.float32(1.0 / height) * oy + cy)
    )
    rd = normalize(rd)
    shape = jnp.shape(ray)
    ro = V3(
        jnp.broadcast_to(sc.cam_origin.x, shape),
        jnp.broadcast_to(sc.cam_origin.y, shape),
        jnp.broadcast_to(sc.cam_origin.z, shape),
    )
    return ro, rd


def _tile_init_carry(ro: V3, rd: V3, quirks: Quirks, has_media: bool = False):
    """Fresh per-tile path carry (State::new / ScatterSampleRec::new).

    When the scene declares participating media (has_media) the carry
    additionally tracks the medium the ray travels in (State.medium,
    globals.rs:21/37): type, density, color, HG anisotropy."""
    shape = jnp.shape(rd.x)
    radiance = zeros3(shape, jnp.float32)
    throughput = splat3(jnp.ones(shape, jnp.float32))
    alive = jnp.ones(shape, bool)
    prev_pdf = (
        jnp.zeros(shape, jnp.float32)
        if quirks.primary_mis
        else jnp.full(shape, -1.0, jnp.float32)
    )
    prev_l = zeros3(shape, jnp.float32)
    prev_hit_dist = jnp.full(shape, -1.0, jnp.float32)
    carry = (ro, rd, radiance, throughput, alive, prev_pdf, prev_l, prev_hit_dist)
    if has_media:
        carry = carry + (
            jnp.zeros(shape, jnp.int32),  # med_type (vacuum)
            jnp.zeros(shape, jnp.float32),  # med_density
            zeros3(shape, jnp.float32),  # med_color
            jnp.zeros(shape, jnp.float32),  # med_aniso
        )
    return carry


def _tile_bounce(sc, backend: KernelBackend, carry, u6, quirks: Quirks,
                 has_media: bool = False, procedural=None):
    """One bounce of the fused tile loop (tracer.rs:61-103) — identical
    math to integrator.tracer.make_bounce_step, including participating
    media when the scene declares any (has_media; the media code is
    statically elided otherwise so media-free scenes pay nothing)."""
    (ro, rd, radiance, throughput, alive, prev_pdf, prev_l, prev_hit_dist) = carry[:8]
    if has_media:
        med_type, med_density, med_color, med_aniso = carry[8:]

    if backend.march_based:
        # Dead-lane probe rays: every output a dead lane produces below is
        # masked by `alive`, so its closest_hit result is never observed —
        # but for march-based backends (SDF) the tile's block-granular
        # early exit still waits on EVERY lane's march. Pointing dead
        # lanes from far above the scene straight up makes them escape in
        # one march block instead of re-tracing their stale full-distance
        # ray every remaining bounce (measure_occupancy_pallas counts the
        # dead lane-bounces). Bit-identical for
        # alive lanes; no RNG draws are involved. Closed-form backends
        # skip this (the where-selects cost more than they save there).
        one = jnp.ones(jnp.shape(rd.x), jnp.float32)
        probe_ro = where3(alive, ro, V3(0.0 * one, 1.0e3 * one, 0.0 * one))
        probe_rd = where3(alive, rd, V3(0.0 * one, one, 0.0 * one))
        t, normal, material = backend.closest_hit(sc, probe_ro, probe_rd)
    else:
        t, normal, material = backend.closest_hit(sc, ro, rd)
    if procedural is not None:
        # Post-hit procedural material hook (Scene.procedural_fn — the
        # realization of the reference's dormant rhai scripting surface,
        # material.rs:77), traced straight into the kernel. The params
        # view is rebuilt from the packed scalars.
        material = procedural(
            sc.to_params(), SurfaceHit(t=t, normal=normal, material=material),
            ro, rd,
        )
    geo_hit = jnp.isfinite(t)

    if quirks.stale_emitter_gate:
        gate_dist = jnp.where(geo_hit, t, prev_hit_dist)
    else:
        gate_dist = jnp.where(geo_hit, t, jnp.inf)
    em_hit, em_dist, em_pdf, em_emission = _sample_lights_emitter(
        sc, ro, rd, gate_dist
    )

    hit = geo_hit | em_hit
    hit_dist = jnp.where(em_hit, em_dist, gate_dist)

    if has_media:
        # Volumetric segment effects + single-scatter event, mirroring
        # integrator.tracer.make_bounce_step (Absorb = Beer-Lambert,
        # Emissive = color*density*t, Scatter = exponential free flight
        # with HG-phase NEE + continuation).
        seg = jnp.where(hit, hit_dist, 0.0)
        seg_on = alive & hit & (med_type != 0)
        absorbing = seg_on & (med_type == 1)
        emitting = seg_on & (med_type == 3)
        ext = splat3(med_density * seg)
        att = V3(
            jnp.exp(-(1.0 - med_color.x) * ext.x),
            jnp.exp(-(1.0 - med_color.y) * ext.y),
            jnp.exp(-(1.0 - med_color.z) * ext.z),
        )
        radiance = radiance + _mask3(
            emitting, med_color * splat3(med_density * seg) * throughput
        )
        throughput = where3(absorbing, throughput * att, throughput)

        u_dist = u6[7]
        sigma = jnp.maximum(med_density, 1e-12)
        s_free = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-12)) / sigma
        scat = (
            alive & hit & (med_type == 2) & (med_density > 0.0)
            & (s_free < hit_dist)
        )
        scatter_pos = ro + rd * jnp.where(scat, s_free, 0.0)
        throughput = where3(scat, throughput * med_color, throughput)
        ld_s = _scatter_direct_light(
            sc, backend.any_hit, rd, scatter_pos, med_aniso, u6[0:3],
            active=scat,
        )
        radiance = radiance + _mask3(scat, ld_s * throughput)
        l_hg = sample_hg(rd, med_aniso, u6[3], u6[4])
        pdf_hg = hg_phase(dot(rd, l_hg), med_aniso)
    else:
        scat = jnp.zeros(jnp.shape(rd.x), bool)

    bg = backend.background(sc, rd)
    radiance = radiance + _mask3(alive & ~hit, bg * throughput)

    material = finalize_material(material)
    fhp = ro + rd * jnp.where(hit, hit_dist, 0.0)
    entering = dot(normal, rd) <= 0.0
    ffnormal = where3(entering, normal, -normal)
    eta = jnp.where(dot(rd, normal) < 0.0, 1.0 / material.ior, material.ior)

    # Alpha pass-through (mirrors integrator.tracer: Blend
    # stochastic coin u6[6], Mask deterministic cutoff).
    am = material.alpha_mode
    alpha_fail = ((am == 1) & (u6[6] > material.opacity)) | (
        (am == 2) & (material.opacity < material.alpha_cutoff)
    )
    passthru = alive & hit & ~em_hit & alpha_fail & ~scat

    radiance = radiance + _mask3(
        alive & hit & ~passthru & ~scat, material.emission * throughput
    )

    mis_w = power_heuristic(jnp.maximum(prev_pdf, 0.0), em_pdf)
    if not quirks.primary_mis:
        mis_w = jnp.where(prev_pdf < 0.0, 1.0, mis_w)
    radiance = radiance + _mask3(
        alive & em_hit & ~scat, em_emission * mis_w * throughput
    )

    live = alive & hit & ~em_hit & ~scat
    shade = live & ~passthru

    ld = _direct_light(
        sc, backend.any_hit, rd, fhp, ffnormal, material, eta, u6[0:3],
        active=shade,
    )
    radiance = radiance + _mask3(shade, ld * throughput)

    bs = disney_sample(
        material, eta, -rd, ffnormal, prev_l, tuple(u6[3:6])
    )
    cont = shade & (bs.pdf > 0.0)
    safe_pdf = jnp.where(bs.pdf > 0.0, bs.pdf, 1.0)
    throughput = where3(cont, throughput * bs.f / splat3(safe_pdf), throughput)

    ro_next = where3(cont, fhp + bs.l * EPS, ro)
    rd_next = where3(cont, bs.l, rd)
    ro_next = where3(passthru, fhp + rd * EPS, ro_next)
    rd_next = where3(passthru, rd, rd_next)
    prev_pdf_new = jnp.where(shade, bs.pdf, prev_pdf)
    prev_l_new = where3(shade, bs.l, prev_l)
    prev_hit_dist = jnp.where(alive & hit, hit_dist, prev_hit_dist)

    if has_media:
        # Volumetric scatter: continue from the scatter point along the
        # HG-sampled direction (still inside the medium).
        ro_next = where3(scat, scatter_pos, ro_next)
        rd_next = where3(scat, l_hg, rd_next)
        prev_pdf_new = jnp.where(scat, pdf_hg, prev_pdf_new)
        prev_l_new = where3(scat, l_hg, prev_l_new)
        alive = cont | passthru | scat

        # Medium transition on refraction through the surface (GLSL
        # original: entering a front face adopts the hit material's
        # medium, exiting returns to vacuum).
        transmitted = shade & cont & (dot(bs.l, ffnormal) < 0.0)
        enter_m = transmitted & entering
        exit_m = transmitted & ~entering
        mmed = material.medium
        med_type = jnp.where(
            enter_m, mmed.medium_type, jnp.where(exit_m, 0, med_type)
        )
        med_density = jnp.where(
            enter_m, mmed.density, jnp.where(exit_m, 0.0, med_density)
        )
        zero3 = zeros3(jnp.shape(bs.pdf), jnp.float32)
        med_color = where3(
            enter_m, mmed.color, where3(exit_m, zero3, med_color)
        )
        med_aniso = jnp.where(
            enter_m, mmed.anisotropy, jnp.where(exit_m, 0.0, med_aniso)
        )
        return (
            ro_next, rd_next, radiance, throughput, alive, prev_pdf_new,
            prev_l_new, prev_hit_dist, med_type, med_density, med_color,
            med_aniso,
        )

    alive = cont | passthru
    return (
        ro_next, rd_next, radiance, throughput, alive, prev_pdf_new,
        prev_l_new, prev_hit_dist,
    )




def _occ_width(depth: int) -> int:
    """Power-of-two width of the per-tile occupancy row (>= depth)."""
    return 1 << max(0, (depth - 1).bit_length())


def _trace_path(view, backend, ro: V3, rd: V3, uniform, depth: int,
                quirks: Quirks, has_media: bool = False, procedural=None,
                instrument: bool = False):
    """The fused per-ray bounce loop (the vectorized tracer.rs:61-103) as
    one fori_loop over bounces. Returns (radiance, counts): counts is a
    (1, _occ_width(depth)) i32 row of alive-lane counts ENTERING each
    bounce when instrument=True (the in-kernel analog of
    integrator.tracer.measure_occupancy), else None.

    `view()` rebuilds the backend's scalar view inside the loop body, so
    the scene scalars are re-read per bounce instead of held in registers
    across the loop."""
    carry = _tile_init_carry(ro, rd, quirks, has_media)
    occ_cols = jax.lax.broadcasted_iota(jnp.int32, (1, _occ_width(depth)), 1)
    counts = jnp.zeros((1, _occ_width(depth)), jnp.int32)

    def body(b, state):
        carry, counts = state
        if instrument:
            alive = jnp.sum(carry[4].astype(jnp.float32)).astype(jnp.int32)
            counts = jnp.where(occ_cols == b, alive, counts)
        first = 2 + b * U_PER_BOUNCE
        u = tuple(uniform(first + j) for j in range(U_PER_BOUNCE))
        carry = _tile_bounce(view(), backend, carry, u, quirks, has_media,
                             procedural)
        return carry, counts

    carry, counts = jax.lax.fori_loop(0, depth, body, (carry, counts))
    return carry[2], (counts if instrument else None)


class _KernelConfig(NamedTuple):
    """Hashable static configuration of one kernel launch."""

    backend_name: str
    meta: tuple
    width: int
    height: int
    spp: int
    depth: int
    tile_rows: int
    quirks: Quirks
    inkernel_rng: bool
    interpret: bool
    respect_max_dist: bool = False
    has_media: bool = False
    procedural: Callable | None = None
    tiling: str = "block"  # "flat" ray ranges | "block" 2-D pixel rectangles


def _cfg_backend(cfg: _KernelConfig) -> KernelBackend:
    b = _BACKENDS[cfg.backend_name]
    if cfg.backend_name == "analytical" and cfg.respect_max_dist:
        b = b._replace(any_hit=_any_hit_respect)
    return b


def _make_kernel(cfg: _KernelConfig, n_extra: int = 0,
                 instrument: bool = False):
    """Kernel body for one (tile_rows, LANES) tile: raygen + fused path
    loop + radiance writeback (+ the occupancy row when instrumented).
    n_extra whole-array backend refs (KernelBackend.extra_of) arrive after
    u_ref and are handed to backend.view."""
    backend = _cfg_backend(cfg)
    shape = (cfg.tile_rows, LANES)

    def body(sp_ref, seed_ref, base_ref, u_ref, *rest):
        extra_refs = rest[:n_extra]
        r_ref, g_ref, b_ref, *occ_refs = rest[n_extra:]

        def view():
            ref = _LaneRef(sp_ref, shape)
            if n_extra:
                return backend.view(ref, cfg.meta, extra_refs)
            return backend.view(ref, cfg.meta)

        tile = base_ref[0, 0] + pl.program_id(0)
        ray = _lane_rays(
            tile,
            jax.lax.broadcasted_iota(jnp.int32, shape, 0),
            jax.lax.broadcasted_iota(jnp.int32, shape, 1),
            cfg.tile_rows, cfg.width, cfg.height, cfg.spp, cfg.tiling,
        )
        if cfg.inkernel_rng:
            key = rng.ray_key(seed_ref[0, 0], ray)

            def uniform(j):
                return rng.uniform(key, j)
        else:

            def uniform(j):
                return u_ref[j]

        ro, rd = _raygen(view(), ray, cfg.spp, cfg.width, cfg.height,
                         uniform(0), uniform(1))
        radiance, counts = _trace_path(
            view, backend, ro, rd, uniform, cfg.depth, cfg.quirks,
            has_media=cfg.has_media, procedural=cfg.procedural,
            instrument=instrument,
        )
        r_ref[...] = radiance.x
        g_ref[...] = radiance.y
        b_ref[...] = radiance.z
        if instrument:
            occ_refs[0][...] = counts

    return body


def _whole(a) -> pl.BlockSpec:
    """Every block sees the whole array (read by index)."""
    return pl.BlockSpec(a.shape, lambda i, _n=a.ndim: (0,) * _n)


def _launch(cfg: _KernelConfig, num_tiles: int, sv, seed, base, u_all,
            extras=(), instrument: bool = False):
    """One Triton launch over num_tiles tiles -> (r, g, b) planes of shape
    (num_tiles * tile_rows, LANES) (+ the (num_tiles, _occ_width) i32
    occupancy rows when instrumented)."""
    tr = cfg.tile_rows
    plane = jax.ShapeDtypeStruct((num_tiles * tr, LANES), jnp.float32)
    plane_spec = pl.BlockSpec((tr, LANES), lambda i: (i, 0))
    if cfg.inkernel_rng:
        u_spec = _whole(u_all)  # placeholder, never read
    else:
        u_spec = pl.BlockSpec((u_all.shape[0], tr, LANES), lambda i: (0, i, 0))
    out_specs = [plane_spec] * 3
    out_shape = [plane] * 3
    if instrument:
        w = _occ_width(cfg.depth)
        out_specs.append(pl.BlockSpec((1, w), lambda i: (i, 0)))
        out_shape.append(jax.ShapeDtypeStruct((num_tiles, w), jnp.int32))
    return pl.pallas_call(
        _make_kernel(cfg, len(extras), instrument),
        grid=(num_tiles,),
        in_specs=[_whole(sv), _whole(seed), _whole(base), u_spec]
        + [_whole(e) for e in extras],
        out_specs=out_specs,
        out_shape=out_shape,
        interpret=cfg.interpret,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps_for(tr), num_stages=1
        ),
        name=f"path_{cfg.backend_name}",
    )(sv, seed, base, u_all, *extras)


def _kernel_planes(cfg: _KernelConfig, num_tiles: int, scene: Scene, seed,
                   base, u_all):
    backend = _cfg_backend(cfg)
    sv = pad_pow2(backend.pack(scene, cfg.width, cfg.height, cfg.has_media))
    extras = backend.extra_of(scene) if backend.extra_of is not None else ()
    return tuple(_launch(cfg, num_tiles, sv, seed, base, u_all, extras))


def _xla_planes(cfg: _KernelConfig, num_tiles: int, scene: Scene, seed, base,
                u_all):
    """The XLA integrator on exactly the kernel's rays and sample stream,
    laid out as the kernel's (r, g, b) planes — the function whose VJP is
    the kernel's backward rule (detached-sampling estimator)."""
    from ..integrator.tracer import trace
    from ..models.camera import gen_ray
    from ..ops.vecmath import V2

    tr, w, h = cfg.tile_rows, cfg.width, cfg.height
    tiles = base[0, 0] + jnp.arange(num_tiles, dtype=jnp.int32)[:, None, None]
    ray = _lane_rays(
        tiles,
        jnp.arange(tr, dtype=jnp.int32)[None, :, None],
        jnp.arange(LANES, dtype=jnp.int32)[None, None, :],
        tr, w, h, cfg.spp, cfg.tiling,
    ).reshape(-1)
    if cfg.inkernel_rng:
        cam_u, bounce_u = rng.hash_uniforms_for(
            seed[0, 0], ray, cfg.depth, U_PER_BOUNCE
        )
    else:
        u = u_all.reshape(u_all.shape[0], -1)
        cam_u = u[:2].T
        bounce_u = u[2:].reshape(cfg.depth, U_PER_BOUNCE, -1).transpose(0, 2, 1)
    pid = jnp.minimum(ray // cfg.spp, w * h - 1)
    px = (pid % w).astype(jnp.float32)
    py = (pid // w).astype(jnp.float32)
    coords = V2(px / w, (h - 1.0 - py) / h)
    ro, rd = gen_ray(scene.camera, coords, V2(cam_u[:, 0], cam_u[:, 1]),
                     float(w), float(h))
    rad = trace(scene, ro, rd, bounce_u, cfg.quirks, detach=True,
                remat=BWD_REMAT)
    return tuple(c.reshape(num_tiles * tr, LANES) for c in (rad.x, rad.y, rad.z))


# The backward rule's XLA VJP stores each bounce's residuals (False) or
# recomputes them (True); measured on the card, PERF.md.
BWD_REMAT = False


@lru_cache(maxsize=None)
def _diff_planes(cfg: _KernelConfig, num_tiles: int):
    """custom-VJP tile render. Forward = the fused kernel; backward = the
    VJP of _xla_planes on the same rays and uniforms. seed / base /
    uniforms get zero cotangents (randomness and tile indexing are not
    differentiated)."""

    @jax.custom_vjp
    def planes(scene, seed, base, u_all):
        return _kernel_planes(cfg, num_tiles, scene, seed, base, u_all)

    def fwd(scene, seed, base, u_all):
        return planes(scene, seed, base, u_all), (scene, seed, base, u_all)

    def bwd(res, ct):
        scene, seed, base, u_all = res
        _, vjp = jax.vjp(
            lambda s: _xla_planes(cfg, num_tiles, s, seed, base, u_all), scene
        )
        (g_scene,) = vjp(tuple(ct))
        return g_scene, None, None, None

    planes.defvjp(fwd, bwd)
    return planes


def _uniform_rows(key, n: int, depth: int, spp: int = 1):
    """Threefry uniforms [2 + depth * U_PER_BOUNCE, n] in ray order (ray
    r = pixel * spp + sample), rows in draw order [ox, oy, bounce0 u0..u7,
    ...] — the XLA integrator's values exactly. At spp > 1
    tracer.render_frame splits the key into spp subkeys and draws a
    per-sample stream over the w*h pixels, so ray pid*spp + s takes
    sample s's stream at pixel pid."""
    npix = n // spp
    draws = (
        [draw_uniforms(key, npix, depth, jnp.float32)] if spp == 1
        else [draw_uniforms(k, npix, depth, jnp.float32)
              for k in jax.random.split(key, spp)]
    )

    def interleave(per_sample):  # spp arrays of [npix] -> [npix*spp]
        return jnp.stack(per_sample, axis=1).reshape(-1)

    rows = [interleave([cam[:, j] for cam, _ in draws]) for j in (0, 1)]
    for d in range(depth):
        for j in range(U_PER_BOUNCE):
            rows.append(interleave([bu[d, :, j] for _, bu in draws]))
    return jnp.stack(rows)


@lru_cache(maxsize=None)
def _lane_ray_map(width: int, height: int, spp: int, tile_rows: int,
                  tiling: str, num_tiles: int) -> _np.ndarray:
    """Static map: kernel lane (tile, row, col), flattened -> global ray
    index, -1 for padded lanes past the frame's last ray."""
    ray = _lane_rays(
        _np.arange(num_tiles)[:, None, None],
        _np.arange(tile_rows)[None, :, None],
        _np.arange(LANES)[None, None, :],
        tile_rows, width, height, spp, tiling, xp=_np,
    )
    ray = ray.reshape(-1)
    return _np.where(ray < width * height * spp, ray, -1)


def _hbm_lanes(key, width, height, spp, depth, tile_rows, tiling,
               total_tiles):
    """Threefry rows in kernel-lane layout [U, total_tiles*tile_rows,
    LANES]; padded lanes read 0.5 (their output is cropped)."""
    rows = _uniform_rows(key, width * height * spp, depth, spp)
    lanes = _lane_ray_map(width, height, spp, tile_rows, tiling, total_tiles)
    u = jnp.where(lanes >= 0, rows[:, _np.maximum(lanes, 0)], 0.5)
    return u.reshape(rows.shape[0], total_tiles * tile_rows, LANES)


def _detect_media(scene: Scene) -> bool:
    """True if any material in the (concrete) table declares a medium.
    Traced leaves (inside an outer jit) default to False."""
    try:
        return bool(
            (_np.asarray(scene.params.materials.medium.medium_type) != 0).any()
        )
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError):
        # Traced leaves (inside an outer jit): cannot inspect — caller must
        # pass media= explicitly. Any OTHER exception is a real bug in the
        # material table and must propagate, not silently drop volumetrics.
        return False


def _render_tiles_pallas(
    scene: Scene,
    key,
    width: int,
    height: int,
    spp: int,
    quirks: Quirks,
    tile_rows: int,
    uniforms: str,
    interpret: bool,
    backend_name: str,
    tile_base: int | jnp.ndarray = 0,
    num_tiles: int | None = None,
    has_media: bool = False,
    tiling: str = "block",
    instrument: bool = False,
):
    """Shared launch path: returns the raw (r, g, b) tile planes.

    tile_base/num_tiles carve out a contiguous tile range — the shard_map
    path (parallel/mesh.render_frame_sharded_pallas) gives each device its
    own range; the sample stream is keyed on the global ray index, so the
    sharded render computes the single-device launch's samples."""
    if uniforms not in ("inkernel", "hbm"):
        raise ValueError(f"uniforms must be 'inkernel'|'hbm', got {uniforms!r}")
    backend = _BACKENDS[backend_name]
    depth = scene.recursion_depth
    total_tiles = num_tiles_for(width, height, spp, tile_rows, tiling)
    if num_tiles is None:
        num_tiles = total_tiles

    # Trailing meta element: whether the medium fields are packed — the
    # scalar views key their material-record layout off it.
    meta = backend.meta_of(scene) + (has_media,)
    if uniforms == "hbm":
        u_all = _hbm_lanes(key, width, height, spp, depth, tile_rows, tiling,
                           total_tiles)
        if not isinstance(tile_base, int) or tile_base != 0:
            # This device's tile range out of the global rows. Pad first:
            # when the device count doesn't divide total_tiles, a range can
            # straddle the end, and dynamic_slice would CLAMP the start —
            # shifting valid tiles onto the wrong uniforms.
            u_all = jnp.pad(
                u_all, ((0, 0), (0, num_tiles * tile_rows), (0, 0)),
                constant_values=0.5,
            )
            zero = jnp.zeros((), jnp.int32)
            u_all = jax.lax.dynamic_slice(
                u_all,
                (zero, jnp.asarray(tile_base, jnp.int32) * tile_rows, zero),
                (u_all.shape[0], num_tiles * tile_rows, LANES),
            )
        seed = jnp.zeros((1, 1), jnp.int32)
    else:
        seed = jax.random.randint(
            key, (1, 1), 0, jnp.iinfo(jnp.int32).max, jnp.int32
        )
        u_all = jnp.zeros((1, tile_rows, LANES), jnp.float32)  # never read

    # A runtime value even when 0: the compiled kernel reads it at run time
    # anyway, and in interpret mode a constant base would let XLA fold the
    # single-device kernel body differently from the sharded one (last-ulp
    # image differences between the two launches).
    base = jax.lax.optimization_barrier(
        jnp.asarray(tile_base, jnp.int32).reshape(1, 1)
    )
    cfg = _KernelConfig(
        backend_name=backend_name,
        meta=meta,
        width=width,
        height=height,
        spp=spp,
        depth=depth,
        tile_rows=tile_rows,
        quirks=quirks,
        inkernel_rng=(uniforms == "inkernel"),
        interpret=interpret,
        respect_max_dist=(backend_name == "analytical" and bool(meta[2])),
        has_media=has_media,
        procedural=scene.procedural_fn,
        tiling=tiling,
    )
    if instrument:
        backend = _cfg_backend(cfg)
        sv = pad_pow2(backend.pack(scene, width, height, has_media))
        extras = backend.extra_of(scene) if backend.extra_of is not None else ()
        return _launch(cfg, int(num_tiles), sv, seed, base, u_all, extras,
                       instrument=True)
    return _diff_planes(cfg, int(num_tiles))(scene, seed, base, u_all)


def assemble_image(planes, width: int, height: int, spp: int, tile_rows: int,
                   tiling: str):
    """(r, g, b) tile planes -> [H, W, 4] image (spp mean, alpha 1). Planes
    may carry surplus tiles past the frame (cropped)."""
    bw = _tile_width(tiling, spp)
    n = width * height * spp
    if bw is not None:
        nbx, nby = -(-width // bw), -(-height // tile_rows)

        def finish(c):
            c = c[: nby * nbx * tile_rows]
            c = c.reshape(nby, nbx, tile_rows, bw, spp).mean(axis=-1)
            c = c.transpose(0, 2, 1, 3).reshape(nby * tile_rows, nbx * bw)
            return c[:height, :width]
    else:

        def finish(c):
            c = c.reshape(-1)[:n].reshape(height * width, spp).mean(axis=1)
            return c.reshape(height, width)

    r, g, b = planes
    return jnp.stack(
        [finish(r), finish(g), finish(b), jnp.ones((height, width), jnp.float32)],
        axis=-1,
    )


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "quirks", "tile_rows", "uniforms",
        "interpret", "backend_name", "has_media", "tiling",
    ),
)
def _render_frame_pallas(
    scene: Scene,
    key,
    width: int,
    height: int,
    spp: int,
    quirks: Quirks,
    tile_rows: int,
    uniforms: str,
    interpret: bool,
    backend_name: str,
    has_media: bool,
    tiling: str,
) -> jnp.ndarray:
    planes = _render_tiles_pallas(
        scene, key, width, height, spp, quirks, tile_rows, uniforms,
        interpret, backend_name, has_media=has_media, tiling=tiling,
    )
    return assemble_image(planes, width, height, spp, tile_rows, tiling)


def render_frame_pallas(
    scene: Scene,
    key,
    width: int,
    height: int,
    spp: int = 1,
    quirks: Quirks = VERBATIM,
    tile_rows: int | None = None,
    uniforms: str = "inkernel",
    interpret: bool = False,
    media: bool | None = None,
    tiling: str = "auto",
) -> jnp.ndarray:
    """Render one progressive frame with the fused kernel.

    Drop-in for integrator.tracer.render_frame on every scene a backend
    claims: returns [H, W, 4] linear RGBA. Differentiable w.r.t. scene
    parameters (custom VJP: the XLA integrator's VJP on the kernel's own
    sample stream, detached-sampling estimator).

    uniforms: "inkernel" (the ops/rng hash, no uniform tensor) or "hbm"
    (threefry rows identical to the XLA integrator's, for validation).
    interpret: run the Pallas interpreter — honoured on the CPU only
    (device.pallas_interpret); on the GPU the compiled kernel always runs.
    tile_rows: tile height (power of two <= 16; None = TILE_ROWS).
    tiling: "auto" picks compact 2-D pixel-block tiles whenever spp
    divides the lane width (resolve_tiling). Images are tiling-invariant:
    both uniform modes are keyed on the global ray index.
    media: compile the volumetric-media path into the kernel. None
    auto-detects from the concrete material table; pass True explicitly
    when jitting over scenes whose materials are traced AND declare media.
    """
    from .. import device

    backend = _resolve_backend(scene)
    if media is None:
        media = _detect_media(scene)
    tile_rows = TILE_ROWS if tile_rows is None else tile_rows
    num_warps_for(tile_rows)  # validate before tracing
    return _render_frame_pallas(
        scene, key, width, height,
        spp=spp, quirks=quirks, tile_rows=tile_rows, uniforms=uniforms,
        interpret=device.pallas_interpret(interpret),
        backend_name=backend.name, has_media=media,
        tiling=resolve_tiling(tiling, spp),
    )


def measure_occupancy_pallas(
    scene: Scene,
    key,
    width: int,
    height: int,
    spp: int = 1,
    quirks: Quirks = VERBATIM,
    tile_rows: int | None = None,
    uniforms: str = "inkernel",
    interpret: bool = False,
    tiling: str = "auto",
):
    """Masked-lane occupancy measured INSIDE the fused kernel: the real
    kernel with an extra i32 output of per-tile alive-lane counts entering
    each bounce (the masked `break`s of tracer.rs:66-97). Returns a dict:
      alive_fraction [depth] — mean alive fraction entering each bounce;
      wasted_fraction        — 1 - mean(alive_fraction): the ceiling on
                               what ray compaction could recover;
      counts [num_tiles, depth] raw per-tile counts (spatial structure).
    """
    from .. import device

    backend = _resolve_backend(scene)
    tiling = resolve_tiling(tiling, spp)
    tile_rows = TILE_ROWS if tile_rows is None else tile_rows
    depth = scene.recursion_depth
    num_tiles = num_tiles_for(width, height, spp, tile_rows, tiling)
    out = _render_tiles_pallas(
        scene, key, width, height, spp, quirks, tile_rows, uniforms,
        device.pallas_interpret(interpret), backend.name,
        has_media=_detect_media(scene), tiling=tiling, instrument=True,
    )
    counts = _np.asarray(out[3])[:, :depth]
    tile = tile_rows * LANES
    # Edge tiles carry border-clamped duplicate lanes (block) or padded
    # rays (flat); their bounce-0 counts still equal the tile size, so the
    # fractions model the lanes the hardware actually runs.
    alive_fraction = counts.mean(axis=0) / float(tile)
    return {
        "alive_fraction": alive_fraction,
        "wasted_fraction": 1.0 - float(alive_fraction.mean()),
        "counts": counts,
        "tile": tile,
        "num_tiles": int(num_tiles),
        "tiling": tiling,
    }


def debug_uniform_stream(seed: int, n_rays: int, n_uniforms: int,
                         interpret: bool = False) -> jnp.ndarray:
    """The kernel's in-kernel uniform stream, evaluated by a Triton kernel:
    [n_uniforms, n_rays] f32, entry (j, r) = draw j of global ray r
    (n_rays a multiple of TILE_ROWS * LANES). tests/test_rng.py checks it
    bit for bit against the XLA evaluation (ops/rng.hash_uniforms) and
    runs uniformity and independence checks on it."""
    from .. import device

    tile = TILE_ROWS * LANES
    if n_rays % tile:
        raise ValueError(f"n_rays must be a multiple of {tile}")
    shape = (TILE_ROWS, LANES)

    def body(seed_ref, out_ref):
        ray = (
            pl.program_id(0) * tile
            + jax.lax.broadcasted_iota(jnp.int32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        )
        key = rng.ray_key(seed_ref[0, 0], ray)
        out_ref[...] = rng.uniform(key, pl.program_id(1))[None]

    seed_arr = jnp.asarray([[seed]], jnp.int32)
    out = pl.pallas_call(
        body,
        grid=(n_rays // tile, n_uniforms),
        in_specs=[pl.BlockSpec((1, 1), lambda i, j: (0, 0))],
        out_specs=pl.BlockSpec((1, TILE_ROWS, LANES), lambda i, j: (j, i, 0)),
        out_shape=jax.ShapeDtypeStruct(
            (n_uniforms, n_rays // LANES, LANES), jnp.float32
        ),
        interpret=device.pallas_interpret(interpret),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps_for(TILE_ROWS), num_stages=1
        ),
        name="uniform_stream",
    )(seed_arr)
    return out.reshape(n_uniforms, n_rays)
