"""Triangle-mesh scene family: the third first-class scene backend.

The reference ships only analytic spheres + a plane and aspires to more
("render classic analytical shapes and signed distance functions",
/root/reference/Readme.md:76-84); this adds what it never had — triangle
meshes — through the same Scene protocol (models/scene.py) and, via
ops/megakernel_mesh.py, the same fused Pallas fast path. Intersection is
two-sided Möller-Trumbore (ops/intersect.ray_triangle) with first-min-wins
closest-hit like the reference's strict `<` chains.

Design notes: triangle VERTEX POSITIONS are differentiable pytree
leaves (vertex gradients flow through Möller-Trumbore automatically — mesh
geometry is optimizable exactly like sphere centers); triangle INDICES and
per-triangle material ids are static structure (they enter the kernel's
meta, not the packed float vector — the where-chain over triangles is
unrolled at trace time, so there is no gather in the hot loop). Intended
for the small, code-defined meshes this framework's demo scenes use
(tens of triangles); large meshes would want a BVH backend, which the
KernelBackend protocol leaves room for.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops.intersect import MISS, ray_triangle
from ..ops.vecmath import V3, cross, dot, mix, safe_normalize, splat3, v3, where3
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


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshParams:
    """Differentiable mesh scene parameters.

    `vertices` is a V3 of [V] arrays (differentiable). `tri_idx` and
    `tri_mat` are STATIC tuples — ((i0, i1, i2), ...) and (mat_id, ...) —
    registered as aux data, so jit specializes on the topology and the
    kernel unrolls over it (no gathers in the hot loop)."""

    vertices: V3  # [V], differentiable
    materials: Material  # [M]
    sky_horizon: V3
    sky_zenith: V3
    sky_scale: jnp.ndarray
    tri_idx: tuple = dataclasses.field(metadata=dict(static=True), default=())
    tri_mat: tuple = dataclasses.field(metadata=dict(static=True), default=())

    def _replace(self, **kw) -> "MeshParams":
        return dataclasses.replace(self, **kw)


def _cube(center, half):
    cx, cy, cz = center
    vs = [
        (cx - half, cy - half, cz - half), (cx + half, cy - half, cz - half),
        (cx + half, cy + half, cz - half), (cx - half, cy + half, cz - half),
        (cx - half, cy - half, cz + half), (cx + half, cy - half, cz + half),
        (cx + half, cy + half, cz + half), (cx - half, cy + half, cz + half),
    ]
    quads = [
        (0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7),
        (1, 5, 6, 2), (3, 2, 6, 7), (4, 5, 1, 0),
    ]
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    return vs, tris


def default_params(dtype=jnp.float32) -> MeshParams:
    """Demo mesh: ground quad + metal cube + orange pyramid under the
    analytical scene's sky and light placement."""
    verts: list = []
    tris: list = []
    mats: list = []

    def add(vs, ts, mat_id):
        base = len(verts)
        verts.extend(vs)
        tris.extend(tuple(base + i for i in t) for t in ts)
        mats.extend([mat_id] * len(ts))

    s = 6.0
    add(
        [(-s, -1.0, -s), (s, -1.0, -s), (s, -1.0, s), (-s, -1.0, s)],
        [(0, 1, 2), (0, 2, 3)],
        0,
    )
    add(*_cube((-1.2, -0.35, 0.0), 0.65), mat_id=1)
    b, apex = 1.0, (1.3, 0.9, 0.0)
    add(
        [(1.3 - b, -1.0, -b), (1.3 + b, -1.0, -b), (1.3 + b, -1.0, b),
         (1.3 - b, -1.0, b), apex],
        [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4), (0, 2, 1), (0, 3, 2)],
        2,
    )

    mat_ground = make_material(dtype, rgb=(0.55, 0.57, 0.62), roughness=0.9)
    mat_cube = make_material(dtype, rgb=(1.0, 1.0, 1.0), roughness=0.1, metallic=1.0)
    mat_pyramid = make_material(
        dtype, rgb=(1.0, 0.186, 0.0), clearcoat=1.0, clearcoat_gloss=1.0,
        roughness=0.1,
    )

    xs = jnp.asarray([p[0] for p in verts], dtype)
    ys = jnp.asarray([p[1] for p in verts], dtype)
    zs = jnp.asarray([p[2] for p in verts], dtype)
    return MeshParams(
        vertices=V3(xs, ys, zs),
        materials=stack_materials([mat_ground, mat_cube, mat_pyramid]),
        sky_horizon=v3(1.0, 1.0, 1.0, dtype=dtype),
        sky_zenith=v3(0.5, 0.7, 1.0, dtype=dtype),
        sky_scale=jnp.asarray(0.5, dtype),
        tri_idx=tuple(tris),
        tri_mat=tuple(mats),
    )


def background(p: MeshParams, rd: V3) -> V3:
    t = 0.5 * (rd.y + 1.0)
    return mix(p.sky_horizon, p.sky_zenith, t).to_linear() * splat3(p.sky_scale)


def _vert(p: MeshParams, i: int) -> V3:
    return V3(p.vertices.x[i], p.vertices.y[i], p.vertices.z[i])


def _tri_ts(p: MeshParams, ro: V3, rd: V3):
    """Per-triangle hit distances (list of [N] arrays, trace-time unroll)."""
    return [
        ray_triangle(ro, rd, _vert(p, a), _vert(p, b), _vert(p, c))
        for a, b, c in p.tri_idx
    ]


def closest_hit(p: MeshParams, ro: V3, rd: V3) -> SurfaceHit:
    """First-min-wins closest hit over the triangle list, face-forward
    geometric normals (two-sided triangles), material gather by the
    winner's static material id."""
    dtype = jnp.asarray(rd.x).dtype
    n_shape = jnp.shape(rd.x)
    ts = _tri_ts(p, ro, rd)

    t = ts[0]
    idx = jnp.zeros(n_shape, jnp.int32)
    for i, ti in enumerate(ts[1:], start=1):
        take = ti < t
        idx = jnp.where(take, i, idx)
        t = jnp.where(take, ti, t)
    hit = jnp.isfinite(t)

    # Geometric normal of the winning triangle (where-chain over static
    # triangles), oriented against the ray (two-sided surfaces).
    a, b, c = p.tri_idx[0]
    normal = safe_normalize(cross(_vert(p, b) - _vert(p, a),
                                  _vert(p, c) - _vert(p, a)))
    normal = V3(
        jnp.broadcast_to(normal.x, n_shape),
        jnp.broadcast_to(normal.y, n_shape),
        jnp.broadcast_to(normal.z, n_shape),
    )
    for i, (a, b, c) in enumerate(p.tri_idx[1:], start=1):
        ni = safe_normalize(cross(_vert(p, b) - _vert(p, a),
                                  _vert(p, c) - _vert(p, a)))
        normal = where3(idx == i, ni, normal)
    normal = normal * jnp.where(dot(normal, rd) > 0.0, -1.0, 1.0)

    mat_of_tri = jnp.asarray(p.tri_mat, jnp.int32)
    mat = gather_material(p.materials, mat_of_tri[idx])
    mat = select_material(hit, mat, default_material(n_shape, dtype))
    return SurfaceHit(t=jnp.where(hit, t, MISS), normal=normal, material=mat)


def any_hit(p: MeshParams, ro: V3, rd: V3, max_dist) -> jnp.ndarray:
    """Occlusion bounded by max_dist (fixed semantics — the
    ignore-max_dist quirk is analytical-scene-specific)."""
    ts = _tri_ts(p, ro, rd)
    t = ts[0]
    for ti in ts[1:]:
        t = jnp.minimum(t, ti)
    return t < max_dist


def make_scene(
    dtype=jnp.float32,
    recursion_depth: int = 4,
    params: MeshParams | None = None,
    lights=None,
) -> Scene:
    """Assemble the mesh demo scene (same light/camera placement as the
    analytical demo, analytical.rs:15-16 / pinhole.rs:14-25)."""
    return Scene(
        params=params if params is not None else default_params(dtype),
        camera=default_pinhole(dtype),
        lights=lights if lights is not None else spherical_light(
            (3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0), dtype=dtype
        ),
        background_fn=background,
        closest_hit_fn=closest_hit,
        any_hit_fn=any_hit,
        recursion_depth=recursion_depth,
    )
