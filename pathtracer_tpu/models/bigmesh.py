"""Large-triangle-mesh scene family: gather-free batched intersection.

The small-mesh backend (models/mesh.py) unrolls Möller-Trumbore per
triangle at trace time — ideal for tens of triangles, hopeless for
thousands (compile time and code size scale with T). This backend is the
scaling seam the reference's `trait Scene` was designed to carry
(rust-pathtracer/src/scene.rs:5-27: `closest_hit` / `any_hit` over
arbitrary content): it handles 1k+ triangles from a precomputed
per-triangle coefficient table.

Plücker-style reformulation: with per-ray features (d, m, o) where
m = o x d is the ray's moment vector, every Möller-Trumbore quantity is a
small dot product of ray features against 16 PER-TRIANGLE coefficients:

    det     = -(n . d)                       n   = e1 x e2
    u * det = (v0 x e2) . d  +  e2 . m
    v * det = (e1 x v0) . d  -  e1 . m
    t * det = n . o  -  v0 . n

(scalar-triple-product expansions of tvec.(d x e2), d.(tvec x e1),
e2.(tvec x e1) with tvec = o - v0; derivation checked numerically against
ops.intersect.ray_triangle in tests/test_bigmesh.py). So intersecting R
rays against T triangles is 19 fused multiply-adds per (ray, triangle)
pair over a precomputed [T, 16] coefficient table — dense, static-shaped,
gather-free elementwise work.

Triangles are Morton-ordered by centroid at build time (a static
permutation, so vertex gradients are unaffected) and grouped into chunks
of CHUNK; per-chunk AABBs (computed from live vertices, gradient-detached)
let the fused kernel (ops/megakernel_bigmesh.py) skip whole chunks no ray
of a tile can hit — a flat one-level BVH.

The XLA path below is the correctness twin: same tables, same formulas in
the same operation order (mt_terms / mt_hit_t are shared with the
kernel), fully differentiable w.r.t. vertices (the tables are pure jnp of
the vertex pytree). It expresses [N_rays, Tpad] pair matrices; XLA fuses
them into the min/argmin reductions rather than materializing them (it runs
at 1920x1080 on one GPU), but it tests every pair with no culling, so the
kernel backend is the fast path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intersect import MISS
from ..ops.vecmath import V3, cross, dot, mix, safe_normalize, splat3, v3, where3
from .camera import default_pinhole
from .light import spherical_light
from .material import (
    default_material,
    gather_material,
    make_material,
    select_material,
    stack_materials,
)
from .scene import Scene, SurfaceHit

EPS = 1e-7  # same guards as ops.intersect.ray_triangle
# Triangles per culling chunk: of 32 / 64 / 128 on the card, 32 was the
# fastest at every kernel tile height (PERF.md, Findings).
CHUNK = 32
FEAT = 16  # ray-feature basis [d(3), m(3), o(3), 1, pad(6)]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BigMeshParams:
    """Differentiable large-mesh scene parameters.

    `vertices` is a V3 of [V] arrays (differentiable — vertex gradients
    flow through the intersection tables). `tri_a/b/c` and `tri_mat` are
    STATIC tuples registered as aux data (Morton-ordered at build time);
    jit specializes on the topology, but unlike models/mesh.py nothing
    unrolls over it — the triangle count only sets table shapes."""

    vertices: V3  # [V], differentiable
    materials: object  # Material [M]
    sky_horizon: V3
    sky_zenith: V3
    sky_scale: jnp.ndarray
    tri_a: tuple = dataclasses.field(metadata=dict(static=True), default=())
    tri_b: tuple = dataclasses.field(metadata=dict(static=True), default=())
    tri_c: tuple = dataclasses.field(metadata=dict(static=True), default=())
    tri_mat: tuple = dataclasses.field(metadata=dict(static=True), default=())

    def _replace(self, **kw) -> "BigMeshParams":
        return dataclasses.replace(self, **kw)

    @property
    def num_tris(self) -> int:
        return len(self.tri_a)

    @property
    def tpad(self) -> int:
        return -(-self.num_tris // CHUNK) * CHUNK


def _tri_corners(p: BigMeshParams):
    """Gather the three corner V3s, [T] each (jnp.take on static indices)."""
    ia = jnp.asarray(p.tri_a, jnp.int32)
    ib = jnp.asarray(p.tri_b, jnp.int32)
    ic = jnp.asarray(p.tri_c, jnp.int32)

    def take(idx):
        return V3(
            jnp.take(p.vertices.x, idx),
            jnp.take(p.vertices.y, idx),
            jnp.take(p.vertices.z, idx),
        )

    return take(ia), take(ib), take(ic)


def mt_terms(cols, d, m, o):
    """Möller-Trumbore pair terms from the 16 coefficient columns.

    Shared VERBATIM (same operation order, so results agree to the last
    ulp) between the XLA twin and the Pallas kernel — only the broadcast
    orientation differs (XLA: cols [1, T] x rays [N, 1]; kernel: one
    triangle's scalar cols x a tile of rays). Column layout (see
    coef_tables):
    0-2 n | 3-5 v0 x e2 | 6-8 e2 | 9-11 e1 x v0 | 12-14 -e1 | 15 -v0.n"""
    det = -((cols[0] * d[0] + cols[1] * d[1]) + cols[2] * d[2])
    u_num = ((cols[3] * d[0] + cols[4] * d[1]) + cols[5] * d[2]) + (
        (cols[6] * m[0] + cols[7] * m[1]) + cols[8] * m[2])
    v_num = ((cols[9] * d[0] + cols[10] * d[1]) + cols[11] * d[2]) + (
        (cols[12] * m[0] + cols[13] * m[1]) + cols[14] * m[2])
    t_num = ((cols[0] * o[0] + cols[1] * o[1]) + cols[2] * o[2]) + cols[15]
    return det, u_num, v_num, t_num


def mt_hit_t(det, u_num, v_num, t_num, eps=EPS):
    """Validity + hit distance per (ray, triangle) pair; MISS where
    invalid. Division-form two-sided test — ops.intersect.ray_triangle's
    exact guard structure at the same eps: inv = 0 when |det| <= eps
    (which also keeps the BACKWARD pass clean — dividing by a tiny det
    in masked pairs would send 1/det^2 cotangents to inf through the
    jnp.where)."""
    absdet = jnp.abs(det)
    inv = jnp.where(
        absdet > eps, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0
    )
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    ok = (
        (absdet > eps)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps)
    )
    return jnp.where(ok, t, MISS)


def coef_tables(p: BigMeshParams):
    """Build the intersection tables (pure jnp of the vertex pytree, so
    vertex gradients flow through them).

    Returns:
      coef  [Tpad, 16] f32 — per-triangle mt_terms coefficients; padding
            rows are all-zero (det = 0 => never a hit).
      attrT [8, Tpad] f32 — rows [n.x, n.y, n.z, mat_id, 0...] for the
            kernel's indexed winner load (n is the UNnormalized geometric
            normal e1 x e2).
      aabb  [nchunk, 8] f32 — per-chunk [min.xyz, max.xyz, 0, 0] bounds,
            gradient-detached (culling decisions are discrete).
    """
    T, Tp = p.num_tris, p.tpad
    v0, v1, v2 = _tri_corners(p)
    e1, e2 = v1 - v0, v2 - v0
    n = cross(e1, e2)
    cud = cross(v0, e2)
    cvd = cross(e1, v0)
    zero = jnp.zeros_like(v0.x)
    coef = jnp.stack(
        [n.x, n.y, n.z,
         cud.x, cud.y, cud.z,
         e2.x, e2.y, e2.z,
         cvd.x, cvd.y, cvd.z,
         -e1.x, -e1.y, -e1.z,
         -dot(v0, n)],
        axis=1,
    )
    coef = jnp.pad(coef, ((0, Tp - T), (0, 0)))

    mat_ids = jnp.asarray(p.tri_mat, jnp.float32)
    attrT = jnp.stack(
        [n.x, n.y, n.z, mat_ids] + [zero] * 4, axis=0
    )
    attrT = jnp.pad(attrT, ((0, 0), (0, Tp - T)))

    # Chunk AABBs from live vertices; detached — culling is discrete, and
    # a conservative box stays conservative under infinitesimal moves.
    big = jnp.float32(3.4e38)
    mins = [jnp.pad(jnp.minimum(jnp.minimum(a, b), c), (0, Tp - T),
                    constant_values=big).reshape(-1, CHUNK).min(axis=1)
            for a, b, c in ((v0.x, v1.x, v2.x), (v0.y, v1.y, v2.y),
                            (v0.z, v1.z, v2.z))]
    maxs = [jnp.pad(jnp.maximum(jnp.maximum(a, b), c), (0, Tp - T),
                    constant_values=-big).reshape(-1, CHUNK).max(axis=1)
            for a, b, c in ((v0.x, v1.x, v2.x), (v0.y, v1.y, v2.y),
                            (v0.z, v1.z, v2.z))]
    nchunk = Tp // CHUNK
    aabb = jax.lax.stop_gradient(jnp.stack(
        mins + maxs + [jnp.zeros(nchunk, jnp.float32)] * 2, axis=1
    ))
    return coef.astype(jnp.float32), attrT.astype(jnp.float32), aabb


def _ray_rows(ro: V3, rd: V3):
    """Flattened-ray [N, 1] feature columns (d, m, o) for the XLA twin."""
    flat = lambda a: jnp.reshape(a, (-1, 1))
    mv = cross(ro, rd)
    return (
        [flat(rd.x), flat(rd.y), flat(rd.z)],
        [flat(mv.x), flat(mv.y), flat(mv.z)],
        [flat(ro.x), flat(ro.y), flat(ro.z)],
    )


def closest_hit(p: BigMeshParams, ro: V3, rd: V3) -> SurfaceHit:
    """Batched closest hit over the whole table (XLA correctness twin of
    the kernel backend; every (ray, triangle) pair, no culling)."""
    dtype = jnp.asarray(rd.x).dtype
    n_shape = jnp.shape(rd.x)
    coef, attrT, _ = coef_tables(p)
    cols = [coef[:, k][None, :] for k in range(FEAT)]  # [1, Tpad] each
    d, m, o = _ray_rows(ro, rd)
    t_pairs = mt_hit_t(*mt_terms(cols, d, m, o))  # [N, Tpad]
    t = jnp.min(t_pairs, axis=1)
    idx = jnp.argmin(t_pairs, axis=1)
    hit = jnp.isfinite(t)

    normal = safe_normalize(V3(
        jnp.take(attrT[0], idx),
        jnp.take(attrT[1], idx),
        jnp.take(attrT[2], idx),
    ))
    # Miss lanes gathered the all-zero padding row: give them a unit
    # up-normal — masked-lane shading math must stay NaN-free or its
    # cotangents poison live lanes' vertex gradients (same convention as
    # models/mesh.py's broadcast normal).
    normal = where3(hit, normal, V3(
        jnp.zeros_like(t), jnp.ones_like(t), jnp.zeros_like(t)
    ))
    flat = lambda a: jnp.reshape(a, (-1,))
    rdf = V3(flat(rd.x), flat(rd.y), flat(rd.z))
    normal = normal * jnp.where(dot(normal, rdf) > 0.0, -1.0, 1.0)

    mat_idx = jnp.take(attrT[3], idx).astype(jnp.int32)
    mat = gather_material(p.materials, mat_idx)
    mat = select_material(hit, mat, default_material(t.shape, dtype))

    reshape = lambda a: jnp.reshape(a, n_shape)
    mat = jax.tree_util.tree_map(reshape, mat)
    return SurfaceHit(
        t=reshape(jnp.where(hit, t, MISS)),
        normal=V3(reshape(normal.x), reshape(normal.y), reshape(normal.z)),
        material=mat,
    )


def any_hit(p: BigMeshParams, ro: V3, rd: V3, max_dist) -> jnp.ndarray:
    """Occlusion bounded by max_dist (fixed semantics)."""
    n_shape = jnp.shape(rd.x)
    coef, _, _ = coef_tables(p)
    cols = [coef[:, k][None, :] for k in range(FEAT)]
    d, m, o = _ray_rows(ro, rd)
    t_pairs = mt_hit_t(*mt_terms(cols, d, m, o))
    md = jnp.reshape(jnp.broadcast_to(max_dist, n_shape), (-1, 1))
    return jnp.reshape(jnp.any(t_pairs < md, axis=1), n_shape)


def background(p: BigMeshParams, rd: V3) -> V3:
    t = 0.5 * (rd.y + 1.0)
    return mix(p.sky_horizon, p.sky_zenith, t).to_linear() * splat3(p.sky_scale)


# ---------------------------------------------------------------------------
# Demo geometry: tessellated UV sphere (>= 1k triangles) over a ground quad
# ---------------------------------------------------------------------------


def uv_sphere(center, radius, stacks=17, sectors=34):
    """Tessellated sphere: (stacks-2)*sectors*2 + 2*sectors triangles
    (17 x 34 -> 1088)."""
    cx, cy, cz = center
    verts = [(cx, cy + radius, cz)]
    for i in range(1, stacks):
        phi = np.pi * i / stacks
        for j in range(sectors):
            th = 2.0 * np.pi * j / sectors
            verts.append((
                cx + radius * np.sin(phi) * np.cos(th),
                cy + radius * np.cos(phi),
                cz + radius * np.sin(phi) * np.sin(th),
            ))
    verts.append((cx, cy - radius, cz))
    bot = len(verts) - 1
    ring = lambda i, j: 1 + (i - 1) * sectors + (j % sectors)
    tris = []
    for j in range(sectors):
        tris.append((0, ring(1, j + 1), ring(1, j)))
    for i in range(1, stacks - 1):
        for j in range(sectors):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            tris += [(a, b, d), (a, d, c)]
    for j in range(sectors):
        tris.append((bot, ring(stacks - 1, j), ring(stacks - 1, j + 1)))
    return verts, tris


def morton_order(verts, tris):
    """Static permutation of the triangle list by centroid Morton code —
    spatially compact chunks so the per-chunk AABB culling bites."""
    v = np.asarray(verts, np.float64)
    cent = v[np.asarray(tris)].mean(axis=1)
    lo, hi = cent.min(axis=0), cent.max(axis=0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def grid_quad(corner, du, dv, nu=8, nv=8):
    """Tessellated parallelogram: nu x nv x 2 triangles. Small triangles
    keep the Morton chunks spatially compact (two scene-spanning ground
    triangles would make their chunks uncullable)."""
    cx, cy, cz = corner
    verts, tris = [], []
    for i in range(nu + 1):
        for j in range(nv + 1):
            fi, fj = i / nu, j / nv
            verts.append((cx + fi * du[0] + fj * dv[0],
                          cy + fi * du[1] + fj * dv[1],
                          cz + fi * du[2] + fj * dv[2]))
    at = lambda i, j: i * (nv + 1) + j
    for i in range(nu):
        for j in range(nv):
            a, b, c, d = at(i, j), at(i + 1, j), at(i + 1, j + 1), at(i, j + 1)
            tris += [(a, b, c), (a, c, d)]
    return verts, tris


def default_params(dtype=jnp.float32, ground_grid: int = 0) -> BigMeshParams:
    """Demo: 1088-triangle orange clearcoat sphere + ground (1090
    triangles total) under the analytical demo's sky.

    ground_grid > 0 tessellates the ground into grid x grid x 2 triangles
    instead of one quad — an option for cull studies on bigger scenes
    (tighter chunk AABBs against an extra chunk of triangles)."""
    verts, tris, mats = [], [], []

    def add(vs, ts, mat_id):
        base = len(verts)
        verts.extend(vs)
        tris.extend(tuple(base + i for i in t) for t in ts)
        mats.extend([mat_id] * len(ts))

    s = 6.0
    if ground_grid > 0:
        add(*grid_quad((-s, -1.0, -s), (2 * s, 0.0, 0.0), (0.0, 0.0, 2 * s),
                       nu=ground_grid, nv=ground_grid), mat_id=0)
    else:
        add([(-s, -1.0, -s), (s, -1.0, -s), (s, -1.0, s), (-s, -1.0, s)],
            [(0, 1, 2), (0, 2, 3)], 0)
    add(*uv_sphere((0.0, 0.0, 0.0), 1.0), mat_id=1)

    order = morton_order(verts, tris)
    tris = [tris[i] for i in order]
    mats = [mats[i] for i in order]

    mat_ground = make_material(dtype, rgb=(0.55, 0.57, 0.62), roughness=0.9)
    mat_sphere = make_material(
        dtype, rgb=(1.0, 0.186, 0.0), clearcoat=1.0, clearcoat_gloss=1.0,
        roughness=0.15,
    )
    xs = jnp.asarray([p[0] for p in verts], dtype)
    ys = jnp.asarray([p[1] for p in verts], dtype)
    zs = jnp.asarray([p[2] for p in verts], dtype)
    return BigMeshParams(
        vertices=V3(xs, ys, zs),
        materials=stack_materials([mat_ground, mat_sphere]),
        sky_horizon=v3(1.0, 1.0, 1.0, dtype=dtype),
        sky_zenith=v3(0.5, 0.7, 1.0, dtype=dtype),
        sky_scale=jnp.asarray(0.5, dtype),
        tri_a=tuple(t[0] for t in tris),
        tri_b=tuple(t[1] for t in tris),
        tri_c=tuple(t[2] for t in tris),
        tri_mat=tuple(mats),
    )


def make_scene(
    dtype=jnp.float32,
    recursion_depth: int = 4,
    params: BigMeshParams | None = None,
    lights=None,
) -> Scene:
    """Assemble the big-mesh demo scene (same light/camera placement as the
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
