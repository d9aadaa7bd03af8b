"""Fused-kernel backend for the large-triangle-mesh scene family.

Puts models/bigmesh.py in the fused kernel. Each ray (one per thread) walks
the Morton-ordered triangle list one triangle at a time: the triangle's 16
precomputed Möller-Trumbore coefficients (models/bigmesh.coef_tables) are
scalar loads shared by the whole block, the pair math is the shared
mt_terms/mt_hit_t in the same operation order as the XLA twin, and the
running nearest hit is a (t, index) pair in registers. The winner's normal
and material id are then one indexed load per ray. Chunks of CHUNK
triangles are guarded by an AABB slab test under lax.cond — a block-uniform
branch that skips chunks no ray of the tile can hit (a flat one-level BVH).

The triangle tables are too big for the packed scalar vector and enter
through the KernelBackend.extra_of protocol as whole-array refs. Gradients
(vertex positions included) come from the XLA twin (models/bigmesh.
closest_hit, pure jnp of the vertex pytree) through the kernel's custom VJP.

Reference anchor: the backend seam this scales is rust-pathtracer
src/scene.rs:5-27 (`closest_hit` / `any_hit` for arbitrary content is the
trait's whole point); the reference itself ships only analytic spheres and
a plane.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as _np

from ..models.bigmesh import CHUNK, EPS, mt_hit_t, mt_terms
from ..models.material import default_material
from ..models.scene import Scene
from ..ops.vecmath import V3, cross, dot, mix, safe_normalize, splat3, where3
from .megakernel import (
    KernelBackend,
    _CommonScalars,
    _pick_material,
    pack_camera,
    pack_lights,
    pack_materials,
    register_backend,
)


def pack_bigmesh_scene(scene: Scene, width: int, height: int,
                       with_medium: bool = True) -> jnp.ndarray:
    """Camera + sky + lights + materials only — triangle tables go through
    extra_of, not the packed scalar vector."""
    p = scene.params
    vals: list = pack_camera(scene, width, height)
    vals += [p.sky_horizon.x, p.sky_horizon.y, p.sky_horizon.z]
    vals += [p.sky_zenith.x, p.sky_zenith.y, p.sky_zenith.z]
    vals += [p.sky_scale]
    vals += pack_lights(scene)
    vals += pack_materials(p.materials, with_medium)
    return jnp.stack([jnp.asarray(x, jnp.float32) for x in vals])[None, :]


def _bigmesh_extras(scene: Scene):
    """(coef [Tpad, 16], attrT [8, Tpad], aabb [nchunk, 8]) — see
    models/bigmesh.coef_tables."""
    from ..models.bigmesh import coef_tables

    return coef_tables(scene.params)


class _BigMeshScalars(_CommonScalars):
    """In-kernel view: packed scalars for camera/sky/lights/materials,
    whole-array refs for the triangle tables."""

    def __init__(self, ref, meta, extras):
        n_lights, n_mats, num_tris, tpad, with_medium = meta
        self._ref = ref
        self._off = 0
        get = self._get
        self._read_camera()
        self.sky_horizon = V3(get(), get(), get())
        self.sky_zenith = V3(get(), get(), get())
        self.sky_scale = get()
        self._read_lights(n_lights)
        self._read_materials(n_mats, with_medium)
        self.coef_ref, self.attr_ref, self.aabb_ref = extras
        self.num_tris = num_tris
        self.nchunk = tpad // CHUNK

    def to_params(self):
        raise NotImplementedError(
            "procedural hooks are not supported by the bigmesh kernel "
            "backend (triangle tables are whole-array refs, not packed "
            "scalars); use the XLA path (integrator.tracer.render_frame)"
        )


def _bigmesh_view(ref, meta, extras):
    return _BigMeshScalars(ref, meta, extras)


def _ray_features(ro: V3, rd: V3):
    """Per-ray (d, m, o) feature planes, m = o x d the ray's moment."""
    mv = cross(ro, rd)
    return [rd.x, rd.y, rd.z], [mv.x, mv.y, mv.z], [ro.x, ro.y, ro.z]


def _inv_d(d):
    """Safe per-axis reciprocal directions for the slab test."""
    return [
        1.0 / jnp.where(jnp.abs(dk) > 1e-20, dk, jnp.float32(1e-20))
        for dk in d
    ]


def _chunk_cull(sc, c, o, invd, t_far0):
    """Block-uniform predicate: can chunk c produce a hit in (EPS, t_far0)
    for ANY ray of the tile? Robust slab test against the chunk AABB;
    conservative because the AABB bounds the triangles exactly (equal-t
    candidates never update the strict < fold, so strict interval pruning
    keeps results exact)."""
    # traced zero from o (NOT t_far0: inf * 0 = NaN would veto every chunk)
    t_near = o[0] * 0.0 + jnp.float32(EPS)
    t_far = t_far0
    for k in range(3):
        lo = sc.aabb_ref[c, k]
        hi = sc.aabb_ref[c, 3 + k]
        t0 = (lo - o[k]) * invd[k]
        t1 = (hi - o[k]) * invd[k]
        t_near = jnp.maximum(t_near, jnp.minimum(t0, t1))
        t_far = jnp.minimum(t_far, jnp.maximum(t0, t1))
    return jnp.sum(jnp.where(
        t_near <= t_far, jnp.float32(1.0), jnp.float32(0.0))) > 0.0


def _tri_t(sc, tri, d, m, o):
    """Hit distance of every ray against triangle `tri` (MISS if none)."""
    cols = [sc.coef_ref[tri, k] for k in range(16)]
    return mt_hit_t(*mt_terms(cols, d, m, o))


def _closest_hit_bigmesh(sc: _BigMeshScalars, ro: V3, rd: V3):
    """models/bigmesh.closest_hit, one triangle at a time: a first-win
    running minimum over the Morton-ordered list (the XLA twin's argmin),
    then one indexed load of the winner's normal and material id."""
    shape = jnp.shape(rd.x)
    d, m, o = _ray_features(ro, rd)
    invd = _inv_d(d)
    inf = jnp.float32(_np.inf)

    def chunk_body(c, carry):
        def do(carry):
            def tri_body(i, carry):
                bt, bi = carry
                tri = c * CHUNK + i
                tc = _tri_t(sc, tri, d, m, o)
                upd = tc < bt
                return jnp.where(upd, tc, bt), jnp.where(upd, tri, bi)

            return jax.lax.fori_loop(0, CHUNK, tri_body, carry)

        return jax.lax.cond(
            _chunk_cull(sc, c, o, invd, carry[0]), do, lambda cr: cr, carry
        )

    bt, bi = jax.lax.fori_loop(
        0, sc.nchunk, chunk_body,
        (jnp.full(shape, inf, jnp.float32), jnp.zeros(shape, jnp.int32)),
    )
    hit = bt < inf
    normal = safe_normalize(V3(
        sc.attr_ref[0, bi], sc.attr_ref[1, bi], sc.attr_ref[2, bi]
    ))
    # Miss lanes read triangle 0's row: a unit up-normal keeps masked-lane
    # shading NaN-free (matches models/bigmesh.closest_hit).
    one = jnp.ones(shape, jnp.float32)
    normal = where3(hit, normal, V3(0.0 * one, one, 0.0 * one))
    normal = normal * jnp.where(dot(normal, rd) > 0.0, -1.0, 1.0)
    mat_idx = sc.attr_ref[3, bi].astype(jnp.int32)
    mat = _pick_material(sc, mat_idx, shape)
    defaults = default_material(shape, jnp.float32)
    mat = jax.tree_util.tree_map(
        lambda a, b: jnp.where(hit, a, b), mat, defaults
    )
    return jnp.where(hit, bt, inf), normal, mat


def _any_hit_bigmesh(sc: _BigMeshScalars, ro: V3, rd: V3, max_dist):
    """Occlusion bounded by max_dist: the same triangle walk, no winner."""
    shape = jnp.shape(rd.x)
    d, m, o = _ray_features(ro, rd)
    invd = _inv_d(d)
    md = jnp.broadcast_to(max_dist, shape)

    def chunk_body(c, occ):
        def do(occ):
            def tri_body(i, occ):
                tc = _tri_t(sc, c * CHUNK + i, d, m, o)
                return jnp.where(tc < md, jnp.float32(1.0), occ)

            return jax.lax.fori_loop(0, CHUNK, tri_body, occ)

        # bound by max_dist, zeroed where the lane is already occluded
        still = jnp.where(occ > 0.0, 0.0, md)
        return jax.lax.cond(_chunk_cull(sc, c, o, invd, still), do,
                            lambda oc: oc, occ)

    occ = jax.lax.fori_loop(0, sc.nchunk, chunk_body,
                            jnp.zeros(shape, jnp.float32))
    return occ > 0.0


def _background_bigmesh(sc: _BigMeshScalars, rd: V3) -> V3:
    t = 0.5 * (rd.y + 1.0)
    return mix(sc.sky_horizon, sc.sky_zenith, t).to_linear() * splat3(sc.sky_scale)


def _bigmesh_meta(scene: Scene) -> tuple:
    p = scene.params
    return (
        scene.lights.count,
        int(p.materials.roughness.shape[0]),
        p.num_tris,
        p.tpad,
    )


def _bigmesh_matches(scene: Scene) -> bool:
    from ..models import bigmesh as _bm

    return scene.closest_hit_fn is _bm.closest_hit


BIGMESH_BACKEND = KernelBackend(
    name="bigmesh",
    pack=pack_bigmesh_scene,
    meta_of=_bigmesh_meta,
    view=_bigmesh_view,
    closest_hit=_closest_hit_bigmesh,
    any_hit=_any_hit_bigmesh,
    background=_background_bigmesh,
    matches=_bigmesh_matches,
    extra_of=_bigmesh_extras,
    # Dead-lane probe rays (pointing up from far above the scene) miss
    # every chunk AABB, so the any-lane chunk cull excludes dead lanes.
    march_based=True,
)

register_backend(BIGMESH_BACKEND)
