"""Fused-kernel backend for the small triangle-mesh scene family.

Puts models/mesh.py in the fused kernel through the generic KernelBackend
protocol (ops/megakernel.py) — the same protocol the analytical and SDF
backends use and that tests/test_backend_plugin.py registers a toy backend
through. Triangle topology and material ids are STATIC meta (the
Möller-Trumbore chain unrolls at trace time, no gathers); vertex positions
are packed scalars. Vertex gradients come from the XLA twin through the
kernel's custom VJP.

Reference anchor: the reference has no mesh support at all (analytic
spheres + plane only, renderer/src/analytical.rs:163-213); this exceeds
its scope through the same `trait Scene`-analog seam (scene.rs:5-90).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from ..ops.intersect import ray_triangle
from ..ops.vecmath import V3, cross, dot, mix, safe_normalize, splat3, where3
from .megakernel import (
    KernelBackend,
    _CommonScalars,
    _pick_material,
    _v3_list,
    pack_camera,
    pack_lights,
    pack_materials,
    register_backend,
)


def pack_mesh_scene(scene: Scene, width: int, height: int,
                    with_medium: bool = True) -> jnp.ndarray:
    """Flatten camera + vertices + sky + lights + materials (same contract
    as megakernel.pack_scene; pure jnp, so vertex/camera gradients flow)."""
    p = scene.params
    vals: list = pack_camera(scene, width, height)
    nv = int(p.vertices.x.shape[0])
    for i in range(nv):
        vals += [p.vertices.x[i], p.vertices.y[i], p.vertices.z[i]]
    vals += _v3_list(p.sky_horizon) + _v3_list(p.sky_zenith) + [p.sky_scale]
    vals += pack_lights(scene)
    vals += pack_materials(p.materials, with_medium)
    return jnp.stack([jnp.asarray(x, jnp.float32) for x in vals])[None, :]


class _MeshScalars(_CommonScalars):
    """In-kernel view of pack_mesh_scene's layout. Topology rides in meta."""

    def __init__(self, ref, meta):
        n_lights, nv, tri_idx, tri_mat, with_medium = meta
        self._ref = ref
        self._off = 0
        get = self._get
        self._read_camera()
        self.verts = [V3(get(), get(), get()) for _ in range(nv)]
        self.tri_idx = tri_idx
        self.tri_mat = tri_mat
        self.sky_horizon = V3(get(), get(), get())
        self.sky_zenith = V3(get(), get(), get())
        self.sky_scale = get()
        self._read_lights(n_lights)
        n_mats = int(max(tri_mat)) + 1 if tri_mat else 1
        self._read_materials(n_mats, with_medium)

    def to_params(self):
        """MeshParams view for in-kernel procedural hooks (static-index
        _ScalarRow leaves; see megakernel._SceneScalars.to_params)."""
        from ..models.mesh import MeshParams
        from .megakernel import _ScalarRow

        return MeshParams(
            vertices=V3(
                _ScalarRow([v.x for v in self.verts]),
                _ScalarRow([v.y for v in self.verts]),
                _ScalarRow([v.z for v in self.verts]),
            ),
            materials=self._material_table(),
            sky_horizon=self.sky_horizon,
            sky_zenith=self.sky_zenith,
            sky_scale=self.sky_scale,
            tri_idx=self.tri_idx,
            tri_mat=self.tri_mat,
        )


def _mesh_view(ref, meta):
    return _MeshScalars(ref, meta)


def _tri_ts(sc: _MeshScalars, ro: V3, rd: V3):
    return [
        ray_triangle(ro, rd, sc.verts[a], sc.verts[b], sc.verts[c])
        for a, b, c in sc.tri_idx
    ]


def _closest_hit_mesh(sc: _MeshScalars, ro: V3, rd: V3):
    """models/mesh.closest_hit on scalar vertices: first-min-wins over the
    unrolled triangle list, face-forward geometric normals, material id
    resolved through the STATIC per-triangle table inside the min chain."""
    shape = jnp.shape(rd.x)
    ts = _tri_ts(sc, ro, rd)

    t = ts[0]
    idx = jnp.zeros(shape, jnp.int32)
    for i, ti in enumerate(ts[1:], start=1):
        take = ti < t
        idx = jnp.where(take, i, idx)
        t = jnp.where(take, ti, t)
    hit = jnp.isfinite(t)

    def tri_normal(i):
        a, b, c = sc.tri_idx[i]
        return safe_normalize(cross(sc.verts[b] - sc.verts[a],
                                    sc.verts[c] - sc.verts[a]))

    n0 = tri_normal(0)
    normal = V3(
        jnp.broadcast_to(n0.x, shape),
        jnp.broadcast_to(n0.y, shape),
        jnp.broadcast_to(n0.z, shape),
    )
    mat_idx = jnp.full(shape, sc.tri_mat[0], jnp.int32)
    for i in range(1, len(sc.tri_idx)):
        sel = idx == i
        normal = where3(sel, tri_normal(i), normal)
        mat_idx = jnp.where(sel, sc.tri_mat[i], mat_idx)
    normal = normal * jnp.where(dot(normal, rd) > 0.0, -1.0, 1.0)

    mat = _pick_material(sc, mat_idx, shape)
    from ..models.material import default_material

    defaults = default_material(shape, jnp.float32)
    mat = jax.tree_util.tree_map(lambda a, b: jnp.where(hit, a, b), mat, defaults)
    return jnp.where(hit, t, jnp.inf), normal, mat


def _any_hit_mesh(sc: _MeshScalars, ro: V3, rd: V3, max_dist):
    ts = _tri_ts(sc, ro, rd)
    t = ts[0]
    for ti in ts[1:]:
        t = jnp.minimum(t, ti)
    return t < max_dist


def _background_mesh(sc: _MeshScalars, rd: V3) -> V3:
    t = 0.5 * (rd.y + 1.0)
    return mix(sc.sky_horizon, sc.sky_zenith, t).to_linear() * splat3(sc.sky_scale)


def _mesh_meta(scene: Scene) -> tuple:
    p = scene.params
    return (
        scene.lights.count,
        int(p.vertices.x.shape[0]),
        tuple(p.tri_idx),
        tuple(p.tri_mat),
    )


def _mesh_matches(scene: Scene) -> bool:
    from ..models import mesh as _mesh

    return scene.closest_hit_fn is _mesh.closest_hit


MESH_BACKEND = KernelBackend(
    name="mesh",
    pack=pack_mesh_scene,
    meta_of=_mesh_meta,
    view=_mesh_view,
    closest_hit=_closest_hit_mesh,
    any_hit=_any_hit_mesh,
    background=_background_mesh,
    matches=_mesh_matches,
)

register_backend(MESH_BACKEND)
