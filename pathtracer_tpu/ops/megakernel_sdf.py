"""Fused-kernel backend for the sphere-traced SDF scene.

The reference names SDF rendering as its thesis ("render classic analytical
shapes and signed distance functions ... on the CPU", reference
Readme.md:76-84) but ships only analytical spheres; models/sdf.py renders it
through the XLA integrator. This module puts it in the fused kernel: the
sphere-trace loop (where-chained primitives, over-relaxed steps), analytic
SDF normals (in-kernel jax.grad of the distance field), material argmin,
checker and sky all run per ray via the generic machinery
(ops/megakernel.py `KernelBackend`).

The kernel is forward-only: gradients come from the XLA twin
(models/sdf.sphere_trace, implicit-function Newton reattachment) through the
kernel's custom VJP, so the kernel march returns the converged t as is.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from ..models.sdf import HIT_EPS, MAX_STEPS, OMEGA, T_MAX, SdfParams, smooth_min
from ..ops.vecmath import V3, dot, safe_normalize, safe_sqrt, splat3
from .megakernel import (
    KernelBackend,
    _CommonScalars,
    _pick_material,
    _ScalarRow,
    _v3_list,
    pack_camera,
    pack_lights,
    pack_materials,
    register_backend,
)


# March steps per early-exit convergence check. Must divide MAX_STEPS (a
# non-divisor would overrun the fixed-trip count and break bit-parity with
# models/sdf.sphere_trace for lanes still marching at step MAX_STEPS).
MARCH_BLOCK = 12
assert MAX_STEPS % MARCH_BLOCK == 0


def pack_sdf_scene(scene: Scene, width: int, height: int,
                   with_medium: bool = True) -> jnp.ndarray:
    """Flatten camera + SdfParams + lights + materials (same contract as
    megakernel.pack_scene; pure jnp, so camera/geometry gradients flow)."""
    p: SdfParams = scene.params
    f32 = jnp.float32
    vals: list = pack_camera(scene, width, height)

    for i in range(p.sphere_radius.shape[0]):
        vals += [p.sphere_center.x[i], p.sphere_center.y[i], p.sphere_center.z[i]]
        vals += [p.sphere_radius[i]]
    for i in range(p.box_round.shape[0]):
        vals += [p.box_center.x[i], p.box_center.y[i], p.box_center.z[i]]
        vals += [p.box_half.x[i], p.box_half.y[i], p.box_half.z[i]]
        vals += [p.box_round[i]]
    for i in range(p.torus_major.shape[0]):
        vals += [p.torus_center.x[i], p.torus_center.y[i], p.torus_center.z[i]]
        vals += [p.torus_major[i], p.torus_minor[i]]

    vals += _v3_list(p.plane_point) + _v3_list(p.plane_normal)
    vals += [p.smooth_k, p.checker_scale, p.checker_albedo[0], p.checker_albedo[1]]
    vals += _v3_list(p.sky_horizon) + _v3_list(p.sky_zenith) + [p.sky_scale]

    vals += pack_lights(scene)
    vals += pack_materials(p.materials, with_medium)

    flat = jnp.stack([jnp.asarray(x, f32) for x in vals])
    return flat[None, :]


class _SdfScalars(_CommonScalars):
    """In-kernel view of pack_sdf_scene's layout."""

    def __init__(self, ref, meta):
        # meta = meta_of(scene) + (has_media,) (megakernel._render_tiles_pallas)
        n_lights, S, B, T, with_medium = meta
        self._ref = ref
        self._off = 0
        get = self._get

        self._read_camera()

        self.spheres = [
            (V3(get(), get(), get()), get()) for _ in range(S)
        ]  # (center, radius)
        self.boxes = [
            (V3(get(), get(), get()), V3(get(), get(), get()), get())
            for _ in range(B)
        ]  # (center, half, round)
        self.tori = [
            (V3(get(), get(), get()), get(), get()) for _ in range(T)
        ]  # (center, major, minor)

        self.plane_point = V3(get(), get(), get())
        self.plane_normal = V3(get(), get(), get())
        self.smooth_k = get()
        self.checker_scale = get()
        self.checker_albedo = [get(), get()]

        self.sky_horizon = V3(get(), get(), get())
        self.sky_zenith = V3(get(), get(), get())
        self.sky_scale = get()

        self._read_lights(n_lights)
        self._read_materials(S + B + T + 1, with_medium)

    def to_params(self) -> SdfParams:
        """SdfParams view for in-kernel procedural hooks (static-index
        _ScalarRow leaves; see megakernel._SceneScalars.to_params)."""

        def col(tuples, k):
            return _ScalarRow([t[k] for t in tuples])

        def col3(tuples, k):
            return V3(
                _ScalarRow([t[k].x for t in tuples]),
                _ScalarRow([t[k].y for t in tuples]),
                _ScalarRow([t[k].z for t in tuples]),
            )

        return SdfParams(
            sphere_center=col3(self.spheres, 0),
            sphere_radius=col(self.spheres, 1),
            box_center=col3(self.boxes, 0),
            box_half=col3(self.boxes, 1),
            box_round=col(self.boxes, 2),
            torus_center=col3(self.tori, 0),
            torus_major=col(self.tori, 1),
            torus_minor=col(self.tori, 2),
            plane_point=self.plane_point,
            plane_normal=self.plane_normal,
            smooth_k=self.smooth_k,
            materials=self._material_table(),
            checker_scale=self.checker_scale,
            checker_albedo=_ScalarRow(self.checker_albedo),
            sky_horizon=self.sky_horizon,
            sky_zenith=self.sky_zenith,
            sky_scale=self.sky_scale,
        )


def _sdf_view(ref, meta):
    return _SdfScalars(ref, meta)


# ---------------------------------------------------------------------------
# Distance field (mirrors models/sdf.py's primitives on scalar params)
# ---------------------------------------------------------------------------


def _distances(sc: _SdfScalars, x: V3) -> list:
    """Per-primitive distances in material-table order (models/sdf.py
    _primitive_distances: spheres, boxes, tori, plane)."""
    ds = []
    for c, r in sc.spheres:
        ds.append((x - c).length() - r)
    for c, h, r in sc.boxes:
        q = (x - c).abs() - h
        outside = V3(
            jnp.maximum(q.x, 0.0), jnp.maximum(q.y, 0.0), jnp.maximum(q.z, 0.0)
        )
        out_len = safe_sqrt(dot(outside, outside))
        inside = jnp.minimum(jnp.maximum(q.x, jnp.maximum(q.y, q.z)), 0.0)
        ds.append(out_len + inside - r)
    for c, major, minor in sc.tori:
        q = x - c
        ring = safe_sqrt(q.x * q.x + q.z * q.z) - major
        ds.append(safe_sqrt(ring * ring + q.y * q.y) - minor)
    ds.append(dot(x - sc.plane_point, sc.plane_normal))
    return ds


def _sdf(sc: _SdfScalars, x: V3) -> jnp.ndarray:
    ds = _distances(sc, x)
    d = ds[0]
    for di in ds[1:]:
        d = smooth_min(d, di, sc.smooth_k)
    return d


def _normal(sc: _SdfScalars, x: V3) -> V3:
    """Analytic normal: in-kernel reverse-mode grad of the distance field
    (models/sdf.sdf_normal)."""

    def f(a, b, c):
        return jnp.sum(_sdf(sc, V3(a, b, c)))

    gx, gy, gz = jax.grad(f, argnums=(0, 1, 2))(x.x, x.y, x.z)
    return safe_normalize(V3(gx, gy, gz))


def _sphere_trace(sc: _SdfScalars, ro: V3, rd: V3, t_cap=None,
                  want_steps: bool = False):
    """March t += sdf — the in-kernel twin of models/sdf.sphere_trace
    (same over-relaxed steps and stop rule; returns (t, hit)).

    Two in-kernel accelerations over the fixed-trip XLA march, both
    result-identical (same stop condition per lane, and t is monotone
    increasing so a capped lane can never re-enter the [0, cap] range):

    - early exit: a while_loop that stops as soon as EVERY lane in the
      tile has converged or escaped (a block-uniform branch). Tiles are
      spatially coherent (compact pixel blocks), so typical trip counts
      are far below MAX_STEPS — sky tiles escape in a handful of steps.
    - t_cap (per-lane, used by the shadow march): lanes stop once t
      exceeds the light distance WITH NO overstep-fail pending. Occlusion
      is decided by t < max_dist, and any hit found beyond the cap would
      fail that comparison anyway — but under over-relaxation t is NOT
      monotone (a failed overstep backtracks by (omega-1)*step), so the
      cap must wait for a pending backtrack to resolve before freezing
      the lane, or it would miss an occluder the backtrack re-finds at
      t < cap. With that guard, capping changes no boolean outcome — it
      only skips the pointless march from the light to T_MAX.
    """
    cap = T_MAX if t_cap is None else jnp.minimum(t_cap, T_MAX)

    def step_once(st):
        # Over-relaxed march step — IDENTICAL math to the XLA twin
        # (models/sdf.sphere_trace body; see the OMEGA note there). The
        # done flag rides as f32 0/1 so the block reduction is a plain sum.
        t, prev_r, step_len, omega, done_f = st
        done = done_f > 0.5
        x = ro + rd * t
        d = _sdf(sc, x)
        r = jnp.abs(d)
        fail = (omega > 1.0) & (r + prev_r < step_len)
        new_step = jnp.where(fail, -(omega - 1.0) * step_len, d * omega)
        omega_n = jnp.where(fail, 1.0, omega)
        hit_now = (~fail) & (r < HIT_EPS)
        # The cap term must NOT fire while an overstep-fail backtrack is
        # pending: an omega>1 overstep can cross both an occluder and the
        # cap in one step, and freezing the lane there would skip the
        # backtrack that re-finds the occluder at t < cap. The unguarded
        # T_MAX term stays for exact parity with models/sdf.sphere_trace,
        # whose stop condition is `t > t_max` with no fail guard.
        done_n = done | hit_now | ((t > cap) & ~fail) | (t > T_MAX)
        t_n = jnp.where(done_n, t, t + new_step)
        prev_r_n = jnp.where(done, prev_r, r)
        step_n = jnp.where(done, step_len, new_step)
        omega_n = jnp.where(done, omega, omega_n)
        return (t_n, prev_r_n, step_n, omega_n, done_n.astype(jnp.float32))

    def cond(carry):
        step, st = carry
        return (step < MAX_STEPS) & (jnp.sum(1.0 - st[4]) > 0.5)

    def body(carry):
        # MARCH_BLOCK steps per trip, then ONE block-wide convergence
        # reduction, which amortizes the reduction's cost while keeping a
        # block-granular exit. The block is a nested fori (body compiled
        # once), not a Python unroll: an unrolled block makes the
        # interpret-mode compile of the kernel ~15x slower.
        step, st = carry
        st = jax.lax.fori_loop(
            0, MARCH_BLOCK, lambda _i, s: step_once(s), st
        )
        return step + MARCH_BLOCK, st

    t0 = jnp.zeros_like(rd.x)
    zero = jnp.zeros_like(t0)
    st0 = (t0, zero, zero, jnp.full_like(t0, OMEGA), zero)
    steps_taken, (t_star, _, _, _, _) = jax.lax.while_loop(
        cond, body, (jnp.int32(0), st0)
    )
    if want_steps:
        # Instrumentation mode (measure_march_steps): return the
        # block-granular trip count — the number of march steps this tile
        # executed before every lane converged or escaped, the quantity
        # the 2-D tiling optimizes.
        return steps_taken

    x_star = ro + rd * t_star
    hit = (jnp.abs(_sdf(sc, x_star)) < 2.0 * HIT_EPS) & (t_star <= T_MAX)
    # models/sdf.sphere_trace's Newton reattachment has value t_star; it
    # only matters for gradients, which the XLA twin provides.
    return t_star, hit


# ---------------------------------------------------------------------------
# KernelBackend implementation
# ---------------------------------------------------------------------------


def _checker(sc: _SdfScalars, x, z):
    """models/sdf.py _checker, verbatim (incl. abs before the final fmod)."""
    x1 = jnp.fmod(jnp.floor(x * sc.checker_scale), 2.0)
    z1 = jnp.fmod(jnp.floor(z * sc.checker_scale), 2.0)
    return jnp.where(
        jnp.fmod(jnp.abs(x1 + z1), 2.0) < 1.0,
        sc.checker_albedo[0],
        sc.checker_albedo[1],
    )


def _closest_hit_sdf(sc: _SdfScalars, ro: V3, rd: V3):
    shape = jnp.shape(rd.x)
    t, hit = _sphere_trace(sc, ro, rd)
    t = jnp.where(hit, t, jnp.inf)
    x = ro + rd * jnp.where(hit, t, 0.0)
    normal = _normal(sc, x)

    # Material id: first-min-wins argmin over primitive distances
    # (models/sdf.nearest_primitive) as a where-chain.
    ds = _distances(sc, x)
    idx = jnp.zeros(shape, jnp.int32)
    best = ds[0]
    for i, di in enumerate(ds[1:], start=1):
        take = di < best
        idx = jnp.where(take, i, idx)
        best = jnp.where(take, di, best)

    mat = _pick_material(sc, idx, shape)
    plane_idx = len(ds) - 1
    c = _checker(sc, x.x, x.z)
    mat = jax.tree_util.tree_map(
        lambda a, b: jnp.where(idx == plane_idx, a, b),
        mat._replace(rgb=splat3(c)),
        mat,
    )
    from ..models.material import default_material

    defaults = default_material(shape, jnp.float32)
    mat = jax.tree_util.tree_map(lambda a, b: jnp.where(hit, a, b), mat, defaults)
    return jnp.where(hit, t, jnp.inf), normal, mat


def _any_hit_sdf(sc: _SdfScalars, ro: V3, rd: V3, max_dist):
    """Shadow occlusion bounded by max_dist (models/sdf.any_hit — fixed
    semantics; the ignore-max_dist quirk is analytical-scene-specific).
    The march is capped at max_dist (see _sphere_trace: boolean-identical,
    skips the march from the light out to T_MAX)."""
    t, hit = _sphere_trace(sc, ro, rd, t_cap=max_dist)
    return hit & (t < max_dist)


def _background_sdf(sc: _SdfScalars, rd: V3) -> V3:
    t = 0.5 * (rd.y + 1.0)
    c = sc.sky_horizon * (1.0 - t) + sc.sky_zenith * t
    return c.to_linear() * splat3(sc.sky_scale)


def _sdf_meta(scene: Scene) -> tuple:
    p: SdfParams = scene.params
    return (
        scene.lights.count,
        int(p.sphere_radius.shape[0]),
        int(p.box_round.shape[0]),
        int(p.torus_major.shape[0]),
    )


def measure_march_steps(
    scene: Scene,
    width: int,
    height: int,
    tile_rows: int | None = None,
    tiling: str = "block",
    interpret: bool = False,
):
    """Per-tile march trip counts (primary AND NEE shadow) from the real
    kernel march.

    Launches a measurement kernel that raygens center-of-pixel rays and
    runs the production _sphere_trace (same over-relaxation, same
    block-granular early exit), emitting each tile's executed step count
    (a multiple of MARCH_BLOCK — the whole tile marches until its worst
    lane converges, which is why compact 2-D pixel tiles beat flat
    scanline ranges). Returns a dict with the per-tile counts and their
    mean/max; compare tiling="flat" vs "block" to see the envelope shrink.
    """
    import numpy as np

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    from .. import device
    from .megakernel import (
        EPS as _NEE_EPS,
        LANES as _LANES,
        TILE_ROWS,
        _LaneRef,
        _lane_rays,
        _raygen,
        _sample_light_unrolled,
        num_tiles_for,
        num_warps_for,
        pad_pow2,
        resolve_tiling,
    )

    tile_rows = TILE_ROWS if tile_rows is None else tile_rows
    tiling = resolve_tiling(tiling, 1)
    shape = (tile_rows, _LANES)
    num_tiles = num_tiles_for(width, height, 1, tile_rows, tiling)
    meta = _sdf_meta(scene) + (False,)
    sv = pad_pow2(pack_sdf_scene(scene, width, height, False))

    def body(sp_ref, steps_ref):
        sc = _sdf_view(_LaneRef(sp_ref, shape), meta)
        ray = _lane_rays(
            pl.program_id(0),
            jax.lax.broadcasted_iota(jnp.int32, shape, 0),
            jax.lax.broadcasted_iota(jnp.int32, shape, 1),
            tile_rows, width, height, 1, tiling,
        )
        half = jnp.full(shape, 0.5, jnp.float32)
        ro, rd = _raygen(sc, ray, 1, width, height, half, half)
        steps = _sphere_trace(sc, ro, rd, want_steps=True)

        # Shadow-march counter: rebuild the NEE shadow ray exactly as
        # _direct_light does — hit point + face-forward-normal offset,
        # center-of-light sample (u = 0.5), occlusion capped at the light
        # distance, miss/non-facing lanes capped at 0 (the dead-lane
        # elision convention) — and count the capped march's trips.
        t, hit = _sphere_trace(sc, ro, rd)
        x = ro + rd * jnp.where(hit, t, 0.0)
        n = _normal(sc, x)
        ffn = n * jnp.where(dot(n, rd) > 0.0, -1.0, 1.0)
        scatter = x + ffn * _NEE_EPS
        lnormal, _lem, ldir, ldist, _lpdf, _larea = _sample_light_unrolled(
            sc, scatter, (half, half, half)
        )
        facing = dot(ldir, lnormal) < 0.0
        cap = jnp.where(facing & hit, ldist - _NEE_EPS, 0.0)
        shadow_steps = _sphere_trace(sc, scatter, ldir, t_cap=cap,
                                     want_steps=True)
        col = jax.lax.broadcasted_iota(jnp.int32, (1, 2), 1)
        steps_ref[...] = jnp.where(col == 0, steps, shadow_steps)

    out = pl.pallas_call(
        body,
        grid=(num_tiles,),
        in_specs=[pl.BlockSpec(sv.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 2), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((num_tiles, 2), jnp.int32),
        interpret=device.pallas_interpret(interpret),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps_for(tile_rows), num_stages=1
        ),
        name="sdf_march_steps",
    )(sv)
    rows = np.asarray(out)
    counts = rows[:, 0]
    shadow = rows[:, 1]
    return {
        "steps_per_tile": counts,
        "mean_steps": float(counts.mean()),
        "max_steps": int(counts.max()),
        "shadow_steps_per_tile": shadow,
        "shadow_mean_steps": float(shadow.mean()),
        "shadow_max_steps": int(shadow.max()),
        "tiling": tiling,
        "num_tiles": int(num_tiles),
    }


def _sdf_matches(scene: Scene) -> bool:
    from ..models import sdf as _sdf

    return scene.closest_hit_fn is _sdf.closest_hit


SDF_BACKEND = KernelBackend(
    name="sdf",
    pack=pack_sdf_scene,
    meta_of=_sdf_meta,
    view=_sdf_view,
    closest_hit=_closest_hit_sdf,
    any_hit=_any_hit_sdf,
    background=_background_sdf,
    matches=_sdf_matches,
    march_based=True,
)

register_backend(SDF_BACKEND)
