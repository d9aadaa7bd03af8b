"""Vectorized ray-primitive intersection tests.

Replaces the reference's scalar Option<F>-returning tests
(renderer/src/analytical.rs:163-213 and the copy inside Scene::sample_lights,
rust-pathtracer/src/scene.rs:38-63). Misses are encoded as +inf distances so
`closest wins` reduces to jnp.minimum over a batch — the batched
replacement for the reference's if-let chains.
"""

from __future__ import annotations

import jax.numpy as jnp

from .vecmath import V3, dot, safe_sqrt

MISS = jnp.inf


def ray_sphere(ro: V3, rd: V3, center: V3, radius) -> jnp.ndarray:
    """Scratchapixel sphere test, verbatim math (analytical.rs:166-190).

    Returns hit distance t (>= 0) or +inf on miss. Matches the reference's
    branch structure: reject d2 > r^2, take t0 = tca - thc unless negative,
    else t1 = tca + thc, reject if still negative.
    """
    l = center - ro
    tca = dot(l, rd)
    d2 = dot(l, l) - tca * tca
    radius2 = radius * radius
    thc = safe_sqrt(radius2 - d2)
    t0 = tca - thc
    t1 = tca + thc
    t = jnp.where(t0 < 0.0, t1, t0)
    miss = (d2 > radius2) | (t < 0.0)
    return jnp.where(miss, MISS, t)


def ray_rect(ro: V3, rd: V3, corner: V3, u: V3, v: V3) -> jnp.ndarray:
    """Ray vs rectangle spanned by edges (u, v) from `corner`.

    Supports the Rectangular light type the reference declares but never
    implements (globals.rs:70); math follows the GLSL original's
    RectIntersect: plane hit, then barycentric gates 0 <= a,b <= 1 on the
    edge projections. Returns t >= 0 or +inf.
    """
    n = u.cross(v)
    denom = dot(n, rd)
    safe_denom = jnp.where(jnp.abs(denom) > 1e-8, denom, 1.0)
    t = dot(corner - ro, n) / safe_denom
    hp = ro + rd * t
    rel = hp - corner
    uu = dot(u, u)
    vv = dot(v, v)
    a = dot(rel, u) / jnp.where(uu > 0.0, uu, 1.0)
    b = dot(rel, v) / jnp.where(vv > 0.0, vv, 1.0)
    ok = (
        (jnp.abs(denom) > 1e-8)
        & (t >= 0.0)
        & (a >= 0.0) & (a <= 1.0)
        & (b >= 0.0) & (b <= 1.0)
    )
    return jnp.where(ok, t, MISS)


def ray_plane(ro: V3, rd: V3, normal: V3, point: V3, eps: float = 0.0001) -> jnp.ndarray:
    """Ray-plane test, verbatim math (analytical.rs:193-204).

    Returns t >= 0 or +inf. The reference hardcodes normal (0,1,0) and point
    (0,-1,0); generalized here with identical eps and sign conventions.
    """
    denom = dot(normal, rd)
    safe_denom = jnp.where(jnp.abs(denom) > eps, denom, 1.0)
    t = dot(point - ro, normal) / safe_denom
    miss = (jnp.abs(denom) <= eps) | (t < 0.0)
    return jnp.where(miss, MISS, t)


def ray_triangle(ro: V3, rd: V3, v0: V3, v1: V3, v2: V3,
                 eps: float = 1e-7) -> jnp.ndarray:
    """Möller-Trumbore ray/triangle test, two-sided.

    Returns hit distance t (> eps) or +inf on miss. No counterpart in the
    reference (it ships only analytic spheres/planes, renderer/src/
    analytical.rs:163-213) — this powers the mesh scene family the
    reference's README only aspires to ("render classic analytical
    shapes ...", Readme.md:76-84). Two-sided: the determinant's sign is
    not culled, so winding does not matter for visibility (normals are
    oriented against the ray by the caller)."""
    from .vecmath import cross as _cross

    e1 = v1 - v0
    e2 = v2 - v0
    p = _cross(rd, e2)
    det = dot(e1, p)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / jnp.where(det != 0.0, det, 1.0), 0.0)
    s = ro - v0
    u = dot(s, p) * inv_det
    q = _cross(s, e1)
    v = dot(rd, q) * inv_det
    t = dot(e2, q) * inv_det
    ok = (
        (jnp.abs(det) > eps)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps)
    )
    return jnp.where(ok, t, MISS)
