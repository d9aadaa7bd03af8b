"""Large-mesh backend (models/bigmesh.py + ops/megakernel_bigmesh.py):
the >= 1k-triangle scene family — coefficient-table Möller-Trumbore,
XLA-vs-Pallas parity, vertex gradients, occlusion.

Anchor: the backend seam this scales is the reference's `trait Scene`
(/root/reference/rust-pathtracer/src/scene.rs:5-27); the reference itself
never ships triangles at all.
"""

import jax
import jax.numpy as jnp
import numpy as np

import pathtracer_tpu as pt
from pathtracer_tpu.models.bigmesh import (
    CHUNK,
    any_hit,
    closest_hit,
    coef_tables,
    default_params,
    make_scene,
    mt_hit_t,
    mt_terms,
    _tri_corners,
)
from pathtracer_tpu.ops.intersect import ray_triangle
from pathtracer_tpu.ops.vecmath import V3


def _rand_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    ro = V3(*(jnp.asarray(rng.normal(0, 2, n), jnp.float32) for _ in range(3)))
    rd_ = rng.normal(size=(3, n))
    rd_ /= np.linalg.norm(rd_, axis=0)
    rd = V3(*(jnp.asarray(rd_[i], jnp.float32) for i in range(3)))
    return ro, rd


def test_demo_scene_is_kilo_triangle():
    p = default_params()
    assert p.num_tris >= 1000
    assert p.tpad % CHUNK == 0


def test_coef_table_matches_ray_triangle():
    """The coefficient-table pair test agrees with the unrolled
    Möller-Trumbore primitive on every (ray, triangle) decision and on
    the hit distances (the table form is an exact algebraic expansion)."""
    p = default_params()
    coef, _, _ = coef_tables(p)
    ro, rd = _rand_rays(128)
    cols = [coef[:, k][None, :] for k in range(16)]
    mv = jnp.stack([
        ro.y * rd.z - ro.z * rd.y,
        ro.z * rd.x - ro.x * rd.z,
        ro.x * rd.y - ro.y * rd.x,
    ])
    d = [rd.x[:, None], rd.y[:, None], rd.z[:, None]]
    m = [mv[0][:, None], mv[1][:, None], mv[2][:, None]]
    o = [ro.x[:, None], ro.y[:, None], ro.z[:, None]]
    tp = np.asarray(mt_hit_t(*mt_terms(cols, d, m, o)))[:, :p.num_tris]

    v0, v1, v2 = _tri_corners(p)
    sel = np.linspace(0, p.num_tris - 1, 64).astype(int)
    for j in sel:
        tj = np.asarray(ray_triangle(
            ro, rd,
            V3(v0.x[j], v0.y[j], v0.z[j]),
            V3(v1.x[j], v1.y[j], v1.z[j]),
            V3(v2.x[j], v2.y[j], v2.z[j]),
        ))
        assert (np.isfinite(tj) == np.isfinite(tp[:, j])).all()
        both = np.isfinite(tj)
        if both.any():
            np.testing.assert_allclose(tj[both], tp[both, j], rtol=2e-5)


def test_closest_hit_matches_analytic_sphere():
    """Rays at the tessellated sphere hit within tessellation error of the
    analytic sphere distance; a downward ray hits the ground plane; an
    upward ray escapes."""
    ro = V3(*(jnp.asarray([v] * 3, jnp.float32) for v in (0.0, 0.0, 5.0)))
    rd = V3(jnp.asarray([0.0, 0.0, 0.0], jnp.float32),
            jnp.asarray([0.0, -1.0, 1.0], jnp.float32),
            jnp.asarray([-1.0, 0.0, 0.0], jnp.float32))
    sh = closest_hit(default_params(), ro, rd)
    t = np.asarray(sh.t)
    assert abs(t[0] - 4.0) < 0.02  # straight at the unit sphere from z=5
    assert abs(t[1] - 1.0) < 1e-4  # straight down onto the y=-1 ground
    assert not np.isfinite(t[2])  # straight up: escapes


def test_any_hit_occlusion():
    p = default_params()
    ro = V3(*(jnp.asarray([v], jnp.float32) for v in (0.0, 0.0, 5.0)))
    rd = V3(*(jnp.asarray([v], jnp.float32) for v in (0.0, 0.0, -1.0)))
    assert bool(any_hit(p, ro, rd, jnp.asarray([10.0]))[0])
    assert not bool(any_hit(p, ro, rd, jnp.asarray([1.0]))[0])  # box closer than t=4? no
    up = V3(*(jnp.asarray([v], jnp.float32) for v in (0.0, 1.0, 0.0)))
    assert not bool(any_hit(p, V3(*(jnp.asarray([v], jnp.float32)
                                    for v in (0.0, 3.0, 0.0))), up,
                            jnp.asarray([100.0]))[0])


def test_render_frame_xla_finite_and_lit():
    scene = make_scene(recursion_depth=2)
    img = pt.render_frame(scene, jax.random.PRNGKey(3), 64, 48)
    a = np.asarray(img)
    assert np.isfinite(a).all()
    assert a[..., :3].max() > 0.05


def test_pallas_parity_interpret():
    """The fused kernel backend reproduces the XLA integrator to ulp
    level under hbm uniforms in interpret mode (shared mt_terms/mt_hit_t
    math, same operation order — only fusion differences remain; the
    AABB cull is strictly conservative)."""
    from pathtracer_tpu.ops.megakernel import render_frame_pallas

    scene = make_scene(recursion_depth=2)
    key = jax.random.PRNGKey(7)
    img_x = pt.render_frame(scene, key, 96, 64)
    img_p = render_frame_pallas(
        scene, key, 96, 64, uniforms="hbm", interpret=True, tile_rows=8
    )
    np.testing.assert_allclose(
        np.asarray(img_x[..., :3]), np.asarray(img_p[..., :3]), atol=2e-6
    )


def test_vertex_gradients_finite_difference():
    """Vertex gradients flow through the coefficient tables: jax.grad of
    an image loss w.r.t. a vertex coordinate matches CRN central
    differences (same key => same uniforms; the discontinuous visibility
    term cancels at this epsilon because the silhouette moves less than a
    pixel)."""
    scene = make_scene(recursion_depth=2)
    key = jax.random.PRNGKey(11)
    W, H = 48, 32

    def loss(vy):
        p = scene.params._replace(
            vertices=scene.params.vertices._replace(y=vy)
        )
        img = pt.render_frame(
            scene.replace(params=p), key, W, H, detach=True, remat=True
        )
        return jnp.mean(img[..., :3] ** 2)

    vy0 = scene.params.vertices.y
    g = jax.grad(loss)(vy0)
    assert bool(jnp.isfinite(g).all())

    # FD check on the sphere's top-pole y (index of max y)
    j = int(jnp.argmax(vy0))
    eps = 3e-3
    lp = loss(vy0.at[j].add(eps))
    lm = loss(vy0.at[j].add(-eps))
    fd = float((lp - lm) / (2 * eps))
    an = float(g[j])
    assert np.isfinite(fd) and np.isfinite(an)
    # MC + discontinuity noise: demand sign agreement and loose magnitude
    assert fd * an > 0 or abs(fd - an) < 5e-3
    assert abs(fd - an) <= 0.5 * max(abs(fd), abs(an)) + 5e-3


def test_bigmesh_backend_is_forward_only():
    """The kernel backend itself is forward-only; reverse-mode AD through
    render_frame_pallas takes the custom VJP, i.e. the XLA twin's VJP on
    the same uniforms, and so equals the XLA detached estimator."""
    from pathtracer_tpu.ops.megakernel import render_frame_pallas

    scene = make_scene(recursion_depth=1)
    key = jax.random.PRNGKey(0)

    def loss(em, kernel):
        s = scene.replace(lights=scene.lights._replace(emission=em))
        if kernel:
            img = render_frame_pallas(
                s, key, 32, 16, uniforms="hbm", interpret=True, tile_rows=8
            )
        else:
            img = pt.render_frame(s, key, 32, 16, detach=True)
        return jnp.mean(img[..., :3])

    em = scene.lights.emission
    g_k = jax.grad(lambda e: loss(e, True))(em)
    g_x = jax.grad(lambda e: loss(e, False))(em)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_x), rtol=1e-5)
    assert np.abs(np.asarray(g_k)).max() > 1e-6
