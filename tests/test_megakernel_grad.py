"""Backward-pass validation for the fused kernel (ops/megakernel.py).

render_frame_pallas's custom VJP runs the XLA integrator's VJP on the
kernel's own rays and uniforms. With uniforms="hbm" those are the XLA
integrator's threefry uniforms, so the gradients must match the XLA
detached-estimator gradients (which tests/test_grad.py validates against
f64 common-random-number finite differences) to float32 accuracy.
Reference anchor: the loop being differentiated is
rust-pathtracer/src/tracer.rs:61-103.

The forward kernel runs in interpret mode on CPU (conftest pins the cpu
platform).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.ops.megakernel import render_frame_pallas

W, H = 32, 16
KEY = jax.random.PRNGKey(7)


def _flat(tree):
    return np.concatenate(
        [np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(tree)]
    )


@pytest.fixture(scope="module")
def scene():
    return pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=2)


def _losses(scene):
    def loss_pal(em, rgb):
        s = scene.replace(
            lights=scene.lights._replace(emission=em),
            params=scene.params._replace(
                materials=scene.params.materials._replace(rgb=rgb)
            ),
        )
        img = render_frame_pallas(
            s, KEY, W, H, spp=1, uniforms="hbm", tile_rows=8, interpret=True
        )
        return jnp.mean(img[..., :3] ** 2)

    def loss_xla(em, rgb):
        s = scene.replace(
            lights=scene.lights._replace(emission=em),
            params=scene.params._replace(
                materials=scene.params.materials._replace(rgb=rgb)
            ),
        )
        img = pt.render_frame(s, KEY, W, H, spp=1, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    return loss_pal, loss_xla


def test_grad_matches_xla_detached_estimator(scene):
    """d(loss)/d(light emission, material rgb): the kernel's backward rule
    vs the XLA integrator's detached estimator on identical uniforms."""
    loss_pal, loss_xla = _losses(scene)
    em, rgb = scene.lights.emission, scene.params.materials.rgb
    g_pal = jax.grad(loss_pal, argnums=(0, 1))(em, rgb)
    g_xla = jax.grad(loss_xla, argnums=(0, 1))(em, rgb)
    np.testing.assert_allclose(_flat(g_pal), _flat(g_xla), rtol=5e-3, atol=1e-8)
    # And they are not trivially zero.
    assert np.abs(_flat(g_pal)).max() > 1e-6


def test_grad_geometry_and_camera(scene):
    """Geometry (sphere center) and camera (origin) gradients flow through
    the backward rule and match the XLA path."""

    def loss_pal(center_x, cam_z):
        s = scene.replace(
            params=scene.params._replace(
                sphere_center=scene.params.sphere_center._replace(x=center_x)
            ),
            camera=scene.camera._replace(
                origin=scene.camera.origin._replace(z=cam_z)
            ),
        )
        img = render_frame_pallas(
            s, KEY, W, H, spp=1, uniforms="hbm", tile_rows=8, interpret=True
        )
        return jnp.mean(img[..., :3] ** 2)

    def loss_xla(center_x, cam_z):
        s = scene.replace(
            params=scene.params._replace(
                sphere_center=scene.params.sphere_center._replace(x=center_x)
            ),
            camera=scene.camera._replace(
                origin=scene.camera.origin._replace(z=cam_z)
            ),
        )
        img = pt.render_frame(s, KEY, W, H, spp=1, detach=True, remat=True)
        return jnp.mean(img[..., :3] ** 2)

    cx = scene.params.sphere_center.x
    cz = scene.camera.origin.z
    g_pal = jax.grad(loss_pal, argnums=(0, 1))(cx, cz)
    g_xla = jax.grad(loss_xla, argnums=(0, 1))(cx, cz)
    np.testing.assert_allclose(_flat(g_pal), _flat(g_xla), rtol=1e-2, atol=1e-7)


@pytest.mark.slow
def test_grad_depth8_matches_xla(scene):
    """Deep-path gradients: depth 8 (2x the reference's default knob,
    scene.rs:28-30) through the backward rule."""
    deep = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=8)
    loss_pal, loss_xla = _losses(deep)
    em, rgb = deep.lights.emission, deep.params.materials.rgb
    g_pal = jax.grad(loss_pal, argnums=(0, 1))(em, rgb)
    g_xla = jax.grad(loss_xla, argnums=(0, 1))(em, rgb)
    np.testing.assert_allclose(_flat(g_pal), _flat(g_xla), rtol=5e-3, atol=1e-8)
    assert np.abs(_flat(g_pal)).max() > 1e-6


def test_value_and_grad_consistent_with_forward(scene):
    """custom_vjp's forward must be the plain forward (no estimator drift
    between the primal used for loss values and the one used for grads)."""
    loss_pal, _ = _losses(scene)
    em, rgb = scene.lights.emission, scene.params.materials.rgb
    v, _ = jax.value_and_grad(loss_pal)(em, rgb)
    v_plain = loss_pal(em, rgb)
    np.testing.assert_allclose(float(v), float(v_plain), rtol=1e-6)
