"""Sharded fused-kernel validation (parallel/mesh.render_frame_sharded_pallas).

The multi-device path carries the fused Triton kernel under shard_map.
Because the uniform stream is keyed on GLOBAL ray indices and tiles are
carved by global tile id, the sharded launch gets the same samples and
pixel assignment as the single-device launch — integer-exact by
construction. The images are asserted equal to float32 ulp tolerance (XLA
may round the packed camera-basis floats differently inside vs outside
shard_map). Runs on the virtual 8-device CPU mesh in interpret mode.
Reference anchor: the rayon scanline pool this replaces,
rust-pathtracer/src/tracer.rs:29-32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.ops.megakernel import render_frame_pallas
from pathtracer_tpu.parallel.mesh import (
    make_mesh,
    make_train_step_sharded,
    render_frame_sharded_pallas,
)

W, H = 64, 32
KEY = jax.random.PRNGKey(11)


@pytest.fixture(scope="module")
def scene():
    return pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=3)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(4, 2, devices=jax.devices("cpu")[:8])


def test_sharded_pallas_identical_to_single_device(scene, mesh):
    single = render_frame_pallas(
        scene, KEY, W, H, spp=1, uniforms="hbm", tile_rows=8, interpret=True
    )
    sharded = render_frame_sharded_pallas(
        scene, KEY, mesh, W, H, spp=1, uniforms="hbm", tile_rows=8,
        interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(single), np.asarray(sharded), atol=2e-6, rtol=1e-6
    )


def test_sharded_pallas_spp(scene, mesh):
    """spp > 1 (interleaved sample lanes) also matches exactly."""
    single = render_frame_pallas(
        scene, KEY, W, H, spp=2, uniforms="hbm", tile_rows=8, interpret=True
    )
    sharded = render_frame_sharded_pallas(
        scene, KEY, mesh, W, H, spp=2, uniforms="hbm", tile_rows=8,
        interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(single), np.asarray(sharded), atol=2e-6, rtol=1e-6
    )


def test_sharded_block_tiling_straddling_device_range(scene, mesh):
    """Block tiling with a tile count (9) that straddles a device's range
    (8 devices, 2 local tiles each: device 4 owns one valid + one surplus
    tile). Exercises the hbm uniform-slice padding — without it,
    dynamic_slice clamps the straddling device's start and its valid tile
    reads the wrong uniform columns."""
    w, h = 100, 65  # nbx=1, nby=ceil(65/8)=9 -> 9 block tiles
    single = render_frame_pallas(
        scene, KEY, w, h, spp=1, uniforms="hbm", tile_rows=8, interpret=True,
        tiling="block",
    )
    sharded = render_frame_sharded_pallas(
        scene, KEY, mesh, w, h, spp=1, uniforms="hbm", tile_rows=8,
        interpret=True, tiling="block",
    )
    np.testing.assert_allclose(
        np.asarray(single), np.asarray(sharded), atol=2e-6, rtol=1e-6
    )


def test_sharded_pallas_grad_psums_across_devices(scene, mesh):
    """jax.grad through shard_map + the kernel's backward rule: per-device
    scene cotangents must be psum'd into the same gradient the
    single-device backward rule produces."""

    def loss(em, render):
        s = scene.replace(lights=scene.lights._replace(emission=em))
        img = render(s)
        return jnp.mean(img[..., :3] ** 2)

    em = scene.lights.emission
    g_single = jax.grad(
        lambda e: loss(
            e,
            lambda s: render_frame_pallas(
                s, KEY, W, H, spp=1, uniforms="hbm", tile_rows=8, interpret=True
            ),
        )
    )(em)
    g_sharded = jax.grad(
        lambda e: loss(
            e,
            lambda s: render_frame_sharded_pallas(
                s, KEY, mesh, W, H, spp=1, uniforms="hbm", tile_rows=8,
                interpret=True,
            ),
        )
    )(em)
    fs = np.asarray([g_single.x, g_single.y, g_single.z])
    fh = np.asarray([g_sharded.x, g_sharded.y, g_sharded.z])
    np.testing.assert_allclose(fh, fs, rtol=1e-5, atol=1e-9)
    assert np.abs(fs).max() > 1e-7


def test_sharded_train_step_pallas_kernel(scene, mesh):
    """One full inverse-rendering step through the sharded kernel
    (kernel="pallas"): finite loss, parameters move toward the target.

    The target is rendered with the SAME key/renderer the train step uses
    (common random numbers): under an independent-key single-sample MSE
    the variance-bias term dominates at this tiny size and the TRUE
    gradient pushes emission the wrong way (verified against central
    differences) — the bias integrator/inverse.paired_image_loss exists
    to remove. CRN makes the loss minimum exactly the target parameters,
    so the descent direction is well-defined."""
    target = render_frame_sharded_pallas(
        scene, KEY, mesh, W, H, spp=1, tile_rows=8, uniforms="hbm",
        interpret=True,
    )
    target_flat = jnp.asarray(np.asarray(target[..., :3]).reshape(-1, 3))
    start = scene.replace(
        lights=scene.lights._replace(emission=scene.lights.emission * 0.5)
    )
    step, (train, opt_state), _names = make_train_step_sharded(
        mesh, ("lights.emission",), start, W, H, spp=1, lr=5e-2,
        kernel="pallas", tile_rows=8, uniforms="hbm", interpret=True,
    )
    train1, opt_state, loss0 = step(train, opt_state, target_flat, KEY)
    assert np.isfinite(float(loss0))
    # emission moved up (toward the brighter target)
    before = float(jax.tree_util.tree_leaves(train)[0][0])
    after = float(jax.tree_util.tree_leaves(train1)[0][0])
    assert after > before


def test_sharded_pallas_inkernel_hash_identical(scene, mesh):
    """The in-kernel hash stream is keyed on the global ray index, so the
    sharded launch reproduces the single-device image in that mode too."""
    single = render_frame_pallas(
        scene, KEY, W, H, spp=1, uniforms="inkernel", tile_rows=8,
        interpret=True,
    )
    sharded = render_frame_sharded_pallas(
        scene, KEY, mesh, W, H, spp=1, uniforms="inkernel", tile_rows=8,
        interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(single), np.asarray(sharded), atol=2e-6, rtol=1e-6
    )
