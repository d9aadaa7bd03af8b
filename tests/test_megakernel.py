"""Fused-kernel validation (ops/megakernel.py).

The Triton-route kernel runs in Pallas interpret mode on CPU (the compiled
kernel is checked on the GPU by chip_smoke.py). The hbm-uniforms mode
consumes the exact threefry stream of the XLA integrator, so the kernel is
checked allclose against integrator.tracer.render_frame, which is itself
validated against the f64 CPU oracle (test_oracle_parity.py). Also here:
the GPU block shape and padding rules, and the lane -> ray maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.integrator.tracer import render_frame
from pathtracer_tpu.ops import megakernel as mk
from pathtracer_tpu.ops.megakernel import pack_scene, render_frame_pallas


@pytest.fixture(scope="module")
def scene():
    return pt.make_analytical_scene()


def test_hbm_parity_vs_xla(scene):
    """Bitwise-same sampling decisions => image parity to f32 reassociation
    noise (isolated knife-edge pixels may flip a discrete branch, so compare
    via quantile rather than max)."""
    key = jax.random.PRNGKey(3)
    w, h = 64, 48
    ref = np.asarray(render_frame(scene, key, w, h, spp=1))
    img = np.asarray(
        render_frame_pallas(
            scene, key, w, h, spp=1, uniforms="hbm", tile_rows=8, interpret=True
        )
    )
    diff = np.abs(ref - img)
    assert np.isfinite(img).all()
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


def test_tiling_modes_match_xla(scene):
    """Both tile layouts — flat ray ranges and compact 2-D pixel blocks
    (the default at spp=1, chosen for SDF march coherence) — must match
    the XLA image on hbm uniforms, at an edge-exercising
    non-multiple-of-tile size. The per-ray threefry stream makes the image
    tiling-invariant."""
    key = jax.random.PRNGKey(9)
    w, h = 150, 37
    ref = np.asarray(render_frame(scene, key, w, h, spp=1))
    for tiling in ("flat", "block"):
        img = np.asarray(
            render_frame_pallas(
                scene, key, w, h, spp=1, uniforms="hbm", tile_rows=8,
                interpret=True, tiling=tiling,
            )
        )
        diff = np.abs(ref - img)
        assert np.isfinite(img).all(), tiling
        assert np.quantile(diff, 0.999) < 1e-4, tiling
        assert diff.mean() < 1e-5, tiling


def test_block_tiling_spp_parity_vs_xla(scene):
    """spp-interleaved block tiling (a pixel's spp samples in adjacent
    lanes): per-ray hbm threefry streams make the spp-mean image match the
    XLA integrator tightly, edge sizes included."""
    key = jax.random.PRNGKey(21)
    w, h = 150, 37
    ref = np.asarray(render_frame(scene, key, w, h, spp=2))
    img = np.asarray(
        render_frame_pallas(
            scene, key, w, h, spp=2, uniforms="hbm", tile_rows=8,
            interpret=True, tiling="block",
        )
    )
    diff = np.abs(ref - img)
    assert np.isfinite(img).all()
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


def test_hbm_parity_multi_spp(scene):
    key = jax.random.PRNGKey(11)
    w, h = 32, 24
    img = np.asarray(
        render_frame_pallas(
            scene, key, w, h, spp=4, uniforms="hbm", tile_rows=8, interpret=True
        )
    )
    assert img.shape == (h, w, 4)
    assert np.isfinite(img).all()
    assert (img[..., 3] == 1.0).all()
    # STRICT parity (round 4): _uniform_rows now interleaves the XLA
    # path's per-sample threefry streams (render_frame splits the key into
    # spp subkeys), so the spp-mean image matches the XLA integrator
    # per-pixel — not merely in expectation.
    ref = np.asarray(render_frame(scene, key, w, h, spp=4))
    diff = np.abs(ref - img)
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


def test_pack_scene_roundtrip(scene):
    sp = pack_scene(scene, 64, 48)
    assert sp.ndim == 2 and sp.shape[0] == 1
    assert np.isfinite(np.asarray(sp)).all()


def test_inkernel_rng_mode(scene):
    """Hash-uniform mode: the kernel's in-kernel stream, replayed through
    the XLA integrator on the same rays (the backward rule's twin,
    _xla_planes), gives the same image."""
    key = jax.random.PRNGKey(0)
    w, h = 32, 24
    img = np.asarray(
        render_frame_pallas(
            scene, key, w, h, spp=1, uniforms="inkernel", tile_rows=8,
            interpret=True,
        )
    )
    assert img.shape == (24, 32, 4)
    assert np.isfinite(img).all()
    cfg = mk._KernelConfig(
        backend_name="analytical", meta=mk._analytical_meta(scene) + (False,),
        width=w, height=h, spp=1, depth=scene.recursion_depth, tile_rows=8,
        quirks=pt.VERBATIM, inkernel_rng=True, interpret=True,
    )
    n_tiles = mk.num_tiles_for(w, h, 1, 8, "block")
    seed = jax.random.randint(key, (1, 1), 0, jnp.iinfo(jnp.int32).max, jnp.int32)
    planes = mk._xla_planes(cfg, n_tiles, scene, seed,
                            jnp.zeros((1, 1), jnp.int32), None)
    ref = np.asarray(mk.assemble_image(planes, w, h, 1, 8, "block"))
    diff = np.abs(ref - img)
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


def test_hbm_parity_mixed_light_types():
    """Rect + distant + spherical lights through the kernel's type-dispatched
    where-chains match the XLA integrator on the same threefry stream."""
    lights = pt.concat_lights(
        pt.spherical_light((3.0, 2.0, 2.0), 1.0, (3.0, 3.0, 3.0)),
        pt.rect_light((-1.0, 4.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), (4.0, 4.0, 4.0)),
        pt.distant_light((0.3, 0.8, 0.5), (2.0, 2.0, 2.0)),
    )
    scene = pt.make_analytical_scene(lights=lights)
    key = jax.random.PRNGKey(5)
    w, h = 32, 24
    ref = np.asarray(render_frame(scene, key, w, h, spp=1))
    img = np.asarray(
        render_frame_pallas(
            scene, key, w, h, spp=1, uniforms="hbm", tile_rows=8, interpret=True
        )
    )
    diff = np.abs(ref - img)
    assert np.isfinite(img).all()
    assert np.quantile(diff, 0.999) < 1e-4


@pytest.mark.parametrize("tile_rows,warps", [(1, 1), (4, 4), (8, 8), (16, 16)])
def test_block_shape_one_ray_per_thread(tile_rows, warps):
    """A (tile_rows, LANES) tile runs one ray per thread: one warp a row."""
    assert mk.LANES == 32
    assert mk.num_warps_for(tile_rows) == warps


@pytest.mark.parametrize("tile_rows", [0, 3, 12, 32])
def test_block_shape_rejects_non_pow2(tile_rows):
    """Triton block sides must be powers of two; rows > 16 would not fit
    the path state in registers."""
    with pytest.raises(ValueError):
        mk.num_warps_for(tile_rows)


@pytest.mark.parametrize("p", [1, 2, 3, 57, 64, 65])
def test_pad_pow2_scalar_vector(p):
    sv = jnp.arange(1, p + 1, dtype=jnp.float32)[None, :]
    out = np.asarray(mk.pad_pow2(sv))
    q = out.shape[1]
    assert out.shape[0] == 1 and q >= p and q & (q - 1) == 0 and q < 2 * max(p, 1)
    np.testing.assert_array_equal(out[0, :p], np.arange(1, p + 1))
    assert (out[0, p:] == 0).all()


@pytest.mark.parametrize("tiling,spp", [("flat", 1), ("flat", 3), ("block", 1),
                                        ("block", 2), ("block", 4)])
def test_lane_rays_cover_every_ray(tiling, spp):
    """Every ray of the frame is owned by some lane; block tiling at an
    exact multiple size maps lanes to rays one to one, and tiles count as
    num_tiles_for says."""
    w, h, tr = 64, 8, 4
    w = w // spp if tiling == "block" else w
    n = w * h * spp
    nt = mk.num_tiles_for(w, h, spp, tr, tiling)
    lanes = mk._lane_ray_map(w, h, spp, tr, tiling, nt)
    assert lanes.size == nt * tr * mk.LANES
    valid = lanes[lanes >= 0]
    assert set(valid.tolist()) == set(range(n))
    if tiling == "block":
        assert valid.size == n  # exact multiple: no duplicates


def test_resolve_tiling():
    assert mk.resolve_tiling("auto", 1) == "block"
    assert mk.resolve_tiling("auto", 3) == "flat"
    with pytest.raises(ValueError):
        mk.resolve_tiling("square", 1)
