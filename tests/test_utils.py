"""Tests for the runtime layer: buffer, image IO, checkpoint, config."""

import os

import jax
import jax.numpy as jnp
import numpy as np

import pathtracer_tpu as pt
from pathtracer_tpu.utils.buffer import ColorBuffer, new_buffer, to_u8
from pathtracer_tpu.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from pathtracer_tpu.utils.config import RenderConfig
from pathtracer_tpu.utils.image import encode_png, read_png, write_png


def test_buffer_new_and_at():
    b = new_buffer(8, 4)
    assert b.width == 8 and b.height == 4
    assert b.pixels.shape == (4, 8, 4)
    assert float(b.frames) == 0.0
    np.testing.assert_array_equal(np.asarray(b.at(3, 2)), 0.0)


def test_to_u8_gamma():
    # buffer.rs:46: rgb^0.4545 * 255, alpha linear
    px = np.zeros((1, 1, 4))
    px[0, 0] = [0.5, 1.0, 0.0, 0.5]
    u8 = to_u8(px)
    assert u8[0, 0, 0] == int(0.5 ** 0.4545 * 255.0)
    assert u8[0, 0, 1] == 255
    assert u8[0, 0, 2] == 0
    assert u8[0, 0, 3] == 127


def test_to_u8_saturates_hdr():
    px = np.full((1, 1, 4), 9.5)
    u8 = to_u8(px)
    assert np.all(u8[0, 0] == 255)


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    back = read_png(p)
    np.testing.assert_array_equal(back, img)


def test_png_rgb_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 9, 3), dtype=np.uint8)
    p = str(tmp_path / "t3.png")
    write_png(p, img)
    np.testing.assert_array_equal(read_png(p), img)


def test_png_readable_by_pil(tmp_path):
    try:
        from PIL import Image
    except ImportError:
        return
    img = np.arange(4 * 6 * 4, dtype=np.uint8).reshape(4, 6, 4)
    p = str(tmp_path / "pil.png")
    write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


def test_checkpoint_roundtrip(tmp_path):
    buf = ColorBuffer(
        pixels=jnp.asarray(np.random.default_rng(0).random((4, 6, 4))),
        frames=jnp.asarray(7.0),
    )
    key = jax.random.PRNGKey(3)
    state = (buf, key, 12)
    p = str(tmp_path / "ckpt_000012.npz")
    save_checkpoint(p, state)
    back = load_checkpoint(p, (buf, key, 0))
    np.testing.assert_array_equal(np.asarray(back[0].pixels), np.asarray(buf.pixels))
    np.testing.assert_array_equal(np.asarray(back[1]), np.asarray(key))
    assert int(back[2]) == 12
    assert latest_checkpoint(str(tmp_path)) == p


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    # Same leaf count, different pytree structure: must raise, not silently
    # misassign leaves.
    import pytest

    a = (jnp.zeros((2, 2)), jnp.ones(3), 5)
    p = str(tmp_path / "ckpt_000001.npz")
    save_checkpoint(p, a)
    # different structure, same leaf count
    b = ((jnp.zeros((2, 2)), jnp.ones(3)), 5)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(p, b)
    # different leaf count
    c = (jnp.zeros((2, 2)), 5)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(p, c)
    # different leaf shape
    d = (jnp.zeros((3, 2)), jnp.ones(3), 5)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(p, d)


def test_config_json_roundtrip():
    cfg = RenderConfig(width=123, frames=9, quirks="fixed", precision="f64")
    back = RenderConfig.from_json(cfg.to_json())
    assert back == cfg
    assert back.dtype == jnp.float64
    assert back.quirk_flags == pt.FIXED
    assert RenderConfig().quirk_flags == pt.VERBATIM


def test_resume_equals_straight_run():
    # checkpoint/resume bit-exactness: 2+2 frames == 4 frames straight.
    scene = pt.make_analytical_scene(dtype=jnp.float64)
    W, H = 16, 12

    def run(n, buf, frames, key):
        for _ in range(n):
            key, sub = jax.random.split(key)
            frame = pt.render_frame(scene, sub, W, H)
            buf, frames = pt.accumulate(buf, frame, frames)
        return buf, frames, key

    b0 = jnp.zeros((H, W, 4), jnp.float64)
    straight, _, _ = run(4, b0, jnp.asarray(0.0), jax.random.PRNGKey(0))

    half, hf, hk = run(2, b0, jnp.asarray(0.0), jax.random.PRNGKey(0))
    resumed, _, _ = run(2, half, hf, hk)
    np.testing.assert_array_equal(np.asarray(straight), np.asarray(resumed))
