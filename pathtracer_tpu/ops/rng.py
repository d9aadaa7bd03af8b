"""Counter-based uniforms: one integer hash of (frame seed, ray, draw).

The fused kernel evaluates `uniform(ray_key(seed, ray), draw)` where each
uniform is consumed, so no uniform tensor is ever written to device memory.
The same jnp functions run in XLA (`hash_uniforms`), bit for bit: the
kernel's backward rule replays the kernel's sample stream through the XLA
integrator, and tests/test_rng.py checks both evaluations against each
other. The stream is keyed on the global ray index (pixel * spp + sample),
so it does not depend on how rays are grouped into blocks or devices.

The mixer is the murmur3 32-bit finalizer (fmix32), a bijection of uint32
with full avalanche; a uniform keeps the top 24 bits, scaled by 2^-24.
"""

from __future__ import annotations

import jax.numpy as jnp

_INV24 = float(1.0 / (1 << 24))


def fmix32(h):
    """murmur3 finalizer on uint32 (wrapping arithmetic)."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def seed_word(seed):
    """The frame seed (int32 scalar), scrambled to a uint32."""
    return fmix32(jnp.asarray(seed).astype(jnp.uint32) + jnp.uint32(0x9E3779B9))


def ray_key(seed, ray):
    """Per-ray key: seed (int32 scalar), ray (int32 array of global ray
    indices). Distinct rays of one frame get distinct keys (bijective).

    The seed is added after one mixing round of the ray index: a seed
    folded into the raw index (ray ^ S) would make another frame's keys
    this frame's keys handed to other rays (ray ^ S1 ^ S2) whenever S1 ^ S2
    is small, so two frames' key sets overlap only by chance here."""
    r = fmix32(jnp.asarray(ray).astype(jnp.uint32))
    return fmix32(r + seed_word(seed))


def uniform(key, draw):
    """Uniform in [0, 1) for draw index `draw` (int, possibly traced) of
    the ray with key `key`."""
    d = fmix32(jnp.asarray(draw).astype(jnp.uint32) * jnp.uint32(0x27D4EB2F)
               + jnp.uint32(0x165667B1))
    h = fmix32(key ^ d)
    return (h >> 8).astype(jnp.int32).astype(jnp.float32) * _INV24


def hash_uniforms(seed, n: int, depth: int, u_per_bounce: int):
    """XLA evaluation of the kernel's stream for rays 0..n-1, in the
    layout of integrator.tracer.draw_uniforms: (cam [n, 2],
    bounce [depth, n, u_per_bounce]). Draw order per ray is
    [cam x, cam y, bounce0 u0.., bounce1 u0.., ...]."""
    return hash_uniforms_for(seed, jnp.arange(n, dtype=jnp.int32), depth,
                             u_per_bounce)


def hash_uniforms_for(seed, rays, depth: int, u_per_bounce: int):
    """hash_uniforms for an arbitrary int32 array of ray indices [n]."""
    key = ray_key(seed, rays)
    cam = jnp.stack([uniform(key, 0), uniform(key, 1)], axis=-1)
    draws = jnp.arange(2, 2 + depth * u_per_bounce, dtype=jnp.int32)
    bounce = uniform(key[None, :], draws[:, None])  # [depth*U, n]
    bounce = bounce.reshape(depth, u_per_bounce, -1).transpose(0, 2, 1)
    return cam, bounce
