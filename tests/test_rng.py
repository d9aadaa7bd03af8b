"""Counter-based uniform stream validation (ops/rng.py).

Two layers:
1. The 24-bit uniform CONSTRUCTION (bits >> 8) * 2^-24 is validated in pure
   numpy against known patterns and a KS test on simulated uniform bits.
2. The hash stream itself, as the fused kernel evaluates it
   (megakernel.debug_uniform_stream, a Triton-route kernel run in the
   Pallas interpreter here): uniformity (KS), independence across rays and
   frames, and bit-for-bit equality with the XLA evaluation
   (rng.hash_uniforms) that the kernel's backward rule replays.
"""

import jax.numpy as jnp
import numpy as np

from pathtracer_tpu.integrator.tracer import U_PER_BOUNCE
from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.megakernel import LANES, TILE_ROWS, debug_uniform_stream

TILE = TILE_ROWS * LANES


def _construction(bits: np.ndarray) -> np.ndarray:
    """Reference model of the kernel's mapping (ops/megakernel.py uniform():
    top 24 bits of a uint32, scaled by 2^-24 via an exact i32 cast)."""
    hi24 = (bits.astype(np.uint32) >> np.uint32(8)).astype(np.int64)
    return hi24.astype(np.float64) * (1.0 / (1 << 24))


def test_construction_exact_endpoints():
    # all-zero bits -> 0.0; all-one bits -> (2^24-1)/2^24, strictly < 1
    out = _construction(np.asarray([0x00000000, 0xFFFFFFFF], np.uint32))
    assert out[0] == 0.0
    assert out[1] == (2**24 - 1) / 2**24
    assert out[1] < 1.0
    # resolution is exactly 2^-24: adjacent hi24 values differ by one ulp24
    out2 = _construction(np.asarray([0x00000100, 0x00000200], np.uint32))
    assert out2[1] - out2[0] == 1.0 / 2**24
    # low 8 bits are discarded
    out3 = _construction(np.asarray([0x12345678, 0x123456FF], np.uint32))
    assert out3[0] == out3[1]


def test_construction_uniformity_ks():
    # With ideal uniform uint32 bits, the mapping must be uniform on
    # [0, 1 - 2^-24]. One-sample KS against U(0,1): n = 1e6, the 2^-24
    # truncation shifts D by < 6e-8 — far under the threshold.
    rng = np.random.default_rng(0)
    n = 1_000_000
    u = _construction(rng.integers(0, 2**32, n, dtype=np.uint32))
    u_sorted = np.sort(u)
    grid = (np.arange(1, n + 1)) / n
    d = np.max(np.maximum(np.abs(u_sorted - grid), np.abs(u_sorted - grid + 1.0 / n)))
    # KS 1% critical value ~ 1.63/sqrt(n)
    assert d < 1.63 / np.sqrt(n), d


def _stream(seed, n_rays, n_uniforms):
    return np.asarray(
        debug_uniform_stream(seed, n_rays, n_uniforms, interpret=True)
    )


def test_inkernel_stream_uniformity():
    out = _stream(seed=1234, n_rays=4 * TILE, n_uniforms=8)
    flat = out.reshape(-1).astype(np.float64)
    n = flat.size
    assert flat.min() >= 0.0 and flat.max() < 1.0
    # KS at 1%
    s = np.sort(flat)
    grid = np.arange(1, n + 1) / n
    d = np.max(np.maximum(np.abs(s - grid), np.abs(s - grid + 1.0 / n)))
    assert d < 1.63 / np.sqrt(n), d
    # mean/variance of U(0,1)
    assert abs(flat.mean() - 0.5) < 0.005
    assert abs(flat.var() - 1.0 / 12.0) < 0.002


def test_inkernel_streams_tile_independent():
    """Rays of different tiles, neighbouring rays, and successive draws of
    one ray must be uncorrelated; the same (seed, ray, draw) reproduces
    bit-exactly; another frame seed decorrelates everything."""
    # 8 groups of 1024 rays (8 tiles each): 4096 draws per group, so the
    # 0.05 bound is > 3 sigma of an independent pair's sample correlation.
    group = 8 * TILE
    out = _stream(seed=42, n_rays=8 * group, n_uniforms=4)
    tiles = out.reshape(4, 8, group).transpose(1, 0, 2).reshape(8, -1)
    for i in range(8):
        for j in range(i + 1, 8):
            r = np.corrcoef(tiles[i], tiles[j])[0, 1]
            assert abs(r) < 0.05, (i, j, r)
    # neighbouring rays (lag 1) and consecutive draws of the same ray
    assert abs(np.corrcoef(out[0, :-1], out[0, 1:])[0, 1]) < 0.05
    for a in range(3):
        assert abs(np.corrcoef(out[a], out[a + 1])[0, 1]) < 0.05
    again = _stream(seed=42, n_rays=8 * group, n_uniforms=4)
    np.testing.assert_array_equal(out, again)
    other = _stream(seed=43, n_rays=8 * group, n_uniforms=4)
    assert np.mean(out == other) < 0.01
    assert abs(np.corrcoef(out.reshape(-1), other.reshape(-1))[0, 1]) < 0.05


def test_inkernel_stream_matches_xla_bitwise():
    """The kernel's evaluation and the XLA evaluation of the hash are the
    same integer function: equal bit for bit, in draw order
    [cam x, cam y, bounce0 u0.., ...]."""
    depth, n = 2, 2 * TILE
    out = _stream(seed=7, n_rays=n, n_uniforms=2 + depth * U_PER_BOUNCE)
    cam, bounce = rng.hash_uniforms(jnp.int32(7), n, depth, U_PER_BOUNCE)
    xla = np.concatenate([
        np.asarray(cam).T,
        np.asarray(bounce).transpose(0, 2, 1).reshape(-1, n),
    ])
    np.testing.assert_array_equal(out, xla)


def test_hash_keys_distinct_per_ray():
    """ray_key is a bijection of the ray index for a fixed seed, so no two
    rays of a frame share a stream."""
    keys = np.asarray(rng.ray_key(jnp.int32(3), jnp.arange(1 << 16, dtype=jnp.int32)))
    assert np.unique(keys).size == keys.size


def _close_seed_pair(n_bits: int):
    """Two frame seeds whose scrambled words differ only in the low n_bits
    bits: the worst case for a seed folded linearly into the ray index."""
    seeds = np.arange(1 << 12, dtype=np.int32)
    hi = np.asarray(rng.seed_word(jnp.asarray(seeds))) >> np.uint32(n_bits)
    order = np.argsort(hi, kind="stable")
    same = np.nonzero(hi[order][1:] == hi[order][:-1])[0]
    assert same.size, "no close pair among 4096 seeds"
    return int(seeds[order[same[0]]]), int(seeds[order[same[0] + 1]])


def test_hash_key_sets_of_two_frames_barely_overlap():
    """Two frames' per-ray key sets share only chance collisions of 32-bit
    keys (n^2 / 2^32 expected, 1 here): no frame replays another frame's
    streams on other rays, even for seeds whose scrambled words are close."""
    n_bits = 16
    rays = jnp.arange(1 << n_bits, dtype=jnp.int32)
    for s1, s2 in ((0, 1), (3, 4), _close_seed_pair(n_bits)):
        k1 = np.asarray(rng.ray_key(jnp.int32(s1), rays))
        k2 = np.asarray(rng.ray_key(jnp.int32(s2), rays))
        shared = np.intersect1d(k1, k2).size
        assert shared <= 16, (s1, s2, shared)
