"""f32 production path vs the f64 scalar oracle: quantified error bands.

The oracle-parity suite runs f64-vs-f64 (exact); THIS file is the f32 story
the suite needs beside it: render the float32 production paths (XLA
integrator and the fused Pallas kernel in interpreter mode) against the float64 oracle on identical threefry sample
decisions, and assert the error distribution stays inside measured bands.

Measured on 24x16 (depth 4 and 8, analytical demo, 2026-08-19):

  | config        | rel p50 | rel p95 | rel p99 | rel max |
  |---------------|---------|---------|---------|---------|
  | XLA f32, d=4  | 1.1e-07 | 2.5e-06 | 6.9e-06 | 1.6e-03 |
  | XLA f32, d=8  | 1.3e-07 | 3.1e-06 | 4.9e-05 | 9.5e-04 |

(relative to oracle value + 1e-3). The asserted bands below carry ~10x
headroom for platform-dependent rounding, but would still catch any
discrete-decision divergence (a lobe/light pick flipping under f32 produces
O(1) pixel error, far outside the max band).
"""

import jax
import jax.numpy as jnp
import numpy as np

import pathtracer_tpu as pt
from oracle_cache import cached_render
from pathtracer_tpu.oracle import cpu_oracle as O

W, H = 24, 16

# rel-error quantile bands: (p50, p95, p99, max)
BANDS = (1e-6, 5e-5, 5e-4, 1e-2)


def _rel_error_f32_vs_oracle(depth, seed, quirks=None):
    quirks = quirks or pt.VERBATIM
    scene32 = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=depth)
    key = jax.random.PRNGKey(seed)
    img32 = np.asarray(
        pt.render_frame(scene32, key, W, H, quirks=quirks), np.float64
    )

    # The f32 path's OWN uniforms, widened: both implementations consume
    # bit-identical sample decisions, so the residual is pure rounding.
    cam_u, bounce_u = pt.draw_uniforms(key, W * H, depth, jnp.float32)
    scene64 = pt.make_analytical_scene(dtype=jnp.float64, recursion_depth=depth)
    osc = O.OracleScene(
        scene64.params, scene64.lights, scene64.camera, recursion_depth=depth
    )
    img64 = cached_render(
        osc, W, H, np.asarray(cam_u, np.float64), np.asarray(bounce_u, np.float64),
        stale_emitter_gate=quirks.stale_emitter_gate,
        primary_mis=quirks.primary_mis,
    )
    err = np.abs(img32[..., :3] - img64[..., :3])
    return err / (np.abs(img64[..., :3]) + 1e-3), img32, img64


def _assert_bands(rel, where):
    p50, p95, p99, mx = BANDS
    assert np.percentile(rel, 50) < p50, f"{where}: p50 {np.percentile(rel, 50):.2e}"
    assert np.percentile(rel, 95) < p95, f"{where}: p95 {np.percentile(rel, 95):.2e}"
    assert np.percentile(rel, 99) < p99, f"{where}: p99 {np.percentile(rel, 99):.2e}"
    assert rel.max() < mx, f"{where}: max {rel.max():.2e}"


def test_f32_xla_depth4_error_bands():
    rel, _, _ = _rel_error_f32_vs_oracle(depth=4, seed=0)
    _assert_bands(rel, "xla f32 depth4")


def test_f32_xla_depth8_error_bands():
    rel, _, _ = _rel_error_f32_vs_oracle(depth=8, seed=3)
    _assert_bands(rel, "xla f32 depth8")


def test_f32_xla_fixed_quirks_error_bands():
    rel, _, _ = _rel_error_f32_vs_oracle(depth=4, seed=1, quirks=pt.FIXED)
    _assert_bands(rel, "xla f32 fixed-quirks")


def test_f32_pallas_vs_oracle_error_bands():
    """The megakernel (interpret mode, hbm threefry uniforms) at f32 against
    the f64 oracle — the production fast path, not just the XLA path,
    carries a quantified tolerance to golden values."""
    from pathtracer_tpu.ops.megakernel import render_frame_pallas

    depth, seed = 4, 0
    scene32 = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=depth)
    key = jax.random.PRNGKey(seed)
    img32 = np.asarray(
        render_frame_pallas(
            scene32, key, W, H, uniforms="hbm", interpret=True, tile_rows=8
        ),
        np.float64,
    )
    cam_u, bounce_u = pt.draw_uniforms(key, W * H, depth, jnp.float32)
    scene64 = pt.make_analytical_scene(dtype=jnp.float64, recursion_depth=depth)
    osc = O.OracleScene(
        scene64.params, scene64.lights, scene64.camera, recursion_depth=depth
    )
    img64 = cached_render(
        osc, W, H, np.asarray(cam_u, np.float64), np.asarray(bounce_u, np.float64),
        stale_emitter_gate=True, primary_mis=True,
    )
    rel = np.abs(img32[..., :3] - img64[..., :3]) / (
        np.abs(img64[..., :3]) + 1e-3
    )
    _assert_bands(rel, "pallas f32 depth4")


def test_f32_sdf_tracks_f64():
    """The SDF backend has no scalar oracle; its precision gate is f32 vs
    f64 of the SAME implementation on identical sample decisions. Sphere
    tracing amplifies rounding (iterated marching), so bands are wider but
    still far below any decision-flip signature."""
    from pathtracer_tpu.models.sdf import make_scene as make_sdf_scene

    from pathtracer_tpu.integrator.tracer import trace
    from pathtracer_tpu.models.camera import gen_ray, pixel_coords
    from pathtracer_tpu.ops.vecmath import V2

    depth, seed = 4, 2
    key = jax.random.PRNGKey(seed)
    # One shared decision stream: threefry f32 and f64 draws from the same
    # key are UNRELATED sequences (observed under jax 0.9 partitionable
    # threefry), so rendering each dtype with its own internal draw
    # compares two different Monte-Carlo estimates, not two precisions.
    # Draw once in f32 and widen — identical sample decisions, residual is
    # pure rounding (same technique as the oracle-band tests above).
    cam_u, bounce_u = pt.draw_uniforms(key, W * H, depth, jnp.float32)
    imgs = {}
    for dtype in (jnp.float32, jnp.float64):
        scene = make_sdf_scene(dtype=dtype, recursion_depth=depth)
        coords = pixel_coords(W, H, dtype)
        offset = V2(cam_u[:, 0].astype(dtype), cam_u[:, 1].astype(dtype))
        ro, rd = gen_ray(scene.camera, coords, offset, float(W), float(H))
        radiance = trace(scene, ro, rd, bounce_u.astype(dtype))
        imgs[dtype] = np.stack(
            [np.asarray(radiance.x, np.float64).reshape(H, W),
             np.asarray(radiance.y, np.float64).reshape(H, W),
             np.asarray(radiance.z, np.float64).reshape(H, W)],
            axis=-1,
        )
    # Iterated sphere-trace marching amplifies rounding; tiny decision
    # jitter is possible at silhouettes — quantile bands, isolated
    # outliers allowed.
    rel = np.abs(imgs[jnp.float32] - imgs[jnp.float64]) / (
        np.abs(imgs[jnp.float64]) + 1e-3
    )
    assert np.percentile(rel, 50) < 5e-4, np.percentile(rel, 50)
    assert np.percentile(rel, 95) < 5e-2, np.percentile(rel, 95)
    assert (rel > 0.5).mean() < 0.02, (rel > 0.5).mean()
