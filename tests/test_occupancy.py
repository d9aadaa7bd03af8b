"""In-kernel divergence metrics (ops/megakernel.measure_occupancy_pallas,
ops/megakernel_sdf.measure_march_steps).

The reference's per-pixel `break`s (rust-pathtracer/src/tracer.rs:66-97)
become masked lanes in the fused kernel; these instruments measure what the
masking costs inside the kernel itself. With hbm uniforms the kernel's
sampling decisions are the XLA integrator's, so the in-kernel alive counts
must reproduce integrator.tracer.measure_occupancy exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np

import pathtracer_tpu as pt
from pathtracer_tpu.integrator.tracer import measure_occupancy
from pathtracer_tpu.models.sdf import make_scene as make_sdf_scene
from pathtracer_tpu.ops.megakernel import measure_occupancy_pallas
from pathtracer_tpu.ops.megakernel_sdf import MARCH_BLOCK, measure_march_steps

KEY = jax.random.PRNGKey(4)
W, H = 128, 32  # exact multiple of (LANES, tile_rows): no padded lanes


def test_kernel_occupancy_matches_xla_probe():
    scene = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=3)
    for tiling in ("flat", "block"):
        stats = measure_occupancy_pallas(
            scene, KEY, W, H, tile_rows=8, uniforms="hbm", interpret=True,
            tiling=tiling,
        )
        frac = stats["alive_fraction"]
        assert frac[0] == 1.0  # every lane enters bounce 0
        assert (np.diff(frac) <= 0).all()  # lanes only die
        xla = np.asarray(measure_occupancy(scene, KEY, W, H))
        np.testing.assert_allclose(frac, xla, atol=1e-6)
        assert stats["counts"].shape == (stats["num_tiles"], 3)


def test_sdf_march_step_counts():
    sdf = make_sdf_scene(dtype=jnp.float32, recursion_depth=2)
    for tiling in ("flat", "block"):
        ms = measure_march_steps(
            sdf, W, H, tile_rows=8, tiling=tiling, interpret=True
        )
        assert ms["steps_per_tile"].shape == (ms["num_tiles"],)
        # trip counts are block-granular and within the march budget
        assert (ms["steps_per_tile"] % MARCH_BLOCK == 0).all()
        assert 0 < ms["mean_steps"] <= ms["max_steps"] <= 96
