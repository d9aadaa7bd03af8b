"""The compiled Triton kernels on the card (skipped without a GPU).

Run there with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`;
chip_smoke.py runs the same comparisons at 1920x1080.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.integrator.tracer import U_PER_BOUNCE
from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.megakernel import debug_uniform_stream, render_frame_pallas

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("family", ["analytical", "sdf", "bigmesh"])
def test_compiled_kernel_matches_xla(gpu, family):
    from pathtracer_tpu.models import bigmesh, sdf

    make = {"analytical": pt.make_analytical_scene, "sdf": sdf.make_scene,
            "bigmesh": bigmesh.make_scene}[family]
    scene = make(dtype=jnp.float32, recursion_depth=4)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(pt.render_frame(scene, key, 256, 128))
    img = np.asarray(render_frame_pallas(scene, key, 256, 128, uniforms="hbm"))
    d = np.abs(ref - img)[..., :3]
    assert np.quantile(d, 0.999) < 1e-4 and d.mean() < 1e-5


def test_compiled_hash_stream_bitwise(gpu):
    n = 1 << 16
    out = np.asarray(debug_uniform_stream(99, n, 2 + 2 * U_PER_BOUNCE))
    cam, bounce = rng.hash_uniforms(jnp.int32(99), n, 2, U_PER_BOUNCE)
    xla = np.concatenate([np.asarray(cam).T,
                          np.asarray(bounce).transpose(0, 2, 1).reshape(-1, n)])
    np.testing.assert_array_equal(out, xla)
