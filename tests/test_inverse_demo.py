"""recover_demo entry point (integrator/inverse.py + app/invert.py):
BASELINE config 4 — recover albedo/roughness/light emission from a target
render — exercised tiny on CPU through the fused-kernel path with
checkpoint/resume. Anchor: the dormant scriptable-materials intent this
inverts (/root/reference/rust-pathtracer/src/material.rs:77).
"""

import os

import jax
import numpy as np
import pytest

from pathtracer_tpu.integrator.inverse import recover_demo


@pytest.mark.slow
def test_recover_demo_pallas_with_checkpoint(tmp_path):
    ckpt = str(tmp_path / "inv")
    report = recover_demo(
        key=jax.random.PRNGKey(1),
        width=32, height=16, steps=3, lr=5e-2,
        kernel="pallas", tile_rows=8, interpret=True,
        ckpt_dir=ckpt, ckpt_every=2,
        recursion_depth=2, verbose=False,
    )
    assert len(report.rows) > 0
    # every selected leaf reported with finite values
    for r in report.rows:
        assert np.isfinite([r.true_value, r.start_value, r.recovered]).all()
    assert np.isfinite(np.asarray(report.losses)).all()
    assert report.losses.shape == (3,)
    # checkpoints written at steps 2 and 3 (final)
    names = sorted(os.listdir(ckpt))
    assert names and names[-1].startswith("invert_")

    # resume: asking for one more step runs exactly one
    report2 = recover_demo(
        key=jax.random.PRNGKey(1),
        width=32, height=16, steps=4, lr=5e-2,
        kernel="pallas", tile_rows=8, interpret=True,
        ckpt_dir=ckpt, ckpt_every=2,
        recursion_depth=2, verbose=False,
    )
    assert report2.losses.shape == (1,)


def test_recover_demo_xla_moves_toward_target():
    """The XLA path, a few more steps: the dimmed light's recovered
    emission must move up toward the true value (CRN paired loss makes
    the descent direction well-defined even at tiny sizes)."""
    report = recover_demo(
        key=jax.random.PRNGKey(3),
        width=32, height=16, steps=10, lr=5e-2,
        kernel="xla", select=("lights.emission",),
        recursion_depth=2, verbose=False,
    )
    for r in report.rows:
        # started at 0.45x true; must have moved strictly toward true
        assert abs(r.recovered - r.true_value) < abs(r.start_value - r.true_value)


def test_recover_demo_sdf_geometry_moves_toward_target():
    """scene='sdf': geometry recovery through the implicit-function
    hit-distance gradients — the shrunk sphere radius must move back
    toward the true value."""
    report = recover_demo(
        key=jax.random.PRNGKey(5),
        width=32, height=16, steps=6, lr=4e-2,
        kernel="xla", scene="sdf", select=("sphere_radius",),
        recursion_depth=2, verbose=False,
    )
    for r in report.rows:
        assert abs(r.recovered - r.true_value) < abs(r.start_value - r.true_value)
