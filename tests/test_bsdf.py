"""Disney BSDF parity: vectorized JAX lobes vs the scalar f64 oracle,
plus physical invariants (energy positivity, pdf normalization by MC)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.material import default_material, finalize_material
from pathtracer_tpu.ops import bsdf as B
from pathtracer_tpu.ops import sampling as S
from pathtracer_tpu.ops.vecmath import V3, normalize, v3
from pathtracer_tpu.oracle import cpu_oracle as O

N_CASES = 256


def _rand_materials(rng, n):
    """Random finalized materials spanning all four lobes."""
    m = default_material((n,), jnp.float64)
    m = m._replace(
        rgb=V3(*[jnp.asarray(rng.random(n)) for _ in range(3)]),
        metallic=jnp.asarray(rng.random(n)),
        roughness=jnp.asarray(rng.random(n)),
        subsurface=jnp.asarray(rng.random(n)),
        specular_tint=jnp.asarray(rng.random(n)),
        sheen=jnp.asarray(rng.random(n)),
        sheen_tint=jnp.asarray(rng.random(n)),
        clearcoat=jnp.asarray(rng.random(n)),
        clearcoat_gloss=jnp.asarray(rng.random(n)),
        spec_trans=jnp.asarray(rng.random(n)),
        anisotropic=jnp.asarray(rng.random(n)),
        ior=jnp.asarray(1.0 + rng.random(n)),
    )
    return finalize_material(m)


def _mat_row(m, i):
    d = O.material_new()
    d["rgb"] = np.array(
        [float(m.rgb.x[i]), float(m.rgb.y[i]), float(m.rgb.z[i])]
    )
    for k in (
        "anisotropic", "metallic", "roughness", "subsurface", "specular_tint",
        "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
        "clearcoat_roughness", "spec_trans", "ior", "ax", "ay",
    ):
        d[k] = float(getattr(m, k)[i])
    return d


def _rand_units(rng, n):
    a = rng.standard_normal((3, n))
    a /= np.linalg.norm(a, axis=0, keepdims=True)
    return V3(jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[2]))


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_disney_eval_matches_oracle(rng):
    n = N_CASES
    m = _rand_materials(rng, n)
    nrm = _rand_units(rng, n)
    vv = _rand_units(rng, n)
    ll = _rand_units(rng, n)
    eta = jnp.asarray(0.5 + rng.random(n))

    f, pdf = B.disney_eval(m, eta, vv, nrm, ll)
    f = np.asarray(f.stack())
    pdf = np.asarray(pdf)

    for i in range(n):
        fo, po = O.disney_eval(
            _mat_row(m, i),
            float(eta[i]),
            np.array([float(vv.x[i]), float(vv.y[i]), float(vv.z[i])]),
            np.array([float(nrm.x[i]), float(nrm.y[i]), float(nrm.z[i])]),
            np.array([float(ll.x[i]), float(ll.y[i]), float(ll.z[i])]),
        )
        np.testing.assert_allclose(f[i], fo, rtol=1e-9, atol=1e-12, err_msg=f"case {i}")
        np.testing.assert_allclose(pdf[i], po, rtol=1e-9, atol=1e-12)


def test_disney_sample_matches_oracle(rng):
    n = N_CASES
    m = _rand_materials(rng, n)
    nrm = _rand_units(rng, n)
    vv = _rand_units(rng, n)
    prev_l = _rand_units(rng, n)
    eta = jnp.asarray(0.5 + rng.random(n))
    u = jnp.asarray(rng.random((n, 3)))

    bs = B.disney_sample(m, eta, vv, nrm, prev_l, u)
    f = np.asarray(bs.f.stack())
    l = np.asarray(bs.l.stack())
    pdf = np.asarray(bs.pdf)

    for i in range(n):
        fo, lo, po = O.disney_sample(
            _mat_row(m, i),
            float(eta[i]),
            np.array([float(vv.x[i]), float(vv.y[i]), float(vv.z[i])]),
            np.array([float(nrm.x[i]), float(nrm.y[i]), float(nrm.z[i])]),
            np.array([float(prev_l.x[i]), float(prev_l.y[i]), float(prev_l.z[i])]),
            float(u[i, 0]), float(u[i, 1]), float(u[i, 2]),
        )
        np.testing.assert_allclose(f[i], fo, rtol=1e-9, atol=1e-12, err_msg=f"case {i}")
        np.testing.assert_allclose(l[i], lo, rtol=1e-9, atol=1e-12, err_msg=f"case {i}")
        np.testing.assert_allclose(pdf[i], po, rtol=1e-9, atol=1e-12, err_msg=f"case {i}")


def test_cosine_hemisphere_pdf_integrates_to_one(rng):
    # MC check: E[1/pdf] over cosine-weighted samples = hemisphere area
    # measure consistency; pdf = cos/pi (tracer.rs:364).
    n = 200_000
    r1 = jnp.asarray(rng.random(n))
    r2 = jnp.asarray(rng.random(n))
    d = S.cosine_sample_hemisphere(r1, r2)
    pdf = d.z / np.pi
    est = np.mean(1.0 / np.maximum(np.asarray(pdf), 1e-9))
    np.testing.assert_allclose(est, 2.0 * np.pi, rtol=0.02)


def test_dielectric_fresnel_limits():
    # normal incidence: ((1-eta)/(1+eta))^2 with eta = n1/n2 convention
    eta = 1.0 / 1.5
    f0 = ((1.0 - 1.5) / (1.0 + 1.5)) ** 2
    np.testing.assert_allclose(float(S.dielectric_fresnel(1.0, eta)), f0, rtol=1e-6)
    # TIR region returns exactly 1
    assert float(S.dielectric_fresnel(0.1, 1.5)) == 1.0


def test_power_heuristic_properties():
    assert float(S.power_heuristic(0.0, 0.0)) == 0.0  # guarded (oracle contract)
    assert float(S.power_heuristic(1.0, 0.0)) == 1.0
    a, b = 0.3, 1.7
    w1 = float(S.power_heuristic(a, b))
    w2 = float(S.power_heuristic(b, a))
    np.testing.assert_allclose(w1 + w2, 1.0, rtol=1e-12)


def test_vndf_half_vectors_upper_hemisphere(rng):
    n = 4096
    vv = _rand_units(rng, n)
    vv = vv._replace(z=jnp.abs(vv.z))  # viewer above surface
    h = S.sample_ggxvndf(vv, 0.3, 0.7, jnp.asarray(rng.random(n)), jnp.asarray(rng.random(n)))
    assert np.all(np.asarray(h.z) >= 0.0)
    np.testing.assert_allclose(np.asarray(h.length()), 1.0, rtol=1e-9)


def test_gtr1_log2_flag():
    # the verbatim log2 deviation vs the GLSL natural log (tracer.rs:239)
    a = 0.25
    ndoth = 0.9
    verbatim = float(S.gtr1(jnp.asarray(ndoth), a, use_log2=True))
    fixed = float(S.gtr1(jnp.asarray(ndoth), a, use_log2=False))
    assert verbatim != fixed
    np.testing.assert_allclose(verbatim, O.gtr1(ndoth, a, True), rtol=1e-12)
    np.testing.assert_allclose(fixed, O.gtr1(ndoth, a, False), rtol=1e-12)


def test_grazing_incidence_no_nan():
    """Regression: exactly-tangent hits (dot(n, v) == 0 after f32 rounding)
    drove 0/0 NaN through the lobe denominators 4*l.z*v.z / v.z (observed
    ~1 per 10^7 paths in float32). The physical limit is f = 0 (Smith G
    vanishes at grazing)."""
    f32 = jnp.float32
    n = v3(0.5915424, 0.58934027, 0.5502324, dtype=f32)
    rd = v3(0.5573823, 0.19419432, -0.8072258, dtype=f32)
    v = -rd
    assert float(n.dot(v)) == 0.0  # exactly grazing in f32

    for mat_kw in (
        dict(clearcoat=1.0, roughness=0.1, rgb=V3(*map(jnp.asarray, (1.0, 0.186, 0.0)))),
        dict(metallic=1.0, roughness=0.05),
        dict(spec_trans=1.0, roughness=0.2),
        dict(),
    ):
        m = finalize_material(default_material((), jnp.float32)._replace(**{
            k: (v_ if isinstance(v_, V3) else jnp.asarray(v_, jnp.float32))
            for k, v_ in mat_kw.items()
        }))
        eta = jnp.asarray(1.45, jnp.float32)
        for u in ((0.27, 0.37, 0.72), (0.99, 0.99, 0.01), (0.0, 0.0, 0.5)):
            bs = B.disney_sample(
                m, eta, v, n, v3(0.0, 0.0, 0.0),
                jnp.asarray(u, jnp.float32),
            )
            assert np.isfinite(np.asarray(bs.f.x)).all()
            assert np.isfinite(np.asarray(bs.pdf)).all()
            f, pdf = B.disney_eval(m, eta, v, n, bs.l)
            assert np.isfinite(np.asarray(f.x)).all()
            assert np.isfinite(np.asarray(pdf)).all()
