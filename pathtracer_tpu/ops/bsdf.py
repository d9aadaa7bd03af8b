"""Four-lobe Disney/principled BSDF: eval, sample, pdf — fully batched.

Replaces the reference's private Tracer BSDF methods
(rust-pathtracer/src/tracer.rs:335-626): diffuse (Burley retro-reflection +
fake subsurface + sheen), anisotropic GGX specular reflection (VNDF-sampled),
specular refraction, and clearcoat (GTR1), combined by luminance-weighted
lobe probabilities. The reference's early returns and branch-per-lobe
control flow become masked selects over the ray batch — every lane computes
all lobes and keeps its own (XLA fuses this into one elementwise chain; no
branch divergence).

Verbatim quirk ledger (see SURVEY.md §7 "hard parts"):
- disney_sample computes the reflect/refract Fresnel with the *previous*
  bounce's world-space scatter direction dotted against the local-frame half
  vector (tracer.rs:531: `dot(l, &h)` where `l` is the inout parameter still
  holding last bounce's value). `prev_l` reproduces this exactly.
- GTR1 uses log2 (see ops/sampling.py).

All math is dtype-polymorphic and division-guarded: dead/masked lanes yield
exact zeros, never NaN/inf, so jax.grad through live lanes stays clean.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.material import Material
from .sampling import (
    cosine_sample_hemisphere,
    dielectric_fresnel,
    gtr1,
    gtr2_aniso,
    power_heuristic,
    sample_ggxvndf,
    sample_gtr1,
    schlick_fresnel,
    smithg,
    smithg_aniso,
)
from .vecmath import (
    INV_PI,
    V3,
    dot,
    luminance,
    mix,
    mix_f,
    onb,
    reflect,
    refract,
    safe_normalize,
    safe_sqrt,
    splat3,
    to_local,
    to_world,
    where3,
    zeros3,
)


def _guard_div(a, b, mask):
    """a / b where mask AND b != 0, else 0 — with the denominator itself
    guarded so the primal AND cotangent of masked lanes are exactly zero.

    The b != 0 guard is load-bearing at exactly-grazing incidence
    (dot(n, v) == 0 after f32 rounding): the lobe denominators 4*l.z*v.z /
    v.z collapse to 0 together with their Smith-G numerators, and the
    resulting 0/0 NaN would leak through the lobe select into throughput
    (observed ~1 per 10^7 paths in float32). Returning 0 is the physical limit:
    G -> 0 at grazing, the lobe is unsampleable there."""
    m = mask & (b != 0.0)
    safe_b = jnp.where(m, b, 1.0)
    safe_a = jnp.where(m, a, 0.0)
    return jnp.where(m, safe_a / safe_b, 0.0)


def _mask3(mask, v: V3) -> V3:
    zero = jnp.zeros_like(v.x)
    return V3(
        jnp.where(mask, v.x, zero),
        jnp.where(mask, v.y, zero),
        jnp.where(mask, v.z, zero),
    )


def get_spec_color(mat: Material, eta) -> tuple[V3, V3]:
    """F0 specular / sheen tint colors (tracer.rs:335-341)."""
    lum = luminance(mat.rgb)
    white = splat3(jnp.ones_like(lum))
    ctint = where3(lum > 0.0, mat.rgb / splat3(jnp.where(lum > 0.0, lum, 1.0)), white)
    f0 = (1.0 - eta) / (1.0 + eta)
    spec_col = mix(
        (f0 * f0) * mix(white, ctint, mat.specular_tint), mat.rgb, mat.metallic
    )
    sheen_col = mix(white, ctint, mat.sheen_tint)
    return spec_col, sheen_col


def disney_fresnel(mat: Material, eta, ldoth, vdoth):
    """Metallic<->dielectric Fresnel blend (tracer.rs:435-439)."""
    metallic_f = schlick_fresnel(ldoth)
    dielectric_f = dielectric_fresnel(jnp.abs(vdoth), eta)
    return mix_f(dielectric_f, metallic_f, mat.metallic)


def get_lobe_probabilities(mat: Material, spec_col: V3, approx_fresnel):
    """Normalized luminance-weighted lobe probabilities
    (tracer.rs:421-433). Returns (diffuse, spec_reflect, spec_refract,
    clearcoat) weights."""
    white = splat3(jnp.ones_like(approx_fresnel))
    diffuse_wt = luminance(mat.rgb) * (1.0 - mat.metallic) * (1.0 - mat.spec_trans)
    spec_reflect_wt = luminance(mix(spec_col, white, approx_fresnel))
    spec_refract_wt = (
        (1.0 - approx_fresnel)
        * (1.0 - mat.metallic)
        * mat.spec_trans
        * luminance(mat.rgb)
    )
    clearcoat_wt = 0.25 * mat.clearcoat * (1.0 - mat.metallic)
    total = diffuse_wt + spec_reflect_wt + spec_refract_wt + clearcoat_wt
    ok = total > 0.0
    inv = _guard_div(jnp.ones_like(total), total, ok)
    return (
        diffuse_wt * inv,
        spec_reflect_wt * inv,
        spec_refract_wt * inv,
        clearcoat_wt * inv,
    )


def eval_diffuse(mat: Material, c_sheen: V3, v: V3, l: V3, h: V3):
    """Burley diffuse + fake subsurface + sheen; pdf = cos/pi
    (tracer.rs:343-366). Local frame (n = +z)."""
    active = l.z > 0.0

    ldoth = dot(l, h)
    fl = schlick_fresnel(l.z)
    fv = schlick_fresnel(v.z)
    fh = schlick_fresnel(ldoth)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat.roughness
    fd = mix_f(1.0, fd90, fl) * mix_f(1.0, fd90, fv)

    fss90 = ldoth * ldoth * mat.roughness
    fss = mix_f(1.0, fss90, fl) * mix_f(1.0, fss90, fv)
    inv_lzvz = _guard_div(jnp.ones_like(l.z), l.z + v.z, active)
    ss = 1.25 * (fss * (inv_lzvz - 0.5) + 0.5)

    fsheen = c_sheen * (fh * mat.sheen)

    pdf = jnp.where(active, l.z * INV_PI, 0.0)
    f = (
        mat.rgb * (INV_PI * mix_f(fd, ss, mat.subsurface))
        + fsheen
    ) * ((1.0 - mat.metallic) * (1.0 - mat.spec_trans))
    return _mask3(active, f), pdf


def eval_spec_reflection(mat: Material, eta, spec_col: V3, v: V3, l: V3, h: V3):
    """Anisotropic GGX reflection, VNDF pdf G1*D/(4 V.z)
    (tracer.rs:368-382)."""
    active = l.z > 0.0

    fm = disney_fresnel(mat, eta, dot(l, h), dot(v, h))
    white = splat3(jnp.ones_like(fm))
    f_col = mix(spec_col, white, fm)
    d = gtr2_aniso(h.z, h.x, h.y, mat.ax, mat.ay)
    g1 = smithg_aniso(jnp.abs(v.z), v.x, v.y, mat.ax, mat.ay)
    g2 = g1 * smithg_aniso(jnp.abs(l.z), l.x, l.y, mat.ax, mat.ay)

    pdf = _guard_div(g1 * d, 4.0 * v.z, active)
    scale = _guard_div(d * g2, 4.0 * l.z * v.z, active)
    return _mask3(active, f_col * scale), pdf


def eval_spec_refraction(mat: Material, eta, v: V3, l: V3, h: V3):
    """GGX refraction with change-of-measure Jacobian and eta^2
    (tracer.rs:384-402). Active only in the lower hemisphere (l.z < 0)."""
    active = l.z < 0.0

    vdoth = dot(v, h)
    ldoth = dot(l, h)
    f = dielectric_fresnel(jnp.abs(vdoth), eta)
    d = gtr2_aniso(h.z, h.x, h.y, mat.ax, mat.ay)
    g1 = smithg_aniso(jnp.abs(v.z), v.x, v.y, mat.ax, mat.ay)
    g2 = g1 * smithg_aniso(jnp.abs(l.z), l.x, l.y, mat.ax, mat.ay)
    denom = ldoth + vdoth * eta
    denom = denom * denom
    eta2 = eta * eta
    jacobian = _guard_div(jnp.abs(ldoth), denom, active)

    pdf = _guard_div(g1 * jnp.maximum(vdoth, 0.0) * d * jacobian, v.z, active)

    scale = (
        (1.0 - mat.metallic)
        * mat.spec_trans
        * (1.0 - f)
        * d
        * g2
        * jnp.abs(vdoth)
        * jacobian
        * eta2
    )
    scale = _guard_div(scale, jnp.abs(l.z * v.z), active)
    sqrt_rgb = V3(
        safe_sqrt(mat.rgb.x), safe_sqrt(mat.rgb.y), safe_sqrt(mat.rgb.z)
    )
    return _mask3(active, sqrt_rgb * scale), pdf


def eval_clearcoat(mat: Material, v: V3, l: V3, h: V3):
    """GTR1 clearcoat with fixed 0.25 Smith roughness
    (tracer.rs:404-419)."""
    active = l.z > 0.0

    vdoth = dot(v, h)
    fh = dielectric_fresnel(vdoth, 1.0 / 1.5)
    f_scalar = mix_f(0.04, 1.0, fh)
    d = gtr1(h.z, mat.clearcoat_roughness)
    g = smithg(l.z, 0.25) * smithg(v.z, 0.25)
    jacobian = _guard_div(jnp.ones_like(vdoth), 4.0 * vdoth, active)

    pdf = jnp.where(active, d * h.z * jacobian, 0.0)
    scale = _guard_div(mat.clearcoat * f_scalar * d * g, 4.0 * l.z * v.z, active)
    return _mask3(active, splat3(scale * 0.25)), pdf


class BsdfSample(NamedTuple):
    """ScatterSampleRec analog (globals.rs:89-104): sampled direction
    (world), weighted throughput f = |n.l| * bsdf, and pdf."""

    l: V3
    f: V3
    pdf: jnp.ndarray


def disney_sample(
    mat: Material, eta, v_world: V3, n_world: V3, prev_l_world: V3, u,
    detach: bool = False,
) -> BsdfSample:
    """Importance-sample the Disney BSDF (tracer.rs:441-553).

    v_world: -ray.direction; n_world: front-facing shading normal;
    prev_l_world: the previous bounce's sampled world direction (stale-l
    Fresnel quirk, see module docstring); u: three uniforms [*, 3]
    (r1, r2, reflect/refract coin).

    The reference's CDF branch becomes: sample all three candidate
    directions, evaluate each lobe on its own candidate, select by r1's CDF
    interval — identical math per lane, data-parallel across lanes.

    detach=True enables the detached-sampling gradient estimator (PSDR
    style): sampled half-vectors/directions and the pdf divisor are
    stop-gradiented, while the BSDF *value* keeps its parameter
    dependence. E[d(f)/p] = d(E[f/p]) since the score term integrates out,
    so parameter gradients stay unbiased without differentiating through
    the sampling map. Forward values are identical either way.

    `u` may be a [..., 3] array or a tuple of three arrays (the Pallas
    megakernel passes a tuple to avoid materializing a trailing-dim-3
    array inside the kernel).
    """
    if isinstance(u, (tuple, list)):
        r1, r2, u_coin = u
    else:
        r1, r2, u_coin = u[..., 0], u[..., 1], u[..., 2]
    sg = jax.lax.stop_gradient if detach else (lambda x: x)

    t, b = onb(n_world)
    v = to_local(t, b, n_world, v_world)

    spec_col, sheen_col = get_spec_color(mat, eta)

    approx_fresnel = disney_fresnel(mat, eta, v.z, v.z)
    diffuse_wt, spec_reflect_wt, spec_refract_wt, clearcoat_wt = (
        get_lobe_probabilities(mat, spec_col, approx_fresnel)
    )

    # Lobe CDF ordering [diffuse, +clearcoat, +spec_reflect, +spec_refract]
    # (tracer.rs:495-499).
    cdf0 = diffuse_wt
    cdf1 = cdf0 + clearcoat_wt
    sel_diffuse = r1 < cdf0
    sel_clear = (~sel_diffuse) & (r1 < cdf1)
    sel_spec = ~(sel_diffuse | sel_clear)

    # --- Diffuse lobe (tracer.rs:501-507) ---
    # The three re-conditioned uniforms are clipped to [0, 1]: on lanes that
    # selected a DIFFERENT lobe the raw value is out of range (e.g. r1 < cdf1
    # makes r1_s negative) and would drive sqrt/pow to NaN primals; those
    # NaNs survive the final lobe select through zero-cotangent products
    # (0 * NaN) in the backward pass and poison parameter gradients.
    r1_d = jnp.clip(_guard_div(r1, cdf0, cdf0 > 0.0), 0.0, 1.0)
    l_diff = sg(cosine_sample_hemisphere(r1_d, r2))
    h_diff = sg(safe_normalize(l_diff + v))
    f_diff, pdf_diff = eval_diffuse(mat, sheen_col, v, l_diff, h_diff)
    pdf_diff = pdf_diff * diffuse_wt

    # --- Clearcoat lobe (tracer.rs:509-520) ---
    span_c = cdf1 - cdf0
    r1_c = jnp.clip(_guard_div(r1 - cdf0, span_c, span_c > 0.0), 0.0, 1.0)
    h_cc = sample_gtr1(mat.clearcoat_roughness, r1_c, r2)
    h_cc = sg(where3(h_cc.z < 0.0, -h_cc, h_cc))
    l_cc = sg(safe_normalize(reflect(-v, h_cc)))
    f_cc, pdf_cc = eval_clearcoat(mat, v, l_cc, h_cc)
    pdf_cc = pdf_cc * clearcoat_wt

    # --- Specular reflection/refraction lobes (tracer.rs:521-549) ---
    span_s = 1.0 - cdf1
    r1_s = jnp.clip(_guard_div(r1 - cdf1, span_s, span_s > 0.0), 0.0, 1.0)
    h_s = sample_ggxvndf(v, mat.ax, mat.ay, r1_s, r2)
    h_s = sg(where3(h_s.z < 0.0, -h_s, h_s))

    # Stale-l Fresnel quirk (tracer.rs:531): world-space prev_l dotted with
    # the local-frame half vector, verbatim.
    fresnel = disney_fresnel(mat, eta, dot(prev_l_world, h_s), dot(v, h_s))
    ff = 1.0 - ((1.0 - fresnel) * mat.spec_trans * (1.0 - mat.metallic))
    take_reflect = u_coin < ff

    l_refl = sg(safe_normalize(reflect(-v, h_s)))
    f_refl, pdf_refl = eval_spec_reflection(mat, eta, spec_col, v, l_refl, h_s)
    pdf_refl = pdf_refl * ff

    l_refr = sg(safe_normalize(refract(-v, h_s, eta)))
    f_refr, pdf_refr = eval_spec_refraction(mat, eta, v, l_refr, h_s)
    pdf_refr = pdf_refr * (1.0 - ff)

    l_spec = where3(take_reflect, l_refl, l_refr)
    f_spec = where3(take_reflect, f_refl, f_refr)
    pdf_spec = jnp.where(take_reflect, pdf_refl, pdf_refr)
    pdf_spec = pdf_spec * (spec_reflect_wt + spec_refract_wt)

    # --- Select the sampled lobe per lane ---
    l_local = where3(sel_diffuse, l_diff, where3(sel_clear, l_cc, l_spec))
    f = where3(sel_diffuse, f_diff, where3(sel_clear, f_cc, f_spec))
    pdf = jnp.where(sel_diffuse, pdf_diff, jnp.where(sel_clear, pdf_cc, pdf_spec))

    l_world = to_world(t, b, n_world, l_local)
    f_out = f * jnp.abs(dot(n_world, l_world))
    return BsdfSample(l=l_world, f=f_out, pdf=sg(pdf))


def disney_eval(mat: Material, eta, v_world: V3, n_world: V3, l_world: V3):
    """Evaluate the full BSDF and its pdf for a given direction — the
    NEE-side counterpart (tracer.rs:555-626). Returns (f = |l.z|*bsdf, pdf).
    """
    t, b = onb(n_world)
    v = to_local(t, b, n_world, v_world)
    l = to_local(t, b, n_world, l_world)

    upper = l.z > 0.0
    h = where3(upper, safe_normalize(l + v), safe_normalize(l + v * eta))
    h = where3(h.z < 0.0, -h, h)

    spec_col, sheen_col = get_spec_color(mat, eta)

    fresnel = disney_fresnel(mat, eta, dot(l, h), dot(v, h))
    diffuse_wt, spec_reflect_wt, spec_refract_wt, clearcoat_wt = (
        get_lobe_probabilities(mat, spec_col, fresnel)
    )

    f = zeros3(jnp.shape(l.z), jnp.asarray(l.z).dtype)
    bsdf_pdf = jnp.zeros_like(l.z)

    # Diffuse (tracer.rs:602-605)
    g = (diffuse_wt > 0.0) & (l.z > 0.0)
    fd, pd = eval_diffuse(mat, sheen_col, v, l, h)
    f = f + _mask3(g, fd)
    bsdf_pdf = bsdf_pdf + jnp.where(g, pd * diffuse_wt, 0.0)

    # Specular reflection (tracer.rs:608-611)
    g = (spec_reflect_wt > 0.0) & (l.z > 0.0) & (v.z > 0.0)
    fr, pr = eval_spec_reflection(mat, eta, spec_col, v, l, h)
    f = f + _mask3(g, fr)
    bsdf_pdf = bsdf_pdf + jnp.where(g, pr * spec_reflect_wt, 0.0)

    # Specular refraction (tracer.rs:614-617)
    g = (spec_refract_wt > 0.0) & (l.z < 0.0)
    ft, pt = eval_spec_refraction(mat, eta, v, l, h)
    f = f + _mask3(g, ft)
    bsdf_pdf = bsdf_pdf + jnp.where(g, pt * spec_refract_wt, 0.0)

    # Clearcoat (tracer.rs:620-623)
    g = (clearcoat_wt > 0.0) & (l.z > 0.0) & (v.z > 0.0)
    fc, pc = eval_clearcoat(mat, v, l, h)
    f = f + _mask3(g, fc)
    bsdf_pdf = bsdf_pdf + jnp.where(g, pc * clearcoat_wt, 0.0)

    return f * jnp.abs(l.z), bsdf_pdf


__all__ = [
    "BsdfSample",
    "disney_eval",
    "disney_fresnel",
    "disney_sample",
    "eval_clearcoat",
    "eval_diffuse",
    "eval_spec_reflection",
    "eval_spec_refraction",
    "get_lobe_probabilities",
    "get_spec_color",
    "power_heuristic",
]
