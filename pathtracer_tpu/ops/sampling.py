"""Monte-Carlo sampling primitives and microfacet terms, batched.

Replaces the reference's private Tracer sampling helpers
(rust-pathtracer/src/tracer.rs:222-333). Every function is elementwise over
the ray batch, pure, and division-guarded so masked/dead
lanes never produce NaNs that would poison neighbours' gradients.

Quirk ledger (kept verbatim; see SURVEY.md §7):
- `gtr1` uses log2 where the GLSL original uses natural log
  (tracer.rs:239) — reproduced, flag-gated via `use_log2`.
"""

from __future__ import annotations

import jax.numpy as jnp

from .vecmath import INV_PI, PI, TWO_PI, V3, cross, dot, safe_normalize, safe_sqrt


def power_heuristic(a, b):
    """MIS power heuristic a^2/(a^2+b^2) (tracer.rs:223-226)."""
    t = a * a
    denom = b * b + t
    return jnp.where(denom > 0.0, t / jnp.where(denom > 0.0, denom, 1.0), 0.0)


def schlick_fresnel(u):
    """(1-u)^5 with clamp (tracer.rs:288-292)."""
    m = jnp.clip(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def dielectric_fresnel(cos_theta_i, eta):
    """Exact dielectric Fresnel with total internal reflection
    (tracer.rs:308-322)."""
    sin_theta_tsq = eta * eta * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_t = safe_sqrt(1.0 - sin_theta_tsq)
    denom_s = eta * cos_theta_t + cos_theta_i
    denom_p = eta * cos_theta_i + cos_theta_t
    rs = (eta * cos_theta_t - cos_theta_i) / jnp.where(denom_s != 0.0, denom_s, 1.0)
    rp = (eta * cos_theta_i - cos_theta_t) / jnp.where(denom_p != 0.0, denom_p, 1.0)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(sin_theta_tsq > 1.0, 1.0, f)


def gtr1(ndoth, a, use_log2: bool = True):
    """Clearcoat GTR1 NDF (tracer.rs:233-240).

    use_log2=True reproduces the reference's log2 port deviation verbatim
    (tracer.rs:239); False restores the GLSL original's natural log.
    """
    a = jnp.asarray(a)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    log_a2 = jnp.log2(a2) if use_log2 else jnp.log(a2)
    denom = PI * log_a2 * t
    val = (a2 - 1.0) / jnp.where(denom != 0.0, denom, 1.0)
    return jnp.where(a >= 1.0, INV_PI, val)


def sample_gtr1(rgh, r1, r2) -> V3:
    """GTR1 half-vector sampling (tracer.rs:242-254).

    Verbatim quirks: phi is driven by r1 (not r2), and r2 is unused —
    exactly as the reference (its `_r2` parameter).
    """
    del r2  # unused by the reference (tracer.rs:242 `_r2`)
    a = jnp.maximum(0.001, rgh)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_theta = safe_sqrt((1.0 - jnp.power(a2, 1.0 - r1)) / (1.0 - a2))
    sin_theta = jnp.clip(safe_sqrt(1.0 - cos_theta * cos_theta), 0.0, 1.0)
    return V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)


def sample_ggxvndf(v: V3, ax, ay, r1, r2) -> V3:
    """Visible-normal GGX sampling, Heitz 2018 (tracer.rs:256-274)."""
    vh = safe_normalize(V3(ax * v.x, ay * v.y, v.z))

    lensq = vh.x * vh.x + vh.y * vh.y
    inv_len = 1.0 / jnp.sqrt(jnp.where(lensq > 0.0, lensq, 1.0))
    t1v = V3(
        jnp.where(lensq > 0.0, -vh.y * inv_len, 1.0),
        jnp.where(lensq > 0.0, vh.x * inv_len, 0.0),
        jnp.zeros_like(vh.z),
    )
    t2v = cross(vh, t1v)

    r = jnp.sqrt(r1)
    phi = 2.0 * PI * r2
    t1 = r * jnp.cos(phi)
    t2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    t2 = (1.0 - s) * safe_sqrt(1.0 - t1 * t1) + s * t2

    nh = (
        t1v * t1
        + t2v * t2
        + vh * safe_sqrt(1.0 - t1 * t1 - t2 * t2)
    )
    return safe_normalize(V3(ax * nh.x, ay * nh.y, jnp.maximum(nh.z, 0.0)))


def smithg(ndotv, alphag):
    """Smith G1, isotropic (tracer.rs:276-280)."""
    a = alphag * alphag
    b = ndotv * ndotv
    denom = ndotv + safe_sqrt(a + b - a * b)
    return (2.0 * ndotv) / jnp.where(denom != 0.0, denom, 1.0)


def gtr2_aniso(ndoth, hdotx, hdoty, ax, ay):
    """Anisotropic GTR2/GGX NDF (tracer.rs:294-299)."""
    a = hdotx / ax
    b = hdoty / ay
    c = a * a + b * b + ndoth * ndoth
    denom = PI * ax * ay * c * c
    return 1.0 / jnp.where(denom != 0.0, denom, 1.0)


def smithg_aniso(ndotv, vdotx, vdoty, ax, ay):
    """Anisotropic Smith G1 (tracer.rs:301-306)."""
    a = vdotx * ax
    b = vdoty * ay
    c = ndotv
    denom = ndotv + safe_sqrt(a * a + b * b + c * c)
    return (2.0 * ndotv) / jnp.where(denom != 0.0, denom, 1.0)


def cosine_sample_hemisphere(r1, r2) -> V3:
    """Cosine-weighted hemisphere (tracer.rs:324-333)."""
    r = jnp.sqrt(r1)
    phi = TWO_PI * r2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = safe_sqrt(1.0 - x * x - y * y)
    return V3(x, y, z)


def uniform_sample_hemisphere(r1, r2) -> V3:
    """Uniform hemisphere about +z (tracer.rs:178-182, inside sample_light).

    Verbatim: r = sqrt(max(0, 1 - r1^2)), z = r1 — i.e. r1 IS cos(theta).
    """
    r = safe_sqrt(1.0 - r1 * r1)
    phi = TWO_PI * r2
    return V3(r * jnp.cos(phi), r * jnp.sin(phi), r1)


def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase function p(cosθ; g) — the volumetric
    scattering kernel for MediumType::Scatter (the reference declares the
    enum, material.rs:8-13, but never integrates media; semantics follow
    the GLSL family the reference ports). Normalized over the sphere:
    ∫ p dΩ = 1, so it is its own pdf under hg sampling.

    Convention: cosθ = dot(d_in, d_out) between the propagation direction
    and the scattered direction — g > 0 is forward scattering."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta  # >= (1-|g|)^2 > 0 for |g| < 1
    return INV_PI * 0.25 * (1.0 - g2) / (denom * safe_sqrt(denom))


def sample_hg(d: V3, g, r1, r2) -> V3:
    """Importance-sample the HG phase about the propagation direction `d`
    (unit). Exactly inverts hg_phase's CDF, so pdf == hg_phase(cosθ; g).
    The |g| ~ 0 limit falls back to uniform-sphere cosθ = 1 - 2 r2."""
    iso = jnp.abs(g) < 1e-3
    g_safe = jnp.where(iso, 0.5, g)  # guarded; iso lanes ignore it
    sqr = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * r2)
    cos_aniso = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_theta = jnp.where(iso, 1.0 - 2.0 * r2, cos_aniso)
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * r1
    # local sample about +z, rotated onto d
    local = V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)
    from .vecmath import onb, to_world

    t, b = onb(d)
    return to_world(t, b, d, local)
