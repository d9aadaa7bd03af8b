"""Scalar float64 NumPy oracle: the reference integrator, verbatim.

The reference repo ships zero tests (SURVEY.md §4); this oracle plays the
role its missing test layer should have: a deliberately slow, scalar,
sequential re-derivation of the exact math in rust-pathtracer/src/tracer.rs
(+ scene.rs, analytical.rs, pinhole.rs, globals.rs, material.rs), with the
reference's per-pixel control flow (real `break`s, branch-per-lobe) instead
of the batched path's masked lanes. The JAX integrator must match it allclose
— exactly (rtol ~1e-12) when the JAX path runs float64 on CPU, and
statistically when running float32.

RNG contract: ThreadRng (tracer.rs:44) is non-reproducible, so randomness is
an *input*: the oracle consumes the same (cam_uniforms [N,2],
bounce_uniforms [D,N,6]) arrays that `draw_uniforms` feeds the JAX path.
Uniform slot layout per bounce: [light pick, light r1, light r2, bsdf r1,
bsdf r2, reflect/refract coin].

Guard contract: the reference lets degenerate denominators produce NaN and
relies on `pdf > 0.0` being false for NaN to kill the path (tracer.rs:93).
The JAX path must guard those divisions (masked lanes / gradient safety),
which can only differ from the reference in measure-zero configurations;
the oracle applies the SAME guards so "allclose vs oracle" is well-defined.
Each guard is commented at its site.
"""

from __future__ import annotations

import math

import numpy as np

PI = math.pi
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
EPS = 0.005  # tracer.rs:16


# ---------------------------------------------------------------------------
# Scalar vec3 helpers (fx.rs / math.rs) — plain numpy arrays of shape (3,)
# ---------------------------------------------------------------------------

def v(x, y, z):
    return np.array([x, y, z], np.float64)


def dot(a, b):
    return float(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross(a, b):
    return v(
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(a):
    return math.sqrt(dot(a, a))


def normalize(a):
    l2 = dot(a, a)
    if l2 <= 0.0:  # guard contract: safe_normalize in ops/vecmath.py
        return v(0.0, 0.0, 0.0)
    return a / math.sqrt(l2)


def mixv(a, b, t):
    return a * (1.0 - t) + b * t


def mixf(a, b, t):
    return (1.0 - t) * a + b * t


def reflect(i, n):
    return i - 2.0 * n * dot(n, i)


def refract(i, n, eta):
    """tracer.rs:468-475: zeros on TIR."""
    ndoti = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    if k < 0.0:
        return v(0.0, 0.0, 0.0)
    return eta * i - (eta * ndoti + math.sqrt(k)) * n


def onb(n):
    """tracer.rs:449-454."""
    up = v(0.0, 0.0, 1.0) if abs(n[2]) < 0.999 else v(1.0, 0.0, 0.0)
    t = normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def to_local(t, b, n, w):
    return v(dot(w, t), dot(w, b), dot(w, n))


def to_world(t, b, n, w):
    return t * w[0] + b * w[1] + n * w[2]


def luminance(c):
    return 0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2]


# ---------------------------------------------------------------------------
# Material (material.rs) — plain dict records
# ---------------------------------------------------------------------------

def material_new():
    """Material::new (material.rs:82-114)."""
    return dict(
        rgb=v(1.5, 1.5, 1.5),
        emission=v(0.0, 0.0, 0.0),
        anisotropic=0.0,
        metallic=0.0,
        roughness=0.5,
        subsurface=0.0,
        specular_tint=0.0,
        sheen=0.0,
        sheen_tint=0.0,
        clearcoat=0.0,
        clearcoat_gloss=0.0,
        clearcoat_roughness=0.0,
        spec_trans=0.0,
        ior=1.45,
        opacity=1.0,
        alpha_mode=0,  # AlphaMode::Opaque (material.rs:38-44)
        alpha_cutoff=0.0,
        # Medium::new (material.rs:26-33)
        medium_type=0,
        medium_density=0.0,
        medium_color=v(0.0, 0.0, 0.0),
        medium_anisotropy=0.0,
        ax=0.0,
        ay=0.0,
    )


def material_finalize(m):
    """material.rs:117-131."""
    m["roughness"] = max(m["roughness"], 0.01)
    m["medium_anisotropy"] = min(max(m["medium_anisotropy"], -0.9), 0.9)
    m["clearcoat_roughness"] = mixf(0.1, 0.001, m["clearcoat_gloss"])
    aspect = math.sqrt(1.0 - m["anisotropic"] * 0.9)
    m["ax"] = max(m["roughness"] / aspect, 0.001)
    m["ay"] = max(m["roughness"] * aspect, 0.001)


# ---------------------------------------------------------------------------
# Sampling primitives (tracer.rs:222-333)
# ---------------------------------------------------------------------------

def power_heuristic(a, b):
    t = a * a
    denom = b * b + t
    if denom <= 0.0:  # guard contract
        return 0.0
    return t / denom


def schlick_fresnel(u):
    m = min(max(1.0 - u, 0.0), 1.0)
    m2 = m * m
    return m2 * m2 * m


def dielectric_fresnel(cos_theta_i, eta):
    sin_theta_tsq = eta * eta * (1.0 - cos_theta_i * cos_theta_i)
    if sin_theta_tsq > 1.0:
        return 1.0
    cos_theta_t = math.sqrt(max(1.0 - sin_theta_tsq, 0.0))
    rs = (eta * cos_theta_t - cos_theta_i) / (eta * cos_theta_t + cos_theta_i)
    rp = (eta * cos_theta_i - cos_theta_t) / (eta * cos_theta_i + cos_theta_t)
    return 0.5 * (rs * rs + rp * rp)


def gtr1(ndoth, a, use_log2=True):
    """tracer.rs:233-240 (log2 port deviation kept, flag-gated)."""
    if a >= 1.0:
        return INV_PI
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    log_a2 = math.log2(a2) if use_log2 else math.log(a2)
    return (a2 - 1.0) / (PI * log_a2 * t)


def sample_gtr1(rgh, r1, _r2):
    """tracer.rs:242-254 (phi from r1; r2 unused — verbatim)."""
    a = max(0.001, rgh)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_theta = math.sqrt(max((1.0 - a2 ** (1.0 - r1)) / (1.0 - a2), 0.0))
    sin_theta = min(max(math.sqrt(max(1.0 - cos_theta * cos_theta, 0.0)), 0.0), 1.0)
    return v(sin_theta * math.cos(phi), sin_theta * math.sin(phi), cos_theta)


def sample_ggxvndf(w, ax, ay, r1, r2):
    """tracer.rs:256-274."""
    vh = normalize(v(ax * w[0], ay * w[1], w[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    if lensq > 0.0:
        t1v = v(-vh[1], vh[0], 0.0) * (1.0 / math.sqrt(lensq))
    else:
        t1v = v(1.0, 0.0, 0.0)
    t2v = cross(vh, t1v)
    r = math.sqrt(r1)
    phi = 2.0 * PI * r2
    t1 = r * math.cos(phi)
    t2 = r * math.sin(phi)
    s = 0.5 * (1.0 + vh[2])
    t2 = (1.0 - s) * math.sqrt(max(1.0 - t1 * t1, 0.0)) + s * t2
    nh = t1 * t1v + t2 * t2v + math.sqrt(max(1.0 - t1 * t1 - t2 * t2, 0.0)) * vh
    return normalize(v(ax * nh[0], ay * nh[1], max(nh[2], 0.0)))


def smithg(ndotv, alphag):
    a = alphag * alphag
    b = ndotv * ndotv
    return (2.0 * ndotv) / (ndotv + math.sqrt(max(a + b - a * b, 0.0)))


def gtr2_aniso(ndoth, hdotx, hdoty, ax, ay):
    a = hdotx / ax
    b = hdoty / ay
    c = a * a + b * b + ndoth * ndoth
    return 1.0 / (PI * ax * ay * c * c)


def smithg_aniso(ndotv, vdotx, vdoty, ax, ay):
    a = vdotx * ax
    b = vdoty * ay
    c = ndotv
    return (2.0 * ndotv) / (ndotv + math.sqrt(a * a + b * b + c * c))


def cosine_sample_hemisphere(r1, r2):
    r = math.sqrt(r1)
    phi = TWO_PI * r2
    x = r * math.cos(phi)
    y = r * math.sin(phi)
    z = math.sqrt(max(1.0 - x * x - y * y, 0.0))
    return v(x, y, z)


def uniform_sample_hemisphere(r1, r2):
    """tracer.rs:178-182: z = r1."""
    r = math.sqrt(max(1.0 - r1 * r1, 0.0))
    phi = TWO_PI * r2
    return v(r * math.cos(phi), r * math.sin(phi), r1)


# ---------------------------------------------------------------------------
# Disney BSDF (tracer.rs:335-626)
# ---------------------------------------------------------------------------

def get_spec_color(mat, eta):
    lum = luminance(mat["rgb"])
    ctint = mat["rgb"] / lum if lum > 0.0 else v(1.0, 1.0, 1.0)
    f0 = (1.0 - eta) / (1.0 + eta)
    spec_col = mixv(
        f0 * f0 * mixv(v(1.0, 1.0, 1.0), ctint, mat["specular_tint"]),
        mat["rgb"],
        mat["metallic"],
    )
    sheen_col = mixv(v(1.0, 1.0, 1.0), ctint, mat["sheen_tint"])
    return spec_col, sheen_col


def disney_fresnel(mat, eta, ldoth, vdoth):
    metallic_f = schlick_fresnel(ldoth)
    dielectric_f = dielectric_fresnel(abs(vdoth), eta)
    return mixf(dielectric_f, metallic_f, mat["metallic"])


def get_lobe_probabilities(mat, spec_col, approx_fresnel):
    diffuse_wt = luminance(mat["rgb"]) * (1.0 - mat["metallic"]) * (
        1.0 - mat["spec_trans"]
    )
    spec_reflect_wt = luminance(mixv(spec_col, v(1.0, 1.0, 1.0), approx_fresnel))
    spec_refract_wt = (
        (1.0 - approx_fresnel)
        * (1.0 - mat["metallic"])
        * mat["spec_trans"]
        * luminance(mat["rgb"])
    )
    clearcoat_wt = 0.25 * mat["clearcoat"] * (1.0 - mat["metallic"])
    total = diffuse_wt + spec_reflect_wt + spec_refract_wt + clearcoat_wt
    if total <= 0.0:  # guard contract
        return 0.0, 0.0, 0.0, 0.0
    return (
        diffuse_wt / total,
        spec_reflect_wt / total,
        spec_refract_wt / total,
        clearcoat_wt / total,
    )


def eval_diffuse(mat, c_sheen, w_v, w_l, h):
    """tracer.rs:343-366."""
    if w_l[2] <= 0.0:
        return v(0.0, 0.0, 0.0), 0.0
    ldoth = dot(w_l, h)
    fl = schlick_fresnel(w_l[2])
    fv = schlick_fresnel(w_v[2])
    fh = schlick_fresnel(ldoth)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat["roughness"]
    fd = mixf(1.0, fd90, fl) * mixf(1.0, fd90, fv)
    fss90 = ldoth * ldoth * mat["roughness"]
    fss = mixf(1.0, fss90, fl) * mixf(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / (w_l[2] + w_v[2]) - 0.5) + 0.5)
    fsheen = fh * mat["sheen"] * c_sheen
    pdf = w_l[2] * INV_PI
    f = (1.0 - mat["metallic"]) * (1.0 - mat["spec_trans"]) * (
        INV_PI * mixf(fd, ss, mat["subsurface"]) * mat["rgb"] + fsheen
    )
    return f, pdf


def eval_spec_reflection(mat, eta, spec_col, w_v, w_l, h):
    """tracer.rs:368-382."""
    if w_l[2] <= 0.0:
        return v(0.0, 0.0, 0.0), 0.0
    fm = disney_fresnel(mat, eta, dot(w_l, h), dot(w_v, h))
    f_col = mixv(spec_col, v(1.0, 1.0, 1.0), fm)
    d = gtr2_aniso(h[2], h[0], h[1], mat["ax"], mat["ay"])
    g1 = smithg_aniso(abs(w_v[2]), w_v[0], w_v[1], mat["ax"], mat["ay"])
    g2 = g1 * smithg_aniso(abs(w_l[2]), w_l[0], w_l[1], mat["ax"], mat["ay"])
    pdf = g1 * d / (4.0 * w_v[2])
    f = d * g2 * f_col / (4.0 * w_l[2] * w_v[2])
    return f, pdf


def eval_spec_refraction(mat, eta, w_v, w_l, h):
    """tracer.rs:384-402."""
    if w_l[2] >= 0.0:
        return v(0.0, 0.0, 0.0), 0.0
    vdoth = dot(w_v, h)
    ldoth = dot(w_l, h)
    f = dielectric_fresnel(abs(vdoth), eta)
    d = gtr2_aniso(h[2], h[0], h[1], mat["ax"], mat["ay"])
    g1 = smithg_aniso(abs(w_v[2]), w_v[0], w_v[1], mat["ax"], mat["ay"])
    g2 = g1 * smithg_aniso(abs(w_l[2]), w_l[0], w_l[1], mat["ax"], mat["ay"])
    denom = ldoth + vdoth * eta
    denom = denom * denom
    eta2 = eta * eta
    jacobian = abs(ldoth) / denom
    pdf = g1 * max(vdoth, 0.0) * d * jacobian / w_v[2]
    val = (
        (1.0 - mat["metallic"])
        * mat["spec_trans"]
        * (1.0 - f)
        * d
        * g2
        * abs(vdoth)
        * jacobian
        * eta2
        / abs(w_l[2] * w_v[2])
        * np.sqrt(np.maximum(mat["rgb"], 0.0))
    )
    return val, pdf


def eval_clearcoat(mat, w_v, w_l, h, use_log2=True):
    """tracer.rs:404-419."""
    if w_l[2] <= 0.0:
        return v(0.0, 0.0, 0.0), 0.0
    vdoth = dot(w_v, h)
    fh = dielectric_fresnel(vdoth, 1.0 / 1.5)
    fsc = mixf(0.04, 1.0, fh)
    d = gtr1(h[2], mat["clearcoat_roughness"], use_log2)
    g = smithg(w_l[2], 0.25) * smithg(w_v[2], 0.25)
    jacobian = 1.0 / (4.0 * vdoth)
    pdf = d * h[2] * jacobian
    f = mat["clearcoat"] * fsc * d * g / (4.0 * w_l[2] * w_v[2]) * v(0.25, 0.25, 0.25)
    return f, pdf


def disney_sample(mat, eta, v_world, n, prev_l_world, r1, r2, u_coin, use_log2=True):
    """tracer.rs:441-553. Returns (f=|n.l|*bsdf, l_world, pdf)."""
    t, b = onb(n)
    w_v = to_local(t, b, n, v_world)

    spec_col, sheen_col = get_spec_color(mat, eta)
    approx_fresnel = disney_fresnel(mat, eta, w_v[2], w_v[2])
    diffuse_wt, spec_reflect_wt, spec_refract_wt, clearcoat_wt = (
        get_lobe_probabilities(mat, spec_col, approx_fresnel)
    )

    cdf0 = diffuse_wt
    cdf1 = cdf0 + clearcoat_wt

    if r1 < cdf0:  # Diffuse
        r1 = r1 / cdf0 if cdf0 > 0.0 else 0.0  # guard contract
        w_l = cosine_sample_hemisphere(r1, r2)
        h = normalize(w_l + w_v)
        f, pdf = eval_diffuse(mat, sheen_col, w_v, w_l, h)
        pdf *= diffuse_wt
    elif r1 < cdf1:  # Clearcoat
        span = cdf1 - cdf0
        r1 = (r1 - cdf0) / span if span > 0.0 else 0.0  # guard contract
        h = sample_gtr1(mat["clearcoat_roughness"], r1, r2)
        if h[2] < 0.0:
            h = -h
        w_l = normalize(reflect(-w_v, h))
        f, pdf = eval_clearcoat(mat, w_v, w_l, h, use_log2)
        pdf *= clearcoat_wt
    else:  # Specular reflection / refraction
        span = 1.0 - cdf1
        r1 = (r1 - cdf1) / span if span > 0.0 else 0.0  # guard contract
        h = sample_ggxvndf(w_v, mat["ax"], mat["ay"], r1, r2)
        if h[2] < 0.0:
            h = -h
        # Stale-l quirk (tracer.rs:531): previous bounce's WORLD direction
        # dotted with the LOCAL half vector, verbatim.
        fresnel = disney_fresnel(mat, eta, dot(prev_l_world, h), dot(w_v, h))
        ff = 1.0 - ((1.0 - fresnel) * mat["spec_trans"] * (1.0 - mat["metallic"]))
        if u_coin < ff:
            w_l = normalize(reflect(-w_v, h))
            f, pdf = eval_spec_reflection(mat, eta, spec_col, w_v, w_l, h)
            pdf *= ff
        else:
            w_l = normalize(refract(-w_v, h, eta))
            f, pdf = eval_spec_refraction(mat, eta, w_v, w_l, h)
            pdf *= 1.0 - ff
        pdf *= spec_reflect_wt + spec_refract_wt

    l_world = to_world(t, b, n, w_l)
    return abs(dot(n, l_world)) * f, l_world, pdf


def disney_eval(mat, eta, v_world, n, l_world, use_log2=True):
    """tracer.rs:555-626. Returns (f=|l.z|*bsdf, pdf)."""
    t, b = onb(n)
    w_v = to_local(t, b, n, v_world)
    w_l = to_local(t, b, n, l_world)

    if w_l[2] > 0.0:
        h = normalize(w_l + w_v)
    else:
        h = normalize(w_l + eta * w_v)
    if h[2] < 0.0:
        h = -h

    spec_col, sheen_col = get_spec_color(mat, eta)
    fresnel = disney_fresnel(mat, eta, dot(w_l, h), dot(w_v, h))
    diffuse_wt, spec_reflect_wt, spec_refract_wt, clearcoat_wt = (
        get_lobe_probabilities(mat, spec_col, fresnel)
    )

    f = v(0.0, 0.0, 0.0)
    bsdf_pdf = 0.0

    if diffuse_wt > 0.0 and w_l[2] > 0.0:
        fd, pdf = eval_diffuse(mat, sheen_col, w_v, w_l, h)
        f = f + fd
        bsdf_pdf += pdf * diffuse_wt

    if spec_reflect_wt > 0.0 and w_l[2] > 0.0 and w_v[2] > 0.0:
        fr, pdf = eval_spec_reflection(mat, eta, spec_col, w_v, w_l, h)
        f = f + fr
        bsdf_pdf += pdf * spec_reflect_wt

    if spec_refract_wt > 0.0 and w_l[2] < 0.0:
        ft, pdf = eval_spec_refraction(mat, eta, w_v, w_l, h)
        f = f + ft
        bsdf_pdf += pdf * spec_refract_wt

    if clearcoat_wt > 0.0 and w_l[2] > 0.0 and w_v[2] > 0.0:
        fc, pdf = eval_clearcoat(mat, w_v, w_l, h, use_log2)
        f = f + fc
        bsdf_pdf += pdf * clearcoat_wt

    return abs(w_l[2]) * f, bsdf_pdf


# ---------------------------------------------------------------------------
# Scene: analytical demo, scalar (analytical.rs + scene.rs defaults)
# ---------------------------------------------------------------------------

def ray_sphere(ro, rd, center, radius):
    """analytical.rs:166-190. Returns t or None."""
    l = center - ro
    tca = dot(l, rd)
    d2 = dot(l, l) - tca * tca
    radius2 = radius * radius
    if d2 > radius2:
        return None
    thc = math.sqrt(radius2 - d2)
    t0 = tca - thc
    t1 = tca + thc
    if t0 > t1:
        t0, t1 = t1, t0
    if t0 < 0.0:
        t0 = t1
        if t0 < 0.0:
            return None
    return t0


def ray_rect(ro, rd, corner, u, v_edge):
    """Ray vs rectangle (GLSL RectIntersect; scalar mirror of
    ops/intersect.ray_rect)."""
    n = cross(u, v_edge)
    denom = dot(n, rd)
    if abs(denom) <= 1e-8:
        return None
    t = dot(corner - ro, n) / denom
    if t < 0.0:
        return None
    rel = (ro + rd * t) - corner
    uu, vv = dot(u, u), dot(v_edge, v_edge)
    a = dot(rel, u) / (uu if uu > 0.0 else 1.0)
    b = dot(rel, v_edge) / (vv if vv > 0.0 else 1.0)
    if 0.0 <= a <= 1.0 and 0.0 <= b <= 1.0:
        return t
    return None


def ray_plane(ro, rd, normal_, point):
    """analytical.rs:193-204."""
    denom = dot(normal_, rd)
    if abs(denom) > 0.0001:
        t = dot(point - ro, normal_) / denom
        if t >= 0.0:
            return t
    return None


class OracleScene:
    """Scalar mirror of models/analytical.py driven by the same parameter
    pytree (pass pathtracer_tpu.analytical_default_params() leaves as plain
    numpy). One spherical light (analytical.rs:15-16)."""

    def __init__(self, params, lights, camera, recursion_depth=4):
        g = lambda a: np.asarray(a, np.float64)
        self.sphere_center = [
            v(g(params.sphere_center.x)[i], g(params.sphere_center.y)[i],
              g(params.sphere_center.z)[i])
            for i in range(2)
        ]
        self.sphere_radius = [float(g(params.sphere_radius)[i]) for i in range(2)]
        self.plane_point = v(*[float(g(getattr(params.plane_point, c))) for c in "xyz"])
        self.plane_normal = v(*[float(g(getattr(params.plane_normal, c))) for c in "xyz"])
        self.checker_scale = float(g(params.checker_scale))
        self.checker_offset = float(g(params.checker_offset))
        self.checker_albedo = [float(g(params.checker_albedo)[i]) for i in range(2)]
        self.sky_horizon = v(*[float(g(getattr(params.sky_horizon, c))) for c in "xyz"])
        self.sky_zenith = v(*[float(g(getattr(params.sky_zenith, c))) for c in "xyz"])
        self.sky_scale = float(g(params.sky_scale))
        self.materials = params.materials  # Material pytree [3]
        self.recursion_depth = recursion_depth

        self.lights = []
        for i in range(int(np.asarray(lights.radius).shape[0])):
            self.lights.append(
                dict(
                    light_type=int(np.asarray(lights.light_type)[i]),
                    position=v(g(lights.position.x)[i], g(lights.position.y)[i],
                               g(lights.position.z)[i]),
                    emission=v(g(lights.emission.x)[i], g(lights.emission.y)[i],
                               g(lights.emission.z)[i]),
                    u=v(g(lights.u.x)[i], g(lights.u.y)[i], g(lights.u.z)[i]),
                    v=v(g(lights.v.x)[i], g(lights.v.y)[i], g(lights.v.z)[i]),
                    radius=float(g(lights.radius)[i]),
                    area=float(g(lights.area)[i]),
                )
            )

        self.cam_origin = v(*[float(g(getattr(camera.origin, c))) for c in "xyz"])
        self.cam_center = v(*[float(g(getattr(camera.center, c))) for c in "xyz"])
        self.cam_fov = float(g(camera.fov))

    def _table_material(self, idx):
        m = material_new()
        t = self.materials
        g = lambda a: np.asarray(a, np.float64)
        m["rgb"] = v(g(t.rgb.x)[idx], g(t.rgb.y)[idx], g(t.rgb.z)[idx])
        m["emission"] = v(
            g(t.emission.x)[idx], g(t.emission.y)[idx], g(t.emission.z)[idx]
        )
        for k in (
            "anisotropic", "metallic", "roughness", "subsurface", "specular_tint",
            "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss", "spec_trans",
            "ior", "opacity", "alpha_cutoff",
        ):
            m[k] = float(g(getattr(t, k))[idx])
        m["alpha_mode"] = int(np.asarray(t.alpha_mode)[idx])
        m["medium_type"] = int(np.asarray(t.medium.medium_type)[idx])
        m["medium_density"] = float(g(t.medium.density)[idx])
        m["medium_color"] = v(
            g(t.medium.color.x)[idx],
            g(t.medium.color.y)[idx],
            g(t.medium.color.z)[idx],
        )
        m["medium_anisotropy"] = float(g(t.medium.anisotropy)[idx])
        return m

    def background(self, rd):
        """analytical.rs:28-32."""
        t = 0.5 * (rd[1] + 1.0)
        c = mixv(self.sky_horizon, self.sky_zenith, t)
        return np.power(c, 2.2) * self.sky_scale

    def closest_hit(self, ro, rd, state):
        """analytical.rs:36-127 (sequential, strict-< winner)."""
        dist = np.inf
        hit = False

        d = ray_sphere(ro, rd, self.sphere_center[0], self.sphere_radius[0])
        if d is not None:
            hp = ro + rd * d
            state["hit_dist"] = d
            state["normal"] = normalize(hp - self.sphere_center[0])
            state["material"] = self._table_material(0)
            hit = True
            dist = d

        d = ray_sphere(ro, rd, self.sphere_center[1], self.sphere_radius[1])
        if d is not None and d < dist:
            hp = ro + rd * d
            state["hit_dist"] = d
            state["normal"] = normalize(hp - self.sphere_center[1])
            state["material"] = self._table_material(1)
            hit = True
            dist = d

        d = ray_plane(ro, rd, self.plane_normal, self.plane_point)
        if d is not None and d < dist:
            state["hit_dist"] = d
            state["normal"] = self.plane_normal.copy()
            mat = self._table_material(2)
            safe_dy = rd[1] if rd[1] != 0.0 else 1.0  # guard contract
            cx = rd[0] / safe_dy * self.checker_scale + self.checker_offset
            cy = rd[2] / safe_dy * self.checker_scale + self.checker_offset
            x1 = math.fmod(math.floor(cx), 2.0)
            y1 = math.fmod(math.floor(cy), 2.0)
            c = (
                self.checker_albedo[0]
                if math.fmod(x1 + y1, 2.0) < 1.0
                else self.checker_albedo[1]
            )
            mat["rgb"] = v(c, c, c)
            state["material"] = mat
            hit = True

        # Scene::sample_lights default method (scene.rs:36-86): emitter pass
        # gated by the CURRENT state.hit_dist (stale across bounces).
        # Spherical verbatim; Rectangular per the GLSL original
        # (pdf d^2/(area*cos), no 0.5); Distant never hittable.
        ldist = state["hit_dist"]
        for light in self.lights:
            lt = light.get("light_type", 1)
            if lt == 1:  # spherical
                d = ray_sphere(ro, rd, light["position"], light["radius"])
                half = 0.5
                normal_fn = lambda hp, light=light: normalize(hp - light["position"])
            elif lt == 0:  # rectangular
                d = ray_rect(ro, rd, light["position"], light["u"], light["v"])
                half = 1.0
                normal_fn = lambda hp, light=light: normalize(
                    cross(light["u"], light["v"])
                )
            else:  # distant
                d = None
            if d is not None and d < ldist:
                ldist = d
                hit_point = ro + rd * d
                cos_theta = dot(-rd, normal_fn(hit_point))
                denom = light["area"] * cos_theta * half
                state["light_pdf"] = (d * d) / (denom if denom != 0.0 else 1.0)  # guard contract
                state["light_emission"] = light["emission"].copy()
                state["is_emitter"] = True
                state["hit_dist"] = d
                hit = True

        return hit

    def any_hit(self, ro, rd, max_dist, respect_max_dist=False):
        """analytical.rs:130-145 (quirk: ignores max_dist by default)."""
        hits = []
        for i in range(2):
            d = ray_sphere(ro, rd, self.sphere_center[i], self.sphere_radius[i])
            if d is not None:
                hits.append(d)
        d = ray_plane(ro, rd, self.plane_normal, self.plane_point)
        if d is not None:
            hits.append(d)
        if respect_max_dist:
            return any(h < max_dist for h in hits)
        return len(hits) > 0

    def gen_ray(self, px, py, ox, oy, width, height):
        """pinhole.rs:38-61 + the tracer's coord map (tracer.rs:36-46)."""
        ratio = width / height
        psx, psy = 1.0 / width, 1.0 / height
        half_width = math.tan(math.radians(self.cam_fov) * 0.5)
        half_height = half_width / ratio
        up = v(0.0, 1.0, 0.0)
        w = normalize(self.cam_origin - self.cam_center)
        u = cross(up, w)
        vv = cross(w, u)
        lower_left = (
            self.cam_origin - u * half_width - vv * half_height - w
        )
        horizontal = u * (half_width * 2.0)
        vertical = vv * (half_height * 2.0)
        rd = (
            (lower_left - self.cam_origin)
            + horizontal * (psx * ox + px)
            + vertical * (psy * oy + py)
        )
        return self.cam_origin.copy(), normalize(rd)


# ---------------------------------------------------------------------------
# Integrator (tracer.rs:22-220), sequential
# ---------------------------------------------------------------------------

def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase (scalar mirror of ops.sampling.hg_phase)."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    denom = max(denom, 1e-30)
    return 0.25 / math.pi * (1.0 - g2) / (denom * math.sqrt(denom))


def sample_hg(d, g, r1, r2):
    """HG importance sampling about `d` (ops.sampling.sample_hg mirror)."""
    if abs(g) < 1e-3:
        cos_theta = 1.0 - 2.0 * r2
    else:
        sqr = (1.0 - g * g) / (1.0 + g - 2.0 * g * r2)
        cos_theta = (1.0 + g * g - sqr * sqr) / (2.0 * g)
    cos_theta = min(max(cos_theta, -1.0), 1.0)
    sin_theta = math.sqrt(max(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * math.pi * r1
    t, b = onb(d)
    local = v(sin_theta * math.cos(phi), sin_theta * math.sin(phi), cos_theta)
    return local[0] * t + local[1] * b + local[2] * d


def scatter_direct_light(scene, rd, scatter_pos, g_aniso, u_pick, r1, r2,
                         respect_max_dist=False):
    """NEE from a volumetric scatter point: HG phase replaces the BSDF
    (scalar mirror of integrator.tracer._scatter_direct_light)."""
    ld = v(0.0, 0.0, 0.0)
    n_lights = len(scene.lights)
    if n_lights == 0:
        return ld

    index = min(int(u_pick * n_lights), n_lights - 1)
    light = scene.lights[index]
    lt = light.get("light_type", 1)

    if lt == 1:
        center_to_surf = scatter_pos - light["position"]
        dist_to_center = length(center_to_surf)
        sampled = uniform_sample_hemisphere(r1, r2)
        axis = center_to_surf / (dist_to_center if dist_to_center > 0.0 else 1.0)
        t, b = onb(axis)
        sampled_dir = sampled[0] * t + sampled[1] * b + sampled[2] * axis
        light_surface = light["position"] + light["radius"] * sampled_dir
        direction = light_surface - scatter_pos
        dist = length(direction)
        dist_sq = dist * dist
        direction = direction / (dist if dist > 0.0 else 1.0)
        normal_ = normalize(light_surface - light["position"])
        emission = float(n_lights) * light["emission"]
        denom = light["area"] * 0.5 * abs(dot(normal_, direction))
        pdf = dist_sq / (denom if denom != 0.0 else 1.0)
    elif lt == 0:
        light_surface = light["position"] + light["u"] * r1 + light["v"] * r2
        direction = light_surface - scatter_pos
        dist = length(direction)
        dist_sq = dist * dist
        direction = direction / (dist if dist > 0.0 else 1.0)
        normal_ = normalize(cross(light["u"], light["v"]))
        emission = float(n_lights) * light["emission"]
        denom = light["area"] * abs(dot(normal_, direction))
        pdf = dist_sq / (denom if denom != 0.0 else 1.0)
    else:
        direction = normalize(light["position"])
        normal_ = normalize(scatter_pos - light["position"])
        emission = float(n_lights) * light["emission"]
        dist = math.inf
        pdf = 1.0

    if dot(direction, normal_) < 0.0:
        in_shadow = scene.any_hit(
            scatter_pos, direction, dist - EPS, respect_max_dist
        )
        if not in_shadow:
            p = hg_phase(dot(rd, direction), g_aniso)
            mis_weight = 1.0
            if light["area"] > 0.0:
                mis_weight = power_heuristic(pdf, p)
            if p > 0.0 and pdf > 0.0:
                ld = ld + mis_weight * emission * p / pdf

    return ld


def direct_light(scene, rd, state, u_pick, r1, r2, respect_max_dist=False,
                 use_log2=True):
    """tracer.rs:126-170."""
    ld = v(0.0, 0.0, 0.0)
    n_lights = len(scene.lights)
    if n_lights == 0:
        return ld

    scatter_pos = state["fhp"] + EPS * state["ffnormal"]
    index = min(int(u_pick * n_lights), n_lights - 1)
    light = scene.lights[index]
    lt = light.get("light_type", 1)

    if lt == 1:
        # sample_light, Spherical (tracer.rs:173-220)
        center_to_surf = scatter_pos - light["position"]
        dist_to_center = length(center_to_surf)
        sampled = uniform_sample_hemisphere(r1, r2)
        axis = center_to_surf / (dist_to_center if dist_to_center > 0.0 else 1.0)
        t, b = onb(axis)
        sampled_dir = sampled[0] * t + sampled[1] * b + sampled[2] * axis
        light_surface = light["position"] + light["radius"] * sampled_dir
        direction = light_surface - scatter_pos
        dist = length(direction)
        dist_sq = dist * dist
        direction = direction / (dist if dist > 0.0 else 1.0)
        normal_ = normalize(light_surface - light["position"])
        emission = float(n_lights) * light["emission"]
        denom = light["area"] * 0.5 * abs(dot(normal_, direction))
        pdf = dist_sq / (denom if denom != 0.0 else 1.0)  # guard contract
    elif lt == 0:
        # Rectangular (GLSL SampleRectLight; scalar mirror of
        # integrator.tracer.sample_light_rect)
        light_surface = light["position"] + light["u"] * r1 + light["v"] * r2
        direction = light_surface - scatter_pos
        dist = length(direction)
        dist_sq = dist * dist
        direction = direction / (dist if dist > 0.0 else 1.0)
        normal_ = normalize(cross(light["u"], light["v"]))
        emission = float(n_lights) * light["emission"]
        denom = light["area"] * abs(dot(normal_, direction))
        pdf = dist_sq / (denom if denom != 0.0 else 1.0)  # guard contract
    else:
        # Distant (GLSL SampleDistantLight)
        direction = normalize(light["position"])
        normal_ = normalize(scatter_pos - light["position"])
        emission = float(n_lights) * light["emission"]
        dist = math.inf
        pdf = 1.0

    if dot(direction, normal_) < 0.0:  # single-sided gate (tracer.rs:148)
        in_shadow = scene.any_hit(
            scatter_pos, direction, dist - EPS, respect_max_dist
        )
        if not in_shadow:
            f, bsdf_pdf = disney_eval(
                state["material"], state["eta"], -rd, state["ffnormal"],
                direction, use_log2,
            )
            mis_weight = 1.0
            if light["area"] > 0.0:
                mis_weight = power_heuristic(pdf, bsdf_pdf)
            if bsdf_pdf > 0.0 and pdf > 0.0:
                ld = ld + mis_weight * emission * f / pdf

    return ld


def render(
    scene: OracleScene,
    width: int,
    height: int,
    cam_uniforms: np.ndarray,  # [N, 2]
    bounce_uniforms: np.ndarray,  # [depth, N, U_PER_BOUNCE=8]
    stale_emitter_gate: bool = True,
    primary_mis: bool = True,
    respect_max_dist: bool = False,
    use_log2: bool = True,
) -> np.ndarray:
    """One frame, [H, W, 4] float64 — Tracer::render (tracer.rs:22-123)
    minus the progressive mix (one frame's radiance; accumulate outside)."""
    cam_uniforms = np.asarray(cam_uniforms, np.float64)
    bounce_uniforms = np.asarray(bounce_uniforms, np.float64)
    out = np.zeros((height, width, 4), np.float64)

    for row in range(height):
        for col in range(width):
            i = row * width + col
            # coord map: tracer.rs:36-46 reduced for image row `row` (0=top)
            px = col / width
            py = (height - 1.0 - row) / height
            ro, rd = scene.gen_ray(
                px, py, cam_uniforms[i, 0], cam_uniforms[i, 1],
                float(width), float(height),
            )

            radiance = v(0.0, 0.0, 0.0)
            throughput = v(1.0, 1.0, 1.0)
            state = dict(
                hit_dist=-1.0,  # State::new (globals.rs:28)
                normal=v(0.0, 0.0, 0.0),
                fhp=v(0.0, 0.0, 0.0),
                ffnormal=v(0.0, 0.0, 0.0),
                eta=0.0,
                is_emitter=False,
                material=material_new(),
                light_pdf=0.0,
                light_emission=v(0.0, 0.0, 0.0),
            )
            prev_pdf = 0.0  # ScatterSampleRec::new
            prev_l = v(0.0, 0.0, 0.0)
            # Current participating medium (vacuum = type 0); mirrors
            # integrator.tracer's PathState.med_* extension.
            med_type, med_density, med_color = 0, 0.0, v(0.0, 0.0, 0.0)
            med_aniso = 0.0

            for bounce in range(scene.recursion_depth):
                u6 = bounce_uniforms[bounce, i]
                state["material"] = material_new()  # tracer.rs:63
                state["is_emitter"] = False
                if not stale_emitter_gate:
                    state["hit_dist"] = np.inf

                hit = scene.closest_hit(ro, rd, state)

                # Volumetric segment effects (mirrors integrator.tracer:
                # Absorb = Beer-Lambert, Emissive = color·density·t).
                if hit and med_type != 0:
                    seg = state["hit_dist"]
                    if med_type == 3:  # Emissive
                        radiance = radiance + (
                            med_color * (med_density * seg) * throughput
                        )
                    if med_type == 1:  # Absorb
                        throughput = throughput * np.exp(
                            -(1.0 - med_color) * (med_density * seg)
                        )

                # MediumType::Scatter: exponential free-flight sampling;
                # a scatter inside the segment consumes the bounce
                # (mirrors integrator.tracer's scatter block).
                if hit and med_type == 2 and med_density > 0.0:
                    s_free = -math.log(max(1.0 - u6[7], 1e-12)) / max(
                        med_density, 1e-12
                    )
                    if s_free < state["hit_dist"]:
                        scatter_pos = ro + rd * s_free
                        throughput = throughput * med_color
                        radiance = radiance + scatter_direct_light(
                            scene, rd, scatter_pos, med_aniso,
                            u6[0], u6[1], u6[2], respect_max_dist,
                        ) * throughput
                        l = sample_hg(rd, med_aniso, u6[3], u6[4])
                        prev_l = l
                        prev_pdf = hg_phase(dot(rd, l), med_aniso)
                        ro = scatter_pos
                        rd = l
                        continue

                if not hit:
                    radiance = radiance + scene.background(rd) * throughput
                    break

                # State::finalize (globals.rs:50-62)
                state["fhp"] = ro + rd * state["hit_dist"]
                if dot(state["normal"], rd) <= 0.0:
                    state["ffnormal"] = state["normal"].copy()
                else:
                    state["ffnormal"] = -state["normal"]
                material_finalize(state["material"])
                state["eta"] = (
                    1.0 / state["material"]["ior"]
                    if dot(rd, state["normal"]) < 0.0
                    else state["material"]["ior"]
                )

                # Alpha pass-through (Blend stochastic / Mask deterministic;
                # mirrors integrator.tracer's extension of the reference's
                # declared-but-unused AlphaMode, material.rs:38-44): skip
                # the surface, re-emit the same ray, consume the bounce.
                mat_a = state["material"]
                if not state["is_emitter"] and (
                    (mat_a["alpha_mode"] == 1 and u6[6] > mat_a["opacity"])
                    or (
                        mat_a["alpha_mode"] == 2
                        and mat_a["opacity"] < mat_a["alpha_cutoff"]
                    )
                ):
                    ro = state["fhp"] + EPS * rd
                    continue

                radiance = radiance + state["material"]["emission"] * throughput

                if state["is_emitter"]:
                    if primary_mis or bounce > 0:
                        mis_weight = power_heuristic(prev_pdf, state["light_pdf"])
                    else:
                        mis_weight = 1.0
                    radiance = (
                        radiance + mis_weight * state["light_emission"] * throughput
                    )
                    break

                radiance = radiance + direct_light(
                    scene, rd, state, u6[0], u6[1], u6[2], respect_max_dist,
                    use_log2,
                ) * throughput

                f, l, pdf = disney_sample(
                    state["material"], state["eta"], -rd, state["ffnormal"],
                    prev_l, u6[3], u6[4], u6[5], use_log2,
                )
                prev_l = l
                prev_pdf = pdf
                if pdf > 0.0:
                    throughput = throughput * (f / pdf)
                else:
                    break

                # Medium transition on transmission through the surface
                # (mirrors integrator.tracer: entering a front face adopts
                # the material's medium, exiting returns to vacuum).
                if dot(l, state["ffnormal"]) < 0.0:
                    if dot(state["normal"], rd) <= 0.0:  # entered the object
                        mat_m = state["material"]
                        med_type = mat_m["medium_type"]
                        med_density = mat_m["medium_density"]
                        med_color = mat_m["medium_color"].copy()
                        med_aniso = mat_m["medium_anisotropy"]
                    else:  # exited to vacuum
                        med_type, med_density = 0, 0.0
                        med_color = v(0.0, 0.0, 0.0)
                        med_aniso = 0.0

                rd = l
                ro = state["fhp"] + EPS * rd

            out[row, col, 0:3] = radiance
            out[row, col, 3] = 1.0

    return out
