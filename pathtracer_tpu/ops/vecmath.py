"""L0 math layer: GLSL-style vector math over structure-of-arrays batches.

Batched replacement for the reference's scalar vector types and free
functions (reference: rust-pathtracer/src/fx.rs, rust-pathtracer/src/math.rs,
type aliases & constants at rust-pathtracer/src/lib.rs:5-10).

Design: the reference stores one F3 per value; a batched array-of-structs
layout ([N, 3]) strides every component access by 3. We instead use a
structure-of-arrays `V3` NamedTuple of three [N]-shaped arrays so every
component op is a dense, contiguous elementwise op. `V3` is a pytree (it is a
tuple), so it passes freely through jit/vmap/scan/shard_map and is
differentiable per component.

All functions are dtype-polymorphic: float32 for the accelerator path, float64 for
CPU-oracle comparisons (the reference's `pub type F` compile-time precision
switch, rust-pathtracer/src/lib.rs:6, becomes a runtime dtype choice).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

# Constants (reference: rust-pathtracer/src/lib.rs:8-10)
PI = 3.14159265358979323846264338327950288
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI

Scalar = Union[float, jnp.ndarray]


class V2(NamedTuple):
    """2-vector over SoA batches (reference F2, fx.rs:19-205)."""

    x: jnp.ndarray
    y: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, V2):
            return V2(self.x + o.x, self.y + o.y)
        return V2(self.x + o, self.y + o)

    def __sub__(self, o):
        if isinstance(o, V2):
            return V2(self.x - o.x, self.y - o.y)
        return V2(self.x - o, self.y - o)

    def __mul__(self, o):
        if isinstance(o, V2):
            return V2(self.x * o.x, self.y * o.y)
        return V2(self.x * o, self.y * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        # fx.rs:124-205 registers the F2 '/' operators for rhai (F2/F2,
        # F2/F, F/F2); componentwise like the F3 Div impls.
        if isinstance(o, V2):
            return V2(self.x / o.x, self.y / o.y)
        return V2(self.x / o, self.y / o)

    def __rtruediv__(self, o):
        return V2(o / self.x, o / self.y)

    def dot(self, o: "V2") -> jnp.ndarray:
        return self.x * o.x + self.y * o.y

    def length(self) -> jnp.ndarray:
        return jnp.sqrt(self.dot(self))

    def normalize(self) -> "V2":
        """fx.rs:76-81 (in-place there; functional here like V3)."""
        return self / self.length()

    def abs(self) -> "V2":
        return V2(jnp.abs(self.x), jnp.abs(self.y))  # fx.rs:88-90

    def floor(self) -> "V2":
        return V2(jnp.floor(self.x), jnp.floor(self.y))

    def fract(self) -> "V2":
        """GLSL fract = x - floor(x) (the F3 twin is fx.rs:326-329)."""
        return V2(self.x - jnp.floor(self.x), self.y - jnp.floor(self.y))

    def mult_f(self, f) -> "V2":
        return V2(self.x * f, self.y * f)  # fx.rs:96-100

    def max_f(self, f) -> "V2":
        return V2(jnp.maximum(self.x, f), jnp.maximum(self.y, f))  # fx.rs:102-105

    # --- swizzles to 3-vectors (fx.rs:107-122), used by SDF normal tricks
    def xyy(self) -> "V3":
        return V3(self.x, self.y, self.y)

    def yyx(self) -> "V3":
        return V3(self.y, self.y, self.x)

    def yxy(self) -> "V3":
        return V3(self.y, self.x, self.y)

    def xxx(self) -> "V3":
        return V3(self.x, self.x, self.x)


class V3(NamedTuple):
    """3-vector over SoA batches (reference F3, fx.rs:209-515).

    Components may be scalars or arrays of any (broadcastable) shape; ops are
    componentwise like the reference's GLSL-style operators (fx.rs:438-515).
    """

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # --- operators (fx.rs:438-515: Add/Sub/Mul/Div/Neg incl. f32*F3) ---
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return V3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # --- methods mirroring fx.rs ---
    def dot(self, o: "V3") -> jnp.ndarray:
        """fx.rs:331-337."""
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        """fx.rs:339-345."""
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length(self) -> jnp.ndarray:
        """fx.rs:321-323."""
        return jnp.sqrt(self.dot(self))

    def normalize(self) -> "V3":
        """fx.rs:307-313 (F3::normalize returns a unit copy)."""
        return self / self.length()

    def abs(self) -> "V3":
        return V3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def floor(self) -> "V3":
        return V3(jnp.floor(self.x), jnp.floor(self.y), jnp.floor(self.z))

    def fract(self) -> "V3":
        return V3(
            self.x - jnp.floor(self.x),
            self.y - jnp.floor(self.y),
            self.z - jnp.floor(self.z),
        )

    def clip(self, lo, hi) -> "V3":
        return V3(
            jnp.clip(self.x, lo, hi), jnp.clip(self.y, lo, hi), jnp.clip(self.z, lo, hi)
        )

    def max_f(self, f: Scalar) -> "V3":
        """fx.rs max_f."""
        return V3(jnp.maximum(self.x, f), jnp.maximum(self.y, f), jnp.maximum(self.z, f))

    def to_linear(self) -> "V3":
        """Gamma 2.2 decode (fx.rs:364-366, scene.rs:32-34)."""
        return V3(self.x ** 2.2, self.y ** 2.2, self.z ** 2.2)

    def to_gamma(self) -> "V3":
        """Gamma 2.2 encode (fx.rs:368-370)."""
        g = 1.0 / 2.2
        return V3(self.x ** g, self.y ** g, self.z ** g)

    # swizzles (fx.rs:107-121)
    def xyy(self):
        return V3(self.x, self.y, self.y)

    def yyx(self):
        return V3(self.y, self.y, self.x)

    def yxy(self):
        return V3(self.y, self.x, self.y)

    def xxx(self):
        return V3(self.x, self.x, self.x)

    # --- array plumbing ---
    @property
    def shape(self):
        return jnp.shape(self.x)

    @property
    def dtype(self):
        return jnp.asarray(self.x).dtype

    def stack(self, axis: int = -1) -> jnp.ndarray:
        """Materialize as a dense [..., 3] array (host/IO boundary only)."""
        return jnp.stack([self.x, self.y, self.z], axis=axis)


class B3(NamedTuple):
    """3-vector of booleans over SoA batches (reference B3, fx.rs:519-593)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    def __and__(self, o: "B3") -> "B3":
        return B3(self.x & o.x, self.y & o.y, self.z & o.z)

    def __or__(self, o: "B3") -> "B3":
        return B3(self.x | o.x, self.y | o.y, self.z | o.z)

    def __invert__(self) -> "B3":
        return B3(~self.x, ~self.y, ~self.z)

    def any(self) -> jnp.ndarray:
        return self.x | self.y | self.z

    def all(self) -> jnp.ndarray:
        return self.x & self.y & self.z

    def select(self, a: V3, b: V3) -> V3:
        """Componentwise where: self ? a : b."""
        return V3(
            jnp.where(self.x, a.x, b.x),
            jnp.where(self.y, a.y, b.y),
            jnp.where(self.z, a.z, b.z),
        )


def less_than(a: V3, b: V3) -> B3:
    """GLSL lessThan -> B3 (fx.rs B3 comparison surface)."""
    return B3(a.x < b.x, a.y < b.y, a.z < b.z)


# ---------------------------------------------------------------------------
# Constructors (fx.rs new/new_x/zeros, F3::color)
# ---------------------------------------------------------------------------

def v3(x, y, z, dtype=None) -> V3:
    if dtype is not None:
        return V3(jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype))
    return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))


def splat3(v, dtype=None) -> V3:
    """F3::new_x (fx.rs:233-239): all components equal."""
    a = jnp.asarray(v, dtype) if dtype is not None else jnp.asarray(v)
    return V3(a, a, a)


def zeros3(shape=(), dtype=jnp.float32) -> V3:
    z = jnp.zeros(shape, dtype)
    return V3(z, z, z)


def ones3(shape=(), dtype=jnp.float32) -> V3:
    o = jnp.ones(shape, dtype)
    return V3(o, o, o)


def from_array(a: jnp.ndarray) -> V3:
    """Unpack a dense [..., 3] array into SoA (IO boundary only)."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def hex_color(hex_str: str, dtype=jnp.float32) -> V3:
    """F3::color hex constructor (fx.rs:249-275, via colors-transform)."""
    s = hex_str.lstrip("#")
    r = int(s[0:2], 16) / 255.0
    g = int(s[2:4], 16) / 255.0
    b = int(s[4:6], 16) / 255.0
    return v3(r, g, b, dtype=dtype)


# ---------------------------------------------------------------------------
# Free functions (math.rs:1-78)
# ---------------------------------------------------------------------------

def safe_sqrt(x):
    """sqrt clamped at zero with a NaN-free backward pass.

    jnp.sqrt(jnp.maximum(x, 0.0)) produces NaN cotangents whenever x <= 0
    (sqrt' (0) = inf times a zero cotangent): the double-where pattern keeps
    both primal and gradient exactly zero there.
    """
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def dot(a: V3, b: V3) -> jnp.ndarray:
    return a.dot(b)


def cross(a: V3, b: V3) -> V3:
    return a.cross(b)


def length(a: V3) -> jnp.ndarray:
    return a.length()


def normalize(a: V3) -> V3:
    return a.normalize()


def safe_normalize(a: V3, eps: float = 0.0) -> V3:
    """Division-safe normalize for masked/dead lanes.

    The reference lets 0/0 produce NaN and relies on `pdf > 0` checks to kill
    the path (tracer.rs:93-97); under vmapped/masked execution NaNs poison
    gradients of *live* lanes, so dead lanes must normalize to zero instead.
    """
    l2 = a.dot(a)
    safe = jnp.where(l2 > eps, l2, 1.0)
    inv = jnp.where(l2 > eps, 1.0 / jnp.sqrt(safe), 0.0)
    return a * inv


def mix(a: V3, b: V3, t) -> V3:
    """F3 lerp (math.rs:34-41)."""
    return a * (1.0 - t) + b * t


def mix_f(a, b, t):
    """Scalar lerp (math.rs:43-46, tracer.rs:229-231 mix_ptf)."""
    return (1.0 - t) * a + b * t


def smoothstep(e0, e1, x):
    """math.rs:48-52."""
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def pow3(a: V3, b: V3) -> V3:
    """Componentwise pow (math.rs:54-61)."""
    return V3(a.x ** b.x, a.y ** b.y, a.z ** b.z)


def reflect(i: V3, n: V3) -> V3:
    """GLSL reflect (tracer.rs:464-466)."""
    return i - 2.0 * n * splat3(dot(n, i))


def refract(i: V3, n: V3, eta) -> V3:
    """GLSL refract; returns zeros on total internal reflection
    (tracer.rs:468-475)."""
    ndoti = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    out = i * eta - n * (eta * ndoti + safe_sqrt(k))
    zero = jnp.zeros_like(out.x)
    return V3(
        jnp.where(k < 0.0, zero, out.x),
        jnp.where(k < 0.0, zero, out.y),
        jnp.where(k < 0.0, zero, out.z),
    )


def onb(n: V3) -> tuple[V3, V3]:
    """Orthonormal basis around n -> (tangent, bitangent).

    Verbatim reference construction (tracer.rs:449-454, globals.rs:42-47):
    up = (0,0,1) unless |n.z| >= 0.999, then (1,0,0); t = normalize(up x n);
    b = n x t.
    """
    cond = jnp.abs(n.z) < 0.999
    zero = jnp.zeros_like(n.z)
    one = jnp.ones_like(n.z)
    up = V3(jnp.where(cond, zero, one), zero, jnp.where(cond, one, zero))
    t = safe_normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def to_local(t: V3, b: V3, n: V3, v: V3) -> V3:
    """World -> tangent frame (tracer.rs:456-458)."""
    return V3(dot(v, t), dot(v, b), dot(v, n))


def to_world(t: V3, b: V3, n: V3, v: V3) -> V3:
    """Tangent -> world frame (tracer.rs:460-462)."""
    return t * v.x + b * v.y + n * v.z


def where3(cond, a: V3, b: V3) -> V3:
    """Componentwise select over V3 with a shared predicate."""
    return V3(
        jnp.where(cond, a.x, b.x),
        jnp.where(cond, a.y, b.y),
        jnp.where(cond, a.z, b.z),
    )


def luminance(c: V3) -> jnp.ndarray:
    """Rec.709 luminance (tracer.rs:284-286)."""
    return 0.212671 * c.x + 0.715160 * c.y + 0.072169 * c.z
