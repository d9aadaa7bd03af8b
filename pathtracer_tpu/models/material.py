"""Disney/principled material model as a differentiable pytree.

Batched replacement for the reference Material/Medium structs
(rust-pathtracer/src/material.rs:8-299). Where the reference stores one
struct per hit and mutates it, here a `Material` is a NamedTuple of arrays —
a single record (scalar fields), a table of records ([M] fields), or a
per-ray batch ([N] fields) all share the same type. Every field is a
differentiable leaf, which subsumes the reference's dormant rhai scripting
surface (material.rs:276-298): materials are plain data, settable and
optimizable from outside the render loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.vecmath import V3, mix, mix_f, splat3, v3, zeros3


class MediumType:
    """material.rs:7-13."""

    NONE = 0
    ABSORB = 1
    SCATTER = 2
    EMISSIVE = 3


class AlphaMode:
    """material.rs:38-44."""

    OPAQUE = 0
    BLEND = 1
    MASK = 2


class Medium(NamedTuple):
    """Volumetric medium parameters (material.rs:16-34).

    Declared-but-unused by the reference integrator (Readme.md:13 TODO);
    carried here for API parity and future volumetric support.
    """

    medium_type: jnp.ndarray  # int32
    density: jnp.ndarray
    color: V3
    anisotropy: jnp.ndarray


class Material(NamedTuple):
    """Full principled parameter set (material.rs:48-78)."""

    rgb: V3
    anisotropic: jnp.ndarray
    emission: V3

    metallic: jnp.ndarray
    roughness: jnp.ndarray
    subsurface: jnp.ndarray
    specular_tint: jnp.ndarray

    sheen: jnp.ndarray
    sheen_tint: jnp.ndarray
    clearcoat: jnp.ndarray
    clearcoat_gloss: jnp.ndarray
    # Internal: derived from clearcoat_gloss in finalize (material.rs:62-63).
    clearcoat_roughness: jnp.ndarray

    spec_trans: jnp.ndarray
    ior: jnp.ndarray

    opacity: jnp.ndarray
    alpha_mode: jnp.ndarray  # int32
    alpha_cutoff: jnp.ndarray

    # Derived anisotropic GGX roughnesses (material.rs:72-73, set by finalize).
    ax: jnp.ndarray
    ay: jnp.ndarray

    medium: Medium


def default_medium(shape=(), dtype=jnp.float32) -> Medium:
    """Medium::new (material.rs:26-33)."""
    f = lambda c: jnp.full(shape, c, dtype)
    return Medium(
        medium_type=jnp.full(shape, MediumType.NONE, jnp.int32),
        density=f(0.0),
        color=zeros3(shape, dtype),
        anisotropy=f(0.0),
    )


def default_material(shape=(), dtype=jnp.float32) -> Material:
    """Material::new defaults (material.rs:82-114).

    Note the reference's out-of-range default albedo rgb=(1.5,1.5,1.5)
    (material.rs:85) is preserved verbatim: it is observable whenever
    closest_hit leaves rgb unset.
    """
    f = lambda c: jnp.full(shape, c, dtype)
    return Material(
        rgb=splat3(f(1.5)),
        anisotropic=f(0.0),
        emission=zeros3(shape, dtype),
        metallic=f(0.0),
        roughness=f(0.5),
        subsurface=f(0.0),
        specular_tint=f(0.0),
        sheen=f(0.0),
        sheen_tint=f(0.0),
        clearcoat=f(0.0),
        clearcoat_gloss=f(0.0),
        clearcoat_roughness=f(0.0),
        spec_trans=f(0.0),
        ior=f(1.45),
        opacity=f(1.0),
        alpha_mode=jnp.full(shape, AlphaMode.OPAQUE, jnp.int32),
        alpha_cutoff=f(0.0),
        ax=f(0.0),
        ay=f(0.0),
        medium=default_medium(shape, dtype),
    )


def finalize_material(m: Material) -> Material:
    """Material::finalize post-hit processing (material.rs:117-131).

    Pure-functional version of the reference's in-place mutation:
    - clamp roughness >= 0.01
    - remap clearcoat gloss -> roughness: mix(0.1, 0.001, gloss)
    - clamp medium anisotropy to [-0.9, 0.9]
    - derive anisotropic GGX alphas ax/ay from roughness & anisotropic.
    """
    roughness = jnp.maximum(m.roughness, 0.01)
    clearcoat_roughness = mix_f(0.1, 0.001, m.clearcoat_gloss)
    medium = m.medium._replace(anisotropy=jnp.clip(m.medium.anisotropy, -0.9, 0.9))
    aspect = jnp.sqrt(1.0 - m.anisotropic * 0.9)
    ax = jnp.maximum(roughness / aspect, 0.001)
    ay = jnp.maximum(roughness * aspect, 0.001)
    return m._replace(
        roughness=roughness,
        clearcoat_roughness=clearcoat_roughness,
        medium=medium,
        ax=ax,
        ay=ay,
    )


def mix_materials(a: Material, b: Material, t) -> Material:
    """Material::mix (material.rs:134-155).

    Verbatim parity: the reference lerps only the listed fields and leaves
    everything else (sheen-independent internals, alpha, medium) at
    Material::new defaults — reproduced exactly here.
    """
    m = default_material(jnp.shape(t), jnp.asarray(t).dtype)
    return m._replace(
        rgb=mix(a.rgb, b.rgb, t),
        emission=mix(a.emission, b.emission, t),
        anisotropic=mix_f(a.anisotropic, b.anisotropic, t),
        metallic=mix_f(a.metallic, b.metallic, t),
        roughness=mix_f(a.roughness, b.roughness, t),
        subsurface=mix_f(a.subsurface, b.subsurface, t),
        specular_tint=mix_f(a.specular_tint, b.specular_tint, t),
        sheen=mix_f(a.sheen, b.sheen, t),
        sheen_tint=mix_f(a.sheen_tint, b.sheen_tint, t),
        clearcoat=mix_f(a.clearcoat, b.clearcoat, t),
        clearcoat_gloss=mix_f(a.clearcoat_gloss, b.clearcoat_gloss, t),
        spec_trans=mix_f(a.spec_trans, b.spec_trans, t),
        ior=mix_f(a.ior, b.ior, t),
    )


def gather_material(table: Material, idx: jnp.ndarray) -> Material:
    """Select per-ray materials from a stacked [M,...] material table.

    This is the batched version of Scene::closest_hit writing material
    fields per hit (renderer/src/analytical.rs:56-117): a differentiable
    gather, so pixel gradients flow back into the material table.
    """
    return jax.tree_util.tree_map(lambda leaf: leaf[idx], table)


def select_material(cond: jnp.ndarray, a: Material, b: Material) -> Material:
    """Componentwise where() over all material leaves."""
    return jax.tree_util.tree_map(lambda la, lb: jnp.where(cond, la, lb), a, b)


def make_material(dtype=jnp.float32, **overrides) -> Material:
    """Convenience scalar-record constructor.

    rgb/emission accept 3-tuples or V3. Unspecified fields take
    Material::new defaults.
    """
    m = default_material((), dtype)
    fixed = {}
    for k, val in overrides.items():
        if k in ("rgb", "emission") and not isinstance(val, V3):
            val = v3(*val, dtype=dtype)
        elif k in ("alpha_mode",):
            val = jnp.asarray(val, jnp.int32)
        elif not isinstance(val, (V3, Medium)):
            val = jnp.asarray(val, dtype)
        fixed[k] = val
    return m._replace(**fixed)


def stack_materials(mats: list[Material]) -> Material:
    """Stack scalar material records into an [M]-table pytree."""
    return jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves), *mats)
