"""Ray record with precomputed slab-test fields.

Replaces rust-pathtracer/src/ray.rs:6-48. The integrator's hot path carries
bare (origin, direction) V3 pairs — on the batched path the precomputed fields would be
dead weight in the scan carry — but the record is part of the reference's
public API surface (and its inv_direction/sign fields are the standard
inputs to slab AABB tests, which BVH-style scenes need), so it lives here
as a constructor utility.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops.vecmath import V3


class Ray(NamedTuple):
    """ray.rs:6-13: origin/direction plus the precomputed reciprocal
    direction and per-axis sign bits (ray.rs:24-27)."""

    origin: V3
    direction: V3
    inv_direction: V3
    sign_x: jnp.ndarray  # int32: 1 where inv_direction.x < 0
    sign_y: jnp.ndarray
    sign_z: jnp.ndarray

    def at(self, dist) -> V3:
        """o + t*d (ray.rs:31-33)."""
        return self.origin + self.direction * dist


def make_ray(origin: V3, direction: V3) -> Ray:
    """Ray::new (ray.rs:16-28): precompute inv_direction and signs.

    Division-guarded: axis-parallel rays get +/-inf reciprocals like the
    reference (Rust f32 division by zero), which is exactly what slab tests
    want.
    """
    inv = V3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    return Ray(
        origin=origin,
        direction=direction,
        inv_direction=inv,
        sign_x=(inv.x < 0.0).astype(jnp.int32),
        sign_y=(inv.y < 0.0).astype(jnp.int32),
        sign_z=(inv.z < 0.0).astype(jnp.int32),
    )
