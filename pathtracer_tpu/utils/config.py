"""Render configuration: the flag system the reference never had.

The reference hardcodes resolution (main.rs:36-37), depth (scene.rs:28),
eps (tracer.rs:16), precision (lib.rs:6), and all scene values in code;
its rhai bindings were the intended-but-unwired runtime config layer
(SURVEY.md §5). Here one dataclass covers render + execution parameters,
serializable to/from JSON for reproducible runs.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp

from ..integrator.tracer import FIXED, VERBATIM, Quirks


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800  # main.rs:36
    height: int = 600  # main.rs:37
    spp: int = 1  # 1 sample per progressive frame (tracer.rs:45)
    frames: int = 16  # progressive frames to accumulate
    depth: int = 4  # scene.rs:28-30
    seed: int = 0
    precision: str = "f32"  # "f32" | "f64" (lib.rs:6's compile-time switch)
    scene: str = "analytical"  # scene registry key
    quirks: str = "verbatim"  # "verbatim" | "fixed"
    # Execution
    kernel: str = "auto"  # "auto" (device.use_kernel) | "xla" (lax.scan integrator) | "pallas" (fused kernel)
    tile_rows: int = 4  # kernel tile height (rays per tile = 32*rows)
    tiling: str = "auto"  # kernel tile layout: auto | flat | block
    rng: str = "inkernel"  # kernel uniforms: "inkernel" (hash) | "hbm" (threefry)
    mesh_tiles: int = 1  # device-mesh tile axis (>1 = sharded render)
    mesh_spp: int = 1  # device-mesh sample axis (XLA kernel only)
    unroll: int = 1  # bounce-loop unroll factor for the XLA integrator

    @property
    def dtype(self):
        return jnp.float64 if self.precision == "f64" else jnp.float32

    @property
    def quirk_flags(self) -> Quirks:
        return VERBATIM if self.quirks == "verbatim" else FIXED

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        return cls(**json.loads(s))

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
