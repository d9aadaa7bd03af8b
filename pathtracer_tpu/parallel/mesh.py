"""Device-mesh parallelism: pixel-tile + sample-axis sharding.

The reference's only parallelism is rayon work-stealing over scanlines on
one CPU (rust-pathtracer/src/tracer.rs:24-32) with shared-memory `&mut`
slices. The accelerator equivalent (SURVEY.md §2 parallelism table): a 2-D
`jax.sharding.Mesh` with axes

  - "tiles": data parallelism over pixels — each chip owns a contiguous
    block of the flat ray batch (the scanline-chunk analog, but static and
    compiler-visible);
  - "spp":   sample parallelism — the sample axis is sharded and the
    radiance mean is an XLA all-reduce (NCCL over NVLink between GPUs;
    the psum accumulation of BASELINE's north star; the
    sharded-reduction-axis analog of sequence parallelism, SURVEY.md §5).

Scene parameters (materials, lights, camera) are tiny and stay replicated;
inverse-rendering gradients w.r.t. replicated params are all-reduced
automatically by XLA when the loss is differentiated under these shardings
(the GSPMD recipe: pick a mesh, annotate shardings with
`with_sharding_constraint`, let XLA insert collectives).

RNG stays bit-identical to the single-chip path: `jax.random` is
counter-based and partitionable (threefry), so sharding the [depth, N, 6]
uniform tensor over "tiles" yields exactly the values the single-device run
computes — the multi-chip render is numerically identical to single-chip,
which the reference's per-thread ThreadRng could never guarantee.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrator.tracer import (
    VERBATIM,
    Quirks,
    draw_uniforms,
    trace,
)
from ..models.camera import gen_ray, pixel_coords
from ..models.scene import Scene
from ..ops.vecmath import V2, V3


def make_mesh(n_tiles: int, n_spp: int = 1, devices=None) -> Mesh:
    """Build a ("tiles", "spp") mesh from the first n_tiles*n_spp devices.

    Devices are taken in order with no topology shape: the GPUs of one
    host are joined all to all (NVLink), so the mesh follows the algorithm
    alone. "tiles" is the outer axis, "spp" the inner one (the only hot
    collective, the spp all-reduce, runs over it).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    need = n_tiles * n_spp
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_tiles, n_spp)
    return Mesh(arr, ("tiles", "spp"))


def factor_mesh(n_devices: int, devices=None, n_spp: int | None = None) -> Mesh:
    """Factor n into (tiles, spp).

    n_spp=None (default heuristic): spp gets the largest power of two <= 2
    (1 or 2), tiles the rest — pixel DP dominates at render workloads.
    Pass n_spp explicitly (any divisor of n_devices: 1, 2, 4, ...) for
    high-spp configs where the sample axis deserves more of the mesh —
    every render then requires spp to be a multiple of n_spp."""
    if n_spp is None:
        n_spp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    if n_spp < 1 or n_devices % n_spp != 0:
        raise ValueError(
            f"n_spp={n_spp} must be a positive divisor of {n_devices}"
        )
    return make_mesh(n_devices // n_spp, n_spp, devices)


def _shard_v(mesh: Mesh, v, spec: P):
    """with_sharding_constraint over a pytree (V2/V3/arrays)."""
    s = NamedSharding(mesh, spec)
    return jax.tree_util.tree_map(
        lambda x: jax.lax.with_sharding_constraint(x, s), v
    )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "width", "height", "spp", "quirks", "unroll", "detach", "remat",
    ),
)
def render_frame_sharded(
    scene: Scene,
    key,
    mesh: Mesh,
    width: int,
    height: int,
    spp: int = 1,
    quirks: Quirks = VERBATIM,
    unroll: int | bool = 1,
    detach: bool = False,
    remat: bool = False,
) -> jnp.ndarray:
    """Sharded render_frame: rays over "tiles", samples over "spp".

    Returns the same [H, W, 4] image as integrator.tracer.render_frame —
    bit-identical math, now SPMD over the mesh. The spp mean lowers to a
    psum over the "spp" axis; the image gathers over "tiles" only at the
    final reshape (keep consuming code under the same jit to avoid it).
    """
    dtype = scene.lights.radius.dtype
    n = width * height
    depth = scene.recursion_depth
    n_spp = mesh.shape["spp"]
    if spp % n_spp != 0:
        raise ValueError(f"spp={spp} not divisible by mesh spp axis {n_spp}")

    coords = _shard_v(mesh, pixel_coords(width, height, dtype), P("tiles"))

    def one_sample(k):
        cam_u, bounce_u = draw_uniforms(k, n, depth, dtype)
        cam_u = _shard_v(mesh, cam_u, P("tiles", None))
        bounce_u = _shard_v(mesh, bounce_u, P(None, "tiles", None))
        offset = V2(cam_u[:, 0], cam_u[:, 1])
        ro, rd = gen_ray(scene.camera, coords, offset, float(width), float(height))
        ro = _shard_v(mesh, ro, P("tiles"))
        rd = _shard_v(mesh, rd, P("tiles"))
        return trace(scene, ro, rd, bounce_u, quirks, unroll, detach, remat)

    if spp == 1:
        radiance = one_sample(key)
    else:
        keys = _shard_v(mesh, jax.random.split(key, spp), P("spp", None))
        acc = jax.vmap(one_sample)(keys)  # V3 of [spp, N]
        acc = _shard_v(mesh, acc, P("spp", "tiles"))
        radiance = V3(
            jnp.mean(acc.x, axis=0), jnp.mean(acc.y, axis=0), jnp.mean(acc.z, axis=0)
        )  # mean over the sharded spp axis -> XLA all-reduce

    radiance = _shard_v(mesh, radiance, P("tiles"))
    img = jnp.stack(
        [
            radiance.x.reshape(height, width),
            radiance.y.reshape(height, width),
            radiance.z.reshape(height, width),
            jnp.ones((height, width), dtype),
        ],
        axis=-1,
    )
    return img


def render_frame_sharded_pallas(
    scene: Scene,
    key,
    mesh: Mesh,
    width: int,
    height: int,
    spp: int = 1,
    quirks: Quirks = VERBATIM,
    tile_rows: int | None = None,
    uniforms: str = "inkernel",
    interpret: bool = False,
    media: bool | None = None,
    tiling: str = "auto",
) -> jnp.ndarray:
    """Sharded fused-kernel render: the Triton kernel under shard_map.

    ALL devices of `mesh` (both axes flattened) form one tile axis; each
    device launches the kernel over its contiguous range of global tiles.
    Both uniform modes are keyed on the GLOBAL ray index (the in-kernel
    hash directly; hbm threefry rows are sliced by global tile), so the
    sharded render computes the SAME samples and pixel assignment as the
    single-device `render_frame_pallas` launch, whatever the device count
    (the property the reference's per-thread ThreadRng scanline pool could
    never have, rust-pathtracer/src/tracer.rs:29-44).

    Differentiable like the single-device path: each device's backward
    rule is the XLA VJP on its own tiles, and shard_map's replicated
    in_specs psum the scene cotangents across the mesh.

    Note: uniforms="hbm" materializes the full-frame threefry rows on every
    device before slicing — intended for parity validation at small sizes;
    the production mode is "inkernel".

    media=None (default) auto-detects volumetric media from the concrete
    material table BEFORE entering the jitted body. Pass an explicit bool
    when calling from inside an outer jit.
    """
    from .. import device
    from ..ops.megakernel import (
        TILE_ROWS,
        _detect_media,
        num_warps_for,
        resolve_tiling,
    )

    if media is None:
        media = _detect_media(scene)
    tile_rows = TILE_ROWS if tile_rows is None else tile_rows
    num_warps_for(tile_rows)
    plat = mesh.devices.reshape(-1)[0].platform
    return _render_frame_sharded_pallas_jit(
        scene, key, mesh=mesh, width=width, height=height, spp=spp,
        quirks=quirks, tile_rows=tile_rows, uniforms=uniforms,
        interpret=device.pallas_interpret(interpret, plat), media=media,
        tiling=resolve_tiling(tiling, spp),
    )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "width", "height", "spp", "quirks", "tile_rows", "uniforms",
        "interpret", "media", "tiling",
    ),
)
def _render_frame_sharded_pallas_jit(
    scene: Scene,
    key,
    mesh: Mesh,
    width: int,
    height: int,
    spp: int,
    quirks: Quirks,
    tile_rows: int,
    uniforms: str,
    interpret: bool,
    media: bool,
    tiling: str,
) -> jnp.ndarray:
    from jax import shard_map

    from ..ops.megakernel import (
        _render_tiles_pallas,
        _resolve_backend,
        assemble_image,
        num_tiles_for,
    )

    backend_name = _resolve_backend(scene).name
    devs = mesh.devices.reshape(-1)
    flat_mesh = Mesh(devs, ("rays",))
    total_tiles = num_tiles_for(width, height, spp, tile_rows, tiling)
    local_tiles = -(-total_tiles // int(devs.size))

    def shard_fn(scene, key):
        base = (jax.lax.axis_index("rays") * local_tiles).astype(jnp.int32)
        return _render_tiles_pallas(
            scene, key, width, height, spp, quirks, tile_rows, uniforms,
            interpret, backend_name, tile_base=base, num_tiles=local_tiles,
            has_media=media, tiling=tiling,
        )

    planes = shard_map(
        shard_fn,
        mesh=flat_mesh,
        in_specs=(P(), P()),
        out_specs=P("rays"),
        check_vma=False,
    )(scene, key)
    # ndev * local_tiles may exceed total_tiles: surplus tiles rendered
    # border-clamped duplicates or padding; assemble_image crops them.
    return assemble_image(planes, width, height, spp, tile_rows, tiling)


def make_train_step_sharded(
    mesh: Mesh,
    select: Iterable[str],
    scene_template: Scene,
    width: int,
    height: int,
    spp: int,
    lr: float = 2e-2,
    quirks: Quirks = VERBATIM,
    kernel: str = "xla",
    tile_rows: int | None = None,
    uniforms: str = "inkernel",
    interpret: bool = False,
):
    """Build a jitted full inverse-rendering training step over the mesh.

    The step: sharded differentiable render (detached estimator) -> MSE
    against the target (sharded over "tiles") -> grads w.r.t. the selected
    scene leaves (replicated; XLA all-reduces their gradients across the
    mesh) -> Adam update.

    kernel="xla" (default) renders through the GSPMD-sharded XLA integrator
    with per-bounce remat; kernel="pallas" renders through the sharded
    fused kernel (render_frame_sharded_pallas), whose backward rule is the
    XLA VJP on the kernel's own samples. tile_rows/uniforms/interpret
    apply to the pallas kernel only.

    Returns (step_fn, init_state, names) where
    step_fn(train, opt_state, target, key) -> (train, opt_state, loss).
    """
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r}")
    import optax

    from ..integrator.inverse import select_leaves

    train0, rebuild, names = select_leaves(scene_template, select)
    opt = optax.adam(lr)

    @jax.jit
    def step(train, opt_state, target, key):
        target = _shard_v(mesh, target, P("tiles"))

        def loss_fn(tv):
            s = rebuild(tv)
            if kernel == "pallas":
                img = render_frame_sharded_pallas(
                    s, key, mesh, width, height, spp=spp, quirks=quirks,
                    tile_rows=tile_rows, uniforms=uniforms,
                    interpret=interpret,
                )
            else:
                img = render_frame_sharded(
                    s, key, mesh, width, height, spp=spp, quirks=quirks,
                    detach=True, remat=True,
                )
            flat = img[..., :3].reshape(-1, 3)
            flat = jax.lax.with_sharding_constraint(
                flat, NamedSharding(mesh, P("tiles", None))
            )
            return jnp.mean((flat - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(train)
        updates, opt_state = opt.update(grads, opt_state, train)
        train = optax.apply_updates(train, updates)
        return train, opt_state, loss

    return step, (train0, opt.init(train0)), names


__all__ = [
    "factor_mesh",
    "make_mesh",
    "make_train_step_sharded",
    "render_frame_sharded",
]
