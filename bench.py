#!/usr/bin/env python
"""Benchmark cells on one NVIDIA GPU at 1080p, one JSON line per (cell, path).

Cells (scene family x mode), each timed through every path that can run it:

  fwd     analytical Disney-BSDF scene, forward, depth 4
  bwd     analytical scene, forward+backward: d mean(img^2) / d (light
          emission, material albedo)
  sdf     sphere-traced SDF scene, forward, depth 4
  media   analytical scene with a glass sphere holding an HG scatter
          medium, forward, depth 6
  mesh    20-triangle mesh, forward, depth 4
  mesh1k  1090-triangle mesh (tessellated sphere + ground), forward, depth 4

Paths: "xla" (integrator/tracer.py render_frame) and "kernel" (the fused
Triton kernel, ops/megakernel.py, in-kernel hash uniforms). For bwd:
"xla_remat" / "xla_noremat" (jax.grad of the detached XLA estimator with
and without per-bounce rematerialization) and "kernel" (Triton forward,
the kernel's custom VJP backward).

The metric is path segments per second: width * height * spp * depth per
frame, over the best window (shadow rays not counted). Frames are CHAINED
through an accumulator inside one jitted fori_loop per window, so no frame
can be elided and host dispatch is off the critical path; the clock stops
on a host readback of a scalar reduction of the accumulator.

Usage: python bench.py [--cells fwd,sdf] [--paths xla,kernel]
                       [--window-s 2.0] [--windows 4]
Fails when JAX finds no GPU. Each line names the device (platform,
device_kind, count) and the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from pathtracer_tpu import device

WIDTH, HEIGHT, SPP = 1920, 1080, 1
FWD_PATHS = ("xla", "kernel")
BWD_PATHS = ("xla_remat", "xla_noremat", "kernel")


def gpu_info() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cell_scene(cell: str):
    """The scene of a benchmark cell (bwd shares fwd's)."""
    import pathtracer_tpu as pt
    from pathtracer_tpu.models import bigmesh, mesh, sdf
    from pathtracer_tpu.models.analytical import make_media_scene

    f32 = jnp.float32
    return {
        "fwd": lambda: pt.make_analytical_scene(dtype=f32, recursion_depth=4),
        "bwd": lambda: pt.make_analytical_scene(dtype=f32, recursion_depth=4),
        "sdf": lambda: sdf.make_scene(dtype=f32, recursion_depth=4),
        "media": lambda: make_media_scene(f32, 6),
        "mesh": lambda: mesh.make_scene(dtype=f32, recursion_depth=4),
        "mesh1k": lambda: bigmesh.make_scene(dtype=f32, recursion_depth=4),
    }[cell]()


def forward_frame(scene, path: str, width: int = WIDTH, height: int = HEIGHT):
    """(scene, key) -> [H, W, 4] frame through one path. The scene is an
    argument, not a closed-over constant: a renderer gets its scene at run
    time, and constant scene data would let XLA fold it into the program."""
    import pathtracer_tpu as pt
    from pathtracer_tpu.ops.megakernel import _detect_media, render_frame_pallas

    if path == "xla":
        return lambda s, k: pt.render_frame(s, k, width, height, spp=SPP)
    if path == "kernel":
        media = _detect_media(scene)  # from the concrete scene, before tracing
        return lambda s, k: render_frame_pallas(
            s, k, width, height, spp=SPP, uniforms="inkernel", media=media
        )
    raise ValueError(f"unknown forward path {path!r}")


def grad_fn(path: str, width: int = WIDTH, height: int = HEIGHT):
    """(scene, key) -> grads of mean(img^2) w.r.t. (light emission,
    material albedo): the fwd+bwd cell's step. The kernel path's backward
    is the kernel's custom VJP."""
    import pathtracer_tpu as pt
    from pathtracer_tpu.ops.megakernel import render_frame_pallas

    def loss_fn(emission, rgb, scene, key):
        s = scene.replace(
            lights=scene.lights._replace(emission=emission),
            params=scene.params._replace(
                materials=scene.params.materials._replace(rgb=rgb)
            ),
        )
        if path == "kernel":
            img = render_frame_pallas(
                s, key, width, height, spp=SPP, uniforms="inkernel",
                media=False,
            )
        else:
            img = pt.render_frame(
                s, key, width, height, spp=SPP, detach=True,
                remat=(path == "xla_remat"),
            )
        return jnp.mean(img[..., :3] ** 2)

    g = jax.grad(loss_fn, argnums=(0, 1))
    return lambda s, k: g(s.lights.emission, s.params.materials.rgb, s, k)


def sum_leaves(tree):
    """f32 sum of every leaf: the chain's data dependency on a frame (an
    image, or a gradient pytree)."""
    return sum(jnp.sum(x, dtype=jnp.float32)
               for x in jax.tree_util.tree_leaves(tree))


def _measure(frame, scene, window_s: float, windows: int,
             max_windows: int = 10):
    """Device-chained timing: ONE dispatch per window, not one per frame.

    The window's frames `frame(scene, key)` run inside a single jitted
    lax.fori_loop (key folded in-device, scene and trip count traced
    arguments so every window length shares one compilation). The number of frames per window is set from
    a timed one-frame window so a window lasts about window_s. Takes at
    least `windows` windows; if the median is >15% above the best, keeps
    sampling up to `max_windows`. Returns (best_s, frames, times, setup_s)
    where setup_s is the first call (compilation included)."""

    def chain(acc, scene, key, n):
        def body(i, a):
            return a + sum_leaves(frame(scene, jax.random.fold_in(key, i)))
        return jax.lax.fori_loop(0, n, body, acc)

    chain_j = jax.jit(chain)
    t0 = time.perf_counter()
    acc = jnp.zeros((), jnp.float32)
    acc = chain_j(acc, scene, jax.random.PRNGKey(1), 1)
    float(acc)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    acc = chain_j(acc, scene, jax.random.PRNGKey(2), 1)
    float(acc)
    one = time.perf_counter() - t0
    frames = max(1, min(200, int(round(window_s / max(one, 1e-6)))))

    times = []
    while True:
        key = jax.random.PRNGKey(3 + len(times))
        t0 = time.perf_counter()
        acc = chain_j(acc, scene, key, frames)
        checksum = float(acc)  # host readback stops the clock
        dt = time.perf_counter() - t0
        if not jnp.isfinite(checksum):
            raise FloatingPointError(f"non-finite checksum {checksum}")
        times.append(dt)
        if len(times) >= windows:
            ts = sorted(times)
            if ts[len(ts) // 2] / ts[0] <= 1.15 or len(times) >= max_windows:
                break
    return min(times), frames, times, setup_s


def run_cell(cell: str, path: str, window_s: float = 2.0, windows: int = 4,
             gpu: str | None = None) -> dict:
    """Time one (cell, path); returns the JSON record (also printed)."""
    scene = cell_scene(cell)
    depth = scene.recursion_depth
    frame = grad_fn(path) if cell == "bwd" else forward_frame(scene, path)
    best, frames, times, setup_s = _measure(frame, scene, window_s, windows)
    d = jax.devices()[0]
    rec = {
        "metric": f"{cell}_segments_per_s_1080p_depth{depth}",
        "cell": cell,
        "path": path,
        "value": WIDTH * HEIGHT * SPP * depth * frames / best,
        "unit": "path segments/s",
        "frame_s": best / frames,
        "frames_per_window": frames,
        "window_s": times,
        "setup_s": setup_s,
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "gpu": gpu if gpu is not None else gpu_info(),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="fwd,bwd,sdf,media,mesh,mesh1k")
    ap.add_argument("--paths", default="",
                    help="comma list; default every path of each cell")
    ap.add_argument("--window-s", type=float, default=2.0)
    ap.add_argument("--windows", type=int, default=4)
    args = ap.parse_args(argv)

    if device.platform() != "gpu":
        print("bench.py needs a GPU; JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 2
    device.setup_compile_cache()
    gpu = gpu_info()
    print(f"gpu: {gpu}", flush=True)
    only = [p for p in args.paths.split(",") if p]
    failed = 0
    for cell in args.cells.split(","):
        for path in BWD_PATHS if cell == "bwd" else FWD_PATHS:
            if only and path not in only:
                continue
            try:
                run_cell(cell, path, args.window_s, args.windows, gpu)
            except Exception as e:  # one cell's failure is recorded, not fatal
                failed += 1
                print(json.dumps({"cell": cell, "path": path,
                                  "error": f"{type(e).__name__}: {e}"[:2000],
                                  "gpu": gpu}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
