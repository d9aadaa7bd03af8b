#!/usr/bin/env python
"""CLI progressive renderer: the L4 application layer.

Replaces the reference's windowed viewer (renderer/src/main.rs:34-194):
where that opens a tao window and re-renders on every redraw, this runs the
same progressive loop headless — render a frame, fold it into the
ColorBuffer at weight 1/(frames+1), repeat — writing PNG output (the
reference's unimplemented TODO, Readme.md:74), with checkpoint/resume and
per-frame metrics.

Usage:
  python app/render.py --width 800 --height 600 --frames 32 -o out.png
  python app/render.py --scene sdf --depth 8 --frames 64 --ckpt-dir runs/a
  python app/render.py --kernel pallas                     # fused GPU kernel
  python app/render.py --mesh 4x1 --spp 2                  # sharded (4 devices)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import pathtracer_tpu as pt
from pathtracer_tpu import device
from pathtracer_tpu.utils.buffer import new_buffer, ColorBuffer
from pathtracer_tpu.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from pathtracer_tpu.utils.config import RenderConfig
from pathtracer_tpu.utils.image import ansi_preview, save_render
from pathtracer_tpu.utils.metrics import FrameMetrics, MetricsLog, Timer, trace_to


def build_scene(cfg: RenderConfig) -> pt.Scene:
    if cfg.scene.startswith("file:"):
        # JSON scene description (utils/sceneio): family defaults with the
        # file's parameter leaves written over them — the reference's
        # dormant "scene as script" intent (fx.rs:124-166) as data.
        from pathtracer_tpu.utils.sceneio import load_scene

        return load_scene(cfg.scene[5:], dtype=cfg.dtype,
                          recursion_depth=cfg.depth)
    if cfg.scene == "bigmesh":
        from pathtracer_tpu.models.bigmesh import make_scene as make_big

        return make_big(dtype=cfg.dtype, recursion_depth=cfg.depth)
    if cfg.scene == "analytical":
        return pt.make_analytical_scene(dtype=cfg.dtype, recursion_depth=cfg.depth)
    if cfg.scene == "media":
        from pathtracer_tpu.models.analytical import make_media_scene

        return make_media_scene(dtype=cfg.dtype, recursion_depth=cfg.depth)
    if cfg.scene == "sdf":
        from pathtracer_tpu.models.sdf import make_scene as make_sdf_scene

        return make_sdf_scene(dtype=cfg.dtype, recursion_depth=cfg.depth)
    if cfg.scene == "mesh":
        from pathtracer_tpu.models.mesh import make_scene as make_mesh_scene

        return make_mesh_scene(dtype=cfg.dtype, recursion_depth=cfg.depth)
    raise SystemExit(
        f"unknown scene {cfg.scene!r} "
        "(choose analytical|media|sdf|mesh|bigmesh|file:PATH)"
    )


def make_renderer(cfg: RenderConfig, scene: pt.Scene, quirks,
                  use_kernel: bool, interpret: bool = False):
    """Resolve the configured execution path to a (scene, key) -> frame fn:
    XLA integrator, fused GPU kernel (`use_kernel`, routed by
    device.use_kernel), or either sharded over a ("tiles", "spp") device
    mesh — every RenderConfig execution field is live here, so the CLI
    reaches every path. `interpret` (--cpu) lets the kernel run in the
    Pallas interpreter on a CPU device; without it the kernel refuses a
    CPU device (device.pallas_interpret), checked here before any frame."""
    sharded = cfg.mesh_tiles * cfg.mesh_spp > 1
    if use_kernel:
        device.pallas_interpret(interpret)
    if sharded:
        from pathtracer_tpu.parallel.mesh import (
            make_mesh,
            render_frame_sharded,
            render_frame_sharded_pallas,
        )

        mesh = make_mesh(cfg.mesh_tiles, cfg.mesh_spp)
        if use_kernel:
            return lambda s, k: render_frame_sharded_pallas(
                s, k, mesh, cfg.width, cfg.height, spp=cfg.spp, quirks=quirks,
                tile_rows=cfg.tile_rows, uniforms=cfg.rng,
                interpret=interpret, tiling=cfg.tiling,
            )
        return lambda s, k: render_frame_sharded(
            s, k, mesh, cfg.width, cfg.height, spp=cfg.spp, quirks=quirks,
            unroll=cfg.unroll,
        )
    if use_kernel:
        from pathtracer_tpu.ops.megakernel import render_frame_pallas

        return lambda s, k: render_frame_pallas(
            s, k, cfg.width, cfg.height, spp=cfg.spp, quirks=quirks,
            tile_rows=cfg.tile_rows, uniforms=cfg.rng, interpret=interpret,
            tiling=cfg.tiling,
        )
    return lambda s, k: pt.render_frame(
        s, k, cfg.width, cfg.height, spp=cfg.spp, quirks=quirks,
        unroll=cfg.unroll,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="analytical")
    ap.add_argument("--quirks", choices=["verbatim", "fixed"], default="verbatim")
    ap.add_argument("--precision", choices=["f32", "f64"], default="f32")
    ap.add_argument("-o", "--output", default="render.png")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint/resume directory")
    ap.add_argument("--ckpt-every", type=int, default=8)
    ap.add_argument("--metrics", default=None, help="write per-frame metrics jsonl")
    ap.add_argument("--profile", default=None, help="jax.profiler trace directory")
    ap.add_argument(
        "--kernel", choices=["xla", "pallas", "auto"], default="auto",
        help="integrator: lax.scan XLA path, the fused GPU kernel, or auto "
        "(the kernel on the GPU for scene families where it measured "
        "faster, XLA otherwise)",
    )
    ap.add_argument(
        "--tiling", choices=["auto", "flat", "block"], default="auto",
        help="kernel tile layout: auto picks compact 2-D pixel blocks "
        "when spp divides the lane width, flat ray ranges otherwise",
    )
    ap.add_argument(
        "--tile-rows", type=int, default=4,
        help="kernel tile height, a power of two <= 16 (rays per tile = "
        "32 * rows, one per thread)",
    )
    ap.add_argument(
        "--rng", choices=["inkernel", "hbm"], default="inkernel",
        help="kernel uniforms: counter-based hash evaluated in the kernel, "
        "or threefry rows read from device memory",
    )
    ap.add_argument(
        "--mesh", default=None, metavar="TILESxSPP",
        help="shard over a device mesh, e.g. 4x2 (tiles x spp); "
        "spp axis applies to the XLA kernel only",
    )
    ap.add_argument(
        "--unroll", type=int, default=1,
        help="bounce-loop unroll factor (XLA kernel)",
    )
    ap.add_argument(
        "--preview",
        action="store_true",
        help="live ANSI progressive view in the terminal (the reference's "
        "windowed viewer, headless)",
    )
    ap.add_argument(
        "--serve", type=int, default=None, metavar="PORT",
        help="serve the progressive render over HTTP (live browser view; "
        "the reference's window, networked)",
    )
    ap.add_argument(
        "--occupancy", action="store_true",
        help="print per-bounce alive-lane occupancy before rendering "
        "(masking economics, SURVEY.md §7)",
    )
    ap.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (--kernel pallas then runs the Pallas "
        "interpreter)",
    )
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    device.setup_compile_cache()

    mesh_tiles, mesh_spp = 1, 1
    if args.mesh:
        parts = args.mesh.lower().split("x")
        mesh_tiles = int(parts[0])
        mesh_spp = int(parts[1]) if len(parts) > 1 else 1
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.spp,
        frames=args.frames,
        depth=args.depth,
        seed=args.seed,
        precision=args.precision,
        scene=args.scene,
        quirks=args.quirks,
        kernel=args.kernel,
        tile_rows=args.tile_rows,
        tiling=args.tiling,
        rng=args.rng,
        mesh_tiles=mesh_tiles,
        mesh_spp=mesh_spp,
        unroll=args.unroll,
    )
    scene = build_scene(cfg)
    quirks = cfg.quirk_flags
    from pathtracer_tpu.ops.megakernel import kernel_family

    use_kernel = device.use_kernel(kernel_family(scene), cfg.kernel)
    render_one = make_renderer(cfg, scene, quirks, use_kernel,
                               interpret=args.cpu)

    buf = new_buffer(cfg.width, cfg.height, cfg.dtype)
    key = jax.random.PRNGKey(cfg.seed)
    start_frame = 0

    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            state = load_checkpoint(path, (buf, key, 0))
            buf, key, start_frame = state[0], state[1], int(state[2])
            print(f"resumed from {path} at frame {start_frame}")

    if args.occupancy:
        if use_kernel:
            # In-kernel counters from the fused kernel — the path where
            # the masking economics actually bind.
            from pathtracer_tpu.ops.megakernel import measure_occupancy_pallas

            stats = measure_occupancy_pallas(
                scene, key, cfg.width, cfg.height, spp=cfg.spp, quirks=quirks,
                tile_rows=cfg.tile_rows, uniforms=cfg.rng, interpret=args.cpu,
            )
            occ = [float(x) for x in stats["alive_fraction"]]
            print(
                "kernel occupancy (alive-lane fraction entering each bounce, "
                f"{stats['num_tiles']} tiles x {stats['tile']} lanes, "
                f"tiling={stats['tiling']}):\n  "
                + "  ".join(f"b{i}: {x:.3f}" for i, x in enumerate(occ))
                + f"\n  wasted-lane fraction (compaction ceiling): "
                f"{stats['wasted_fraction']:.3f}"
            )
        else:
            from pathtracer_tpu.integrator.tracer import measure_occupancy

            occ = measure_occupancy(
                scene, key, cfg.width, cfg.height, spp=cfg.spp, quirks=quirks
            )
            occ = [float(x) for x in occ]
            print(
                "bounce occupancy (alive-lane fraction entering each bounce):\n  "
                + "  ".join(f"b{i}: {x:.3f}" for i, x in enumerate(occ))
            )

    viewer = None
    if args.serve is not None:
        from pathtracer_tpu.utils.viewer import LiveViewer

        viewer = LiveViewer(port=args.serve)
        print(f"live view: http://localhost:{viewer.port}/")

    log = MetricsLog()
    with trace_to(args.profile):
        for f in range(start_frame, cfg.frames):
            key, sub = jax.random.split(key)
            t = Timer()
            frame = render_one(scene, sub)
            pixels, frames = pt.accumulate(buf.pixels, frame, buf.frames)
            pixels = jax.block_until_ready(pixels)
            buf = ColorBuffer(pixels=pixels, frames=frames)
            ms = t.stop()
            log.record(FrameMetrics(cfg.width, cfg.height, cfg.spp, cfg.depth, ms))
            if viewer is not None:
                viewer.update(buf.pixels)
                ctrls = viewer.pop_controls()
                if ctrls:
                    # Interactive camera: apply the browser's drag/wheel
                    # events (models.camera.orbit/zoom — the realized
                    # Camera3D::set loop, pinhole.rs:27-30) and restart
                    # accumulation under the new view.
                    from pathtracer_tpu.models.camera import orbit, zoom

                    cam = scene.camera
                    for c in ctrls:
                        if "orbit" in c:
                            dx, dy = c["orbit"]
                            cam = orbit(cam, -0.005 * float(dx),
                                        0.005 * float(dy))
                        if "zoom" in c:
                            cam = zoom(cam, float(c["zoom"]))
                        if "fov" in c:
                            cam = cam.set_fov(
                                float(cam.fov) + float(c["fov"])
                            )
                        if c.get("reset"):
                            cam = build_scene(cfg).camera
                    scene = scene.replace(camera=cam)
                    buf = ColorBuffer(
                        pixels=jnp.zeros_like(buf.pixels),
                        frames=jnp.zeros_like(buf.frames),
                    )
            if args.preview:
                # Home the cursor and repaint in place: progressive
                # refinement on a terminal instead of a window.
                sys.stdout.write("\x1b[H\x1b[2J" if f == start_frame else "\x1b[H")
                sys.stdout.write(ansi_preview(buf.pixels) + "\n")
            print(f"frame {f + 1}/{cfg.frames}  {ms:8.1f} ms")

            if args.ckpt_dir and (f + 1) % args.ckpt_every == 0:
                save_checkpoint(
                    os.path.join(args.ckpt_dir, f"ckpt_{f + 1:06d}.npz"),
                    (buf, key, f + 1),
                )

    if viewer is not None:
        viewer.close()
    save_render(args.output, buf.pixels)
    print(f"wrote {args.output}")
    s = log.summary()
    if s:
        print(
            f"avg {s['avg_frame_ms']:.1f} ms/frame, "
            f"{s['rays_per_s'] / 1e6:.2f} Mrays/s (primary)"
        )
    if args.metrics:
        log.dump_jsonl(args.metrics)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
