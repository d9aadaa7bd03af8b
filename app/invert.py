#!/usr/bin/env python
"""Inverse-rendering demo CLI: recover scene parameters from a render.

BASELINE config 4 as one command — recover material albedo, roughness, and
light emission of the analytical demo scene from a target image, descending
through the differentiable renderer (kernel=auto: the XLA integrator, which
measured faster for differentiated renders than the fused GPU kernel;
kernel=pallas: the kernel, optionally sharded over a device mesh). The
capability the reference cannot have: its materials are code
(/root/reference/renderer/src/analytical.rs:56-85), not data.

Examples:
    python app/invert.py                          # one GPU, kernel=auto
    python app/invert.py --kernel pallas --mesh 4x1  # kernel on 4 devices
    python app/invert.py --kernel xla --steps 40  # XLA remat path
    python app/invert.py --ckpt-dir /tmp/inv      # checkpoint + resume
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--kernel", choices=("auto", "pallas", "xla"), default="auto")
    ap.add_argument(
        "--scene", choices=("analytical", "sdf"), default="analytical",
        help="analytical: recover albedo/roughness/emission; sdf: recover "
        "GEOMETRY (sphere radius, torus major) via implicit-function grads",
    )
    ap.add_argument(
        "--mesh", default=None,
        help="TILESxSPP device mesh for the sharded kernel (--kernel "
        "pallas), e.g. 4x1",
    )
    ap.add_argument("--tile-rows", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (Pallas runs in interpret mode)",
    )
    ap.add_argument(
        "--json-out", default=None,
        help="write the recovery report as JSON to this path",
    )
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from pathtracer_tpu import device
    from pathtracer_tpu.integrator.inverse import recover_demo

    device.setup_compile_cache()

    mesh = None
    if args.mesh:
        from pathtracer_tpu.parallel.mesh import make_mesh

        t, s = args.mesh.lower().split("x")
        mesh = make_mesh(int(t), int(s))

    report = recover_demo(
        key=jax.random.PRNGKey(args.seed),
        scene=args.scene,
        width=args.width,
        height=args.height,
        steps=args.steps,
        spp=args.spp,
        lr=args.lr,
        kernel=args.kernel,
        mesh=mesh,
        tile_rows=args.tile_rows,
        ckpt_dir=args.ckpt_dir,
        recursion_depth=args.depth,
        interpret=args.cpu,
        verbose=True,
    )

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(
                {
                    "rows": [r._asdict() for r in report.rows],
                    "losses": [float(x) for x in report.losses],
                },
                f,
                indent=2,
            )
        print(f"wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
