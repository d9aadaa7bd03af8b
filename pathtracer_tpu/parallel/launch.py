"""Multi-host entry point: process-group wiring for pod-scale rendering.

The reference is a single-process shared-memory program (rayon threads over
one Vec, rust-pathtracer/src/tracer.rs:29-32); its "distributed backend" row
in SURVEY.md §5 prescribes `jax.distributed.initialize` + XLA collectives
for the accelerator build. This module is that entry path:

- `initialize()` wires the process group from explicit args or environment
  (JAX's own bootstrap env — COORDINATOR_ADDRESS / NUM_PROCESSES /
  PROCESS_ID — or the PT_* equivalents), optionally selecting the CPU gloo
  collectives backend so the SAME code path is testable with two local
  processes and no GPUs (tests/test_multihost.py).
- `global_mesh()` builds the ("tiles", "spp") mesh over ALL processes'
  devices — each process only addresses its local devices, XLA lowers the
  psum/all-reduce onto NCCL (NVLink within a host, the network across).
- `python -m pathtracer_tpu.parallel.launch` runs a small sharded
  inverse-rendering job end-to-end (render target, descend on light
  emission) and prints per-step losses on process 0 — the multi-host
  smoke/acceptance run for a new cluster.

Every process runs the SAME program (SPMD): jit with GSPMD shardings
handles cross-process collectives; checkpointing stays process-0-only.
"""

from __future__ import annotations

import argparse
import os

import jax
import numpy as np


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    cpu_devices_per_process: int | None = None,
    cpu_collectives: str | None = None,
) -> None:
    """Initialize the JAX process group (idempotent).

    Args fall back to PT_COORDINATOR / PT_NUM_PROCESSES / PT_PROCESS_ID and
    then to JAX's own auto-bootstrap (cluster environment). For a local
    multi-process CPU run (CI / no GPUs), set cpu_devices_per_process and
    cpu_collectives="gloo" BEFORE any JAX backend is created.

    On GPUs each process must own its own card(s): start one process per
    GPU with CUDA_VISIBLE_DEVICES set to that GPU's index (or pass
    jax.distributed.initialize's local_device_ids), and give every process
    coordinator_address="host:port", num_processes and its process_id
    explicitly — nothing tells JAX of the cluster otherwise. Two processes
    that both open every card of a host each reserve most of every card's
    memory and fail. Running on several hosts is not set up here.
    """
    if cpu_devices_per_process is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={cpu_devices_per_process}"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
    if cpu_collectives:
        jax.config.update("jax_cpu_collectives_implementation", cpu_collectives)

    coordinator = coordinator or os.environ.get("PT_COORDINATOR")
    if num_processes is None and "PT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PT_NUM_PROCESSES"])
    if process_id is None and "PT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PT_PROCESS_ID"])

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_tiles: int | None = None, n_spp: int = 1):
    """("tiles", "spp") mesh over every device of every process.

    Defaults to all global devices on the tiles axis. The device order is
    jax.devices() (process-major), so contiguous tile ranges land on one
    host first — collectives between tile neighbors stay on NVLink before
    the network.
    """
    from .mesh import make_mesh

    devices = jax.devices()
    if n_tiles is None:
        n_tiles = len(devices) // n_spp
    return make_mesh(n_tiles, n_spp, devices)


def run_demo(
    width: int = 64,
    height: int = 32,
    steps: int = 4,
    spp: int = 1,
    lr: float = 5e-2,
) -> float:
    """The multi-host acceptance job: sharded inverse rendering of the demo
    scene across the global mesh. Returns the final loss (replicated).
    Every process must call this with identical arguments."""
    import jax.numpy as jnp

    import pathtracer_tpu as pt
    from .mesh import make_train_step_sharded

    mesh = global_mesh(n_spp=1)
    scene = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=2)
    target = pt.render_frame(scene, jax.random.PRNGKey(9), width, height, spp=1)
    target_flat = jnp.asarray(np.asarray(target[..., :3]).reshape(-1, 3))

    start = scene.replace(
        lights=scene.lights._replace(emission=scene.lights.emission * 0.5)
    )
    step, (train, opt_state), _ = make_train_step_sharded(
        mesh, ("lights.emission",), start, width, height, spp=spp, lr=lr
    )
    key = jax.random.PRNGKey(1)
    loss = None
    for i in range(steps):
        key, sub = jax.random.split(key)
        train, opt_state, loss = step(train, opt_state, target_flat, sub)
        if jax.process_index() == 0:
            print(f"[proc 0] step {i}  loss {float(loss):.6e}", flush=True)
    return float(loss)


def run_demo_ckpt(
    width: int = 32,
    height: int = 16,
    steps: int = 5,
    spp: int = 1,
    lr: float = 5e-2,
    ckpt_dir: str | None = None,
    die_after: int | None = None,
) -> float:
    """run_demo with checkpoint/resume and a failure-injection hook — the
    elastic-recovery drill (SURVEY.md §5 failure-detection row).

    Per-step keys are folded from the step INDEX, so a run that resumes
    from the step-k checkpoint computes bit-identical steps k..steps to an
    uninterrupted run. Process 0 writes an atomic npz checkpoint after
    every step (shared filesystem); every process loads the latest
    checkpoint at startup. die_after=k simulates a hardware failure:
    the process exits abruptly (os._exit) after completing step k — under
    jax.distributed the surviving peers then stall in their next
    collective (there is no in-job membership change), so recovery is a
    JOB-level restart from the shared checkpoint, which is exactly what a
    cluster scheduler does on preemption."""
    import jax.numpy as jnp

    import pathtracer_tpu as pt
    from ..utils.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from .mesh import make_train_step_sharded

    mesh = global_mesh(n_spp=1)
    scene = pt.make_analytical_scene(dtype=jnp.float32, recursion_depth=2)
    target = pt.render_frame(scene, jax.random.PRNGKey(9), width, height, spp=1)
    target_flat = jnp.asarray(np.asarray(target[..., :3]).reshape(-1, 3))

    start = scene.replace(
        lights=scene.lights._replace(emission=scene.lights.emission * 0.5)
    )
    step, (train, opt_state), _ = make_train_step_sharded(
        mesh, ("lights.emission",), start, width, height, spp=spp, lr=lr
    )
    s0 = 0
    if ckpt_dir:
        path = latest_checkpoint(ckpt_dir, prefix="mh_")
        if path is not None:
            train, opt_state, s = load_checkpoint(
                path, (train, opt_state, jnp.zeros((), jnp.int32))
            )
            # Clamp so a restart AFTER completion recomputes the final
            # step (per-step keys make it bit-identical) instead of
            # returning no loss at all.
            s0 = min(int(s), steps - 1)
            if jax.process_index() == 0:
                print(f"[proc 0] resumed from {path} at step {s0}", flush=True)

    base = jax.random.PRNGKey(1)
    loss = None
    for i in range(s0, steps):
        train, opt_state, loss = step(
            train, opt_state, target_flat, jax.random.fold_in(base, i)
        )
        loss.block_until_ready()
        if ckpt_dir and jax.process_index() == 0:
            save_checkpoint(
                os.path.join(ckpt_dir, f"mh_{i + 1:04d}.npz"),
                (train, opt_state, jnp.asarray(i + 1, jnp.int32)),
            )
        if jax.process_index() == 0:
            print(f"[proc 0] step {i}  loss {float(loss):.6e}", flush=True)
        if die_after is not None and (i + 1) >= die_after:
            os._exit(17)  # simulated failure: no cleanup, no goodbye
    return float(loss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument(
        "--cpu-devices", type=int, default=None,
        help="local CPU test mode: devices per process (selects gloo collectives)",
    )
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)

    initialize(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        cpu_devices_per_process=args.cpu_devices,
        cpu_collectives="gloo" if args.cpu_devices else None,
    )
    print(
        f"process {jax.process_index()}/{jax.process_count()} "
        f"local={jax.local_device_count()} global={jax.device_count()}",
        flush=True,
    )
    loss = run_demo(width=args.width, height=args.height, steps=args.steps)
    if jax.process_index() == 0:
        print(f"final loss {loss:.6e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
