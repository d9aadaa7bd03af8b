"""Multi-host process-group test: 2 local processes, gloo CPU collectives.

Proves the jax.distributed entry path (parallel/launch.py — SURVEY.md §5's
distributed-backend row) actually runs the sharded
train step ACROSS PROCESS BOUNDARIES: two spawned Python processes each own
4 virtual CPU devices, form one 8-device global mesh, and descend the
sharded inverse-rendering loss in lockstep. Both processes must agree on
the (replicated) final loss.

This test spawns subprocesses (clean JAX state; the parent's backend is
never touched) and is marked slow-ish: ~1-2 min of process startup.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
sys.path.insert(0, "@REPO@")
from pathtracer_tpu.parallel import launch

launch.initialize(
    coordinator="@COORD@",
    num_processes=2,
    process_id=@PID@,
    cpu_devices_per_process=4,
    cpu_collectives="gloo",
)
import jax
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
loss = launch.run_demo(width=32, height=16, steps=2)
print("FINAL_LOSS", f"{loss:.10e}", flush=True)
"""


def _worker_src(coord: str, pid: int) -> str:
    return (
        _WORKER.replace("@REPO@", REPO)
        .replace("@COORD@", coord)
        .replace("@PID@", str(pid))
    )


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_train_step(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for pid in range(2):
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _worker_src(coord, pid)],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                env=env,
            )
        )
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\nstdout:\n{out}\nstderr:\n{err}"
        outs.append(out)

    losses = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("FINAL_LOSS")]
        assert lines, out
        losses.append(float(lines[-1].split()[1]))
    # Replicated loss: every process computed the identical value.
    assert losses[0] == losses[1]
    assert losses[0] > 0.0


_WORKER_CKPT = r"""
import sys
sys.path.insert(0, "@REPO@")
from pathtracer_tpu.parallel import launch

launch.initialize(
    coordinator="@COORD@",
    num_processes=2,
    process_id=@PID@,
    cpu_devices_per_process=4,
    cpu_collectives="gloo",
)
loss = launch.run_demo_ckpt(
    width=32, height=16, steps=4, ckpt_dir="@CKPT@", die_after=@DIE@
)
print("FINAL_LOSS", f"{loss:.10e}", flush=True)
"""


def _ckpt_worker_src(coord: str, pid: int, ckpt: str, die) -> str:
    return (
        _WORKER_CKPT.replace("@REPO@", REPO)
        .replace("@COORD@", coord)
        .replace("@PID@", str(pid))
        .replace("@CKPT@", ckpt)
        .replace("@DIE@", "None" if die is None else str(die))
    )


def _spawn_pair(ckpt: str, die_map, env):
    coord = f"127.0.0.1:{_free_port()}"
    return [
        subprocess.Popen(
            [sys.executable, "-c",
             _ckpt_worker_src(coord, pid, ckpt, die_map.get(pid))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(2)
    ]


def _final_loss(out: str) -> float:
    lines = [l for l in out.splitlines() if l.startswith("FINAL_LOSS")]
    assert lines, out
    return float(lines[-1].split()[1])


@pytest.mark.slow
def test_elastic_recovery_kill_and_restart(tmp_path):
    """The elastic-recovery drill (SURVEY.md §5 failure-detection row):
    process 0 is killed abruptly after step 2 of 4; the survivor stalls in
    its next collective and is terminated (jax.distributed has no in-job
    membership change — recovery is a job restart, as on a real pod); the
    restarted job resumes from the shared checkpoint and its final loss is
    BIT-IDENTICAL to an uninterrupted run (per-step keys fold the step
    index, checkpoints are atomic npz)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    # Uninterrupted reference run.
    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir)
    procs = _spawn_pair(ref_dir, {}, env)
    losses = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"ref worker failed:\n{out}\n{err}"
        losses.append(_final_loss(out))
    assert losses[0] == losses[1]
    ref_loss = losses[0]

    # Phase A: process 0 dies after step 2; survivor stalls -> terminate.
    drill_dir = str(tmp_path / "drill")
    os.makedirs(drill_dir)
    procs = _spawn_pair(drill_dir, {0: 2}, env)
    out0, err0 = procs[0].communicate(timeout=600)
    assert procs[0].returncode == 17, f"expected simulated crash:\n{out0}\n{err0}"
    try:
        procs[1].communicate(timeout=20)
        survived = True
    except subprocess.TimeoutExpired:
        survived = False
        procs[1].kill()
        procs[1].communicate()
    # Either the survivor noticed the dead peer and exited, or it stalled
    # and we killed it — both count as "the job died".
    assert not survived or procs[1].returncode != 0

    ckpts = sorted(os.listdir(drill_dir))
    assert any(c.startswith("mh_0002") for c in ckpts), ckpts

    # Phase B: full restart from the shared checkpoint.
    procs = _spawn_pair(drill_dir, {}, env)
    losses = []
    resumed = False
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"restart worker failed:\n{out}\n{err}"
        losses.append(_final_loss(out))
        resumed = resumed or ("resumed from" in out)
    assert resumed, "restart did not resume from the checkpoint"
    assert losses[0] == losses[1]
    assert losses[0] == ref_loss, (losses[0], ref_loss)
