"""The one place that decides the platform (pathtracer_tpu/device.py):
interpret mode only on the CPU and only when asked, compiled kernels on
the GPU, an error anywhere else; kernel routing by scene family; and the
compilation cache's location."""

import os

import jax
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu import device
from pathtracer_tpu.ops.megakernel import kernel_family, render_frame_pallas


@pytest.mark.parametrize("requested", [False, True])
def test_tpu_platform_raises(requested):
    with pytest.raises(RuntimeError):
        device.pallas_interpret(requested, "tpu")


def test_cpu_interprets_only_when_asked():
    assert device.pallas_interpret(True, "cpu") is True
    with pytest.raises(RuntimeError):
        device.pallas_interpret(False, "cpu")


@pytest.mark.parametrize("requested", [False, True])
def test_gpu_always_compiles(requested):
    assert device.pallas_interpret(requested, "gpu") is False


def test_default_device_platform_is_supported():
    assert device.platform() == "cpu"  # conftest pins the CPU here


def test_unsupported_default_platform_raises(monkeypatch):
    class _Dev:
        platform = "tpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()])
    with pytest.raises(RuntimeError):
        device.platform()


def test_kernel_entry_point_refuses_silent_interpret():
    """render_frame_pallas on the CPU without interpret=True is an error,
    not a silent fallback."""
    scene = pt.make_analytical_scene()
    with pytest.raises(RuntimeError):
        render_frame_pallas(scene, jax.random.PRNGKey(0), 32, 8)


def test_use_kernel_routing():
    assert device.use_kernel("analytical", "pallas")
    assert not device.use_kernel("analytical", "xla")
    for fam in device.KERNEL_FAMILIES:
        assert device.use_kernel(fam, "auto", "gpu")
        # on the CPU the kernel exists only in the interpreter
        assert not device.use_kernel(fam, "auto", "cpu")
        assert not device.use_kernel(fam, "auto")  # conftest pins the CPU
    assert not device.use_kernel(None, "auto", "gpu")  # no backend claims it
    with pytest.raises(RuntimeError):
        device.use_kernel("analytical", "auto", "tpu")
    with pytest.raises(ValueError):
        device.use_kernel("analytical", "fast")


def _render_cli():
    import importlib
    import sys

    app = os.path.join(device.REPO_ROOT, "app")
    if app not in sys.path:
        sys.path.insert(0, app)
    return importlib.import_module("render")


def test_render_cli_kernel_on_cpu_needs_cpu_flag(tmp_path):
    """app/render.py --kernel pallas on a CPU device without --cpu is an
    error before any frame, not a render in the Pallas interpreter whose
    times would read as kernel times."""
    out = tmp_path / "a.png"
    with pytest.raises(RuntimeError, match="interpret"):
        _render_cli().main(["--kernel", "pallas", "--width", "32",
                            "--height", "8", "--frames", "1", "-o", str(out)])
    assert not out.exists()


def test_render_cli_default_routes_to_xla_on_cpu(tmp_path):
    """The CLI's default --kernel auto renders through the XLA integrator
    on a CPU device (no interpreter, no --cpu needed)."""
    out = tmp_path / "a.png"
    assert _render_cli().main(["--width", "16", "--height", "8",
                               "--frames", "1", "-o", str(out)]) == 0
    assert out.stat().st_size > 0


def test_kernel_family_names():
    from pathtracer_tpu.models.analytical import make_media_scene
    from pathtracer_tpu.models.sdf import make_scene as make_sdf_scene

    assert kernel_family(pt.make_analytical_scene()) == "analytical"
    assert kernel_family(make_media_scene()) == "media"
    assert kernel_family(make_sdf_scene()) == "sdf"


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)
    assert device.setup_compile_cache() == str(tmp_path)
    # the program sets no other cache directory in code
    assert all(k != "jax_compilation_cache_dir" for k, _ in calls)


def test_cache_dir_default_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.setup_compile_cache()
    assert path == os.path.join(device.REPO_ROOT, ".jax_cache")
    assert os.path.isfile(os.path.join(device.REPO_ROOT, "pyproject.toml"))
    assert ("jax_compilation_cache_dir", path) in calls
