"""Which machine the program runs on, decided in one place.

The accelerator is an NVIDIA GPU. The Pallas kernels compile for it through
Triton. On the CPU they run in Pallas interpret mode, but only where a
caller asked for that (the tests, `app/render.py --cpu`). Any other
platform is an error: nothing here silently falls back.

The same module places JAX's persistent compilation cache: where
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it and nothing else is set;
otherwise the cache lives in `.jax_cache/` at the root of the checkout.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

# Scene families (kernel backend names, plus "media" for the analytical
# backend with participating media compiled in) whose Triton kernel beat
# the XLA integrator end to end on the card (PERF.md, Findings). Everywhere
# else `kernel="auto"` renders through the XLA integrator.
KERNEL_FAMILIES = frozenset({"analytical", "media", "sdf", "mesh", "bigmesh"})


def platform() -> str:
    """Platform of the default device: "gpu" or "cpu" (anything else raises)."""
    p = jax.devices()[0].platform
    if p not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported platform {p!r}: this program runs on an NVIDIA GPU "
            "(or on the CPU for tests)"
        )
    return p


def pallas_interpret(requested: bool = False, plat: str | None = None) -> bool:
    """The `interpret` flag a Pallas call gets.

    gpu: compiled Triton kernel (False), whatever was requested — the GPU
    path never runs the interpreter. cpu: interpret mode, only if the
    caller asked for it. Any other platform raises."""
    plat = platform() if plat is None else plat
    if plat == "gpu":
        return False
    if plat == "cpu":
        if not requested:
            raise RuntimeError(
                "the Pallas kernels compile only for the GPU; on the CPU pass "
                "interpret=True (tests, --cpu) or render with the XLA "
                "integrator (kernel='xla')"
            )
        return True
    raise RuntimeError(f"unsupported platform {plat!r}")


def use_kernel(family: str | None, kernel: str, plat: str | None = None) -> bool:
    """Route one forward render: kernel="pallas" forces the Triton kernel,
    kernel="xla" the XLA integrator, kernel="auto" takes the kernel only
    where it is compiled (the GPU; on the CPU it exists only in the
    interpreter) and for families where it measured faster
    (KERNEL_FAMILIES)."""
    if kernel == "pallas":
        return True
    if kernel == "xla":
        return False
    if kernel == "auto":
        plat = platform() if plat is None else plat
        if plat not in ("gpu", "cpu"):
            raise RuntimeError(f"unsupported platform {plat!r}")
        return plat == "gpu" and family in KERNEL_FAMILIES
    raise ValueError(f"kernel must be 'auto'|'pallas'|'xla', got {kernel!r}")


def compile_cache_dir() -> str:
    """Directory of the persistent compilation cache (see module doc)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_compile_cache(min_compile_secs: float = 2.0) -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it; only the
    fixed in-checkout default is set here. Returns the directory used."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
