"""Test harness: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU: the Pallas kernels in interpret mode, the
multi-device sharding tests on 8 virtual CPU devices (SURVEY.md §4 item 5).
The platform is pinned with jax.config, which takes effect as long as no
backend has been initialized yet. The compiled GPU kernels are checked on
the card by chip_smoke.py; tests that need a GPU carry the `gpu` marker
and skip here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # Read at CPU-backend creation, which hasn't happened yet.
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The CPU unless JAX_PLATFORMS names another platform: on the card,
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs the gpu tests.
if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

# Dtype-exact oracle comparisons need f64 on the JAX side (the production
# path is f32; tests validate the vectorized math against the scalar oracle
# at matching precision).
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache (JAX_COMPILATION_CACHE_DIR, else
# .jax_cache/ in the checkout): suite wall time is dominated by CPU
# recompiles of render_frame variants; cache them across runs.
from pathtracer_tpu import device  # noqa: E402

device.setup_compile_cache(min_compile_secs=0.5)
# ... but do NOT persist XLA:CPU AOT executables: under jaxlib 0.9 the AOT
# loader reuses binaries whose recorded machine features mismatch the host
# (cpu_aot_loader warns about SIGILL) and full-suite runs segfaulted
# loading them. jaxpr-level caching stays on; the native-code cache is off.
jax.config.update("jax_persistent_cache_enable_xla_caches", "none")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """For tests of the compiled GPU kernels: skips unless JAX's default
    device is a GPU (decided here, at run time, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card via chip_smoke.py)")


@pytest.fixture(autouse=True, scope="module")
def _free_compiled_executables():
    """Unmap each module's compiled executables when the module finishes.

    Root cause of the round-3 'full suite segfaults at test ~81' failure:
    every XLA:CPU compiled executable mmaps its JIT code sections and jax
    caches executables for the process lifetime, so a full run accumulates
    memory mappings (~65k after ~90 tests — measured against this host's
    vm.max_map_count=65530). At the limit, mmap fails inside
    backend_compile_and_load / cache deserialization and the process dies
    with SIGSEGV/SIGABRT. Individual files pass because no single module
    compiles anywhere near the limit. Dropping jax's executable caches at
    module boundaries keeps the peak at O(one module), ~5-8k mappings.
    Cross-module recompiles are cheap: test programs are module-specific,
    and the persistent jaxpr cache (above) covers the shared ones.
    """
    yield
    jax.clear_caches()
