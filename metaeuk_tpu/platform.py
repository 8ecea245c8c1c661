"""The platform the device path runs on — the one place that asks JAX.

`platform()` returns "gpu" or "cpu" and raises on anything else. The CPU
is used only when it was asked for (`JAX_PLATFORMS=cpu`, as the tests
do): a JAX that comes up on the CPU unasked has failed to load its CUDA
plugin, and running the device path on the host instead would hide that.
Callers ask where they choose a device route, not at import time, so
host-only commands run anywhere.
"""

import functools
import os


class PlatformError(RuntimeError):
    """JAX runs on no platform this program supports."""


def resolve(backend, jax_platforms):
    """Map JAX's default backend to "gpu" or "cpu", or raise. The CPU
    counts as asked for when a JAX_PLATFORMS-style list names it first."""
    if backend in ("gpu", "cuda"):
        return "gpu"
    if backend == "cpu":
        if (jax_platforms or "").split(",")[0].strip().lower() == "cpu":
            return "cpu"
        raise PlatformError(
            "JAX found no GPU and fell back to the CPU. metaeuk-tpu runs "
            "its alignment on an NVIDIA GPU; check that the card is "
            "visible (nvidia-smi) and that JAX's CUDA plugin loads, or set "
            "JAX_PLATFORMS=cpu to run on the CPU on purpose.")
    raise PlatformError(
        f"JAX runs on {backend!r}; metaeuk-tpu supports an NVIDIA GPU, or "
        "the CPU when JAX_PLATFORMS=cpu asks for it.")


@functools.lru_cache(maxsize=None)
def platform():
    """"gpu" or "cpu" for this process (see the module docstring)."""
    import jax
    requested = os.environ.get("JAX_PLATFORMS") or jax.config.jax_platforms
    return resolve(jax.default_backend(), requested)
