"""Test environment: the CPU, asked for explicitly, with 8 virtual devices.

JAX_PLATFORMS=cpu goes into os.environ so that the CLI subprocesses the
tests start inherit it (metaeuk_tpu.platform runs the device path on the
CPU only when asked), and into jax.config in case jax was imported before
this file. Sharding tests get 8 virtual CPU devices.

Tests marked `gpu` need an NVIDIA card (they start their own processes
on it) and skip where none is visible; `python -m pytest -m gpu` runs
them on a GPU host.
"""

import os
import shutil
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def _card_visible():
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return False
    return subprocess.run([smi, "-L"], capture_output=True).returncode == 0


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") and not _card_visible():
        pytest.skip("needs an NVIDIA GPU (none visible)")
