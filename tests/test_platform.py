"""The platform choice and the compile-cache rule."""

import os
import subprocess
import sys

import pytest

import metaeuk_tpu
from metaeuk_tpu.platform import PlatformError, platform, resolve


def test_gpu_backend_is_gpu():
    assert resolve("gpu", None) == "gpu"
    assert resolve("gpu", "cpu") == "gpu"


def test_cpu_when_requested():
    assert resolve("cpu", "cpu") == "cpu"
    assert resolve("cpu", "cpu,cuda") == "cpu"


@pytest.mark.parametrize("requested", [None, "", "cuda", "cuda,cpu"])
def test_unrequested_cpu_fallback_raises(requested):
    with pytest.raises(PlatformError, match="no GPU"):
        resolve("cpu", requested)


def test_other_backend_raises():
    with pytest.raises(PlatformError, match="'tpu'"):
        resolve("tpu", "tpu")


def test_this_process_runs_on_the_requested_cpu():
    assert platform() == "cpu"


def test_cli_reports_a_missing_gpu(tmp_path):
    """With no GPU and the CPU not asked for, easy-predict stops with a
    message instead of running on the host."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(repo, "tests", "data")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = repo
    r = subprocess.run(
        [sys.executable, "-m", "metaeuk_tpu.cli", "easy-predict",
         os.path.join(data, "contigs.fna"), os.path.join(data, "proteins.faa"),
         str(tmp_path / "out")], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 2, r.stderr[-2000:]
    assert "no GPU" in r.stderr
    assert not (tmp_path / "out.fas").exists()


def test_compile_cache_follows_the_env_var():
    assert metaeuk_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}) is None


def test_compile_cache_defaults_to_the_checkout():
    d = metaeuk_tpu.compile_cache_dir({})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(repo, ".jax_cache")
