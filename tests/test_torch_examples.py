"""The port's library examples (seqalign_tpu_torch/examples/) print what
the JAX package's (examples/) print, byte for byte, on the CPU: on the
host route and on the kernels' plain versions (SEQALIGN_FORCE=device)."""

import functools
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stdout(script, **env):
    e = dict(os.environ)
    e.update(env)
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, env=e, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@functools.lru_cache(maxsize=None)
def _original(name):
    return _stdout(f"examples/{name}_example.py", JAX_PLATFORMS="cpu")


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("name", ["nw", "sw"])
def test_example_prints_what_the_original_prints(name, route):
    env = {"SEQALIGN_DEVICE": "cpu"}
    if route == "device":
        env["SEQALIGN_FORCE"] = "device"
    got = _stdout(f"seqalign_tpu_torch/examples/{name}_example.py", **env)
    assert got and got == _original(name)


def test_example_needs_a_card_unless_asked_for_the_cpu():
    """As the CLIs: SEQALIGN_DEVICE unset is the GPU, and without one the
    example exits 1 instead of falling back; a bad value is a usage
    error."""
    import torch

    script = os.path.join(REPO, "seqalign_tpu_torch/examples/nw_example.py")
    env = dict(os.environ)
    env.pop("SEQALIGN_DEVICE", None)
    env["SEQALIGN_DEVICE"] = "tpu"
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 1 and "SEQALIGN_DEVICE" in r.stderr
    if not torch.cuda.is_available():
        env.pop("SEQALIGN_DEVICE")
        r = subprocess.run([sys.executable, script], capture_output=True,
                           text=True, env=env, timeout=300)
        assert r.returncode == 1 and "no CUDA device" in r.stderr
