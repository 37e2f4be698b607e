"""``python -m repro_torch.launch.train`` over a mesh, its ranks started
by torchrun (``python -m torch.distributed.run --standalone``) as gloo
processes on the CPU, against the launcher on one device.

qwen2-1.5b SMOKE in float32 (``torch_launch_float32.py``: the launcher's
``main`` on a float32 config), 4 steps of 8 x 32 tokens, every run
started together: one device, ``--mesh 1x2`` (every rank on "model", as
``make_host_mesh`` gives two ranks), ``--mesh 2x1x2`` uncompressed and
under int8.  Rank 0 prints the losses of every step.
The uncompressed meshes are held within ``LOSS_RTOL`` (the mesh files'
bound; measured: (1, 2) equal, (2, 1, 2) 1.5e-7 relative); int8 within
``INT8_LOSS_RTOL``, ten times its measured gap (4.6e-6) and below what
top-k's 1% reads there (4.4e-3).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.train.step import grad_bucket_plan
from torch_mesh_pair import TIMEOUT, env

LOSS_RTOL, INT8_LOSS_RTOL = 1e-5, 5e-5
ARGS = ["--arch", "qwen2-1.5b", "--steps", "4", "--seq-len", "32",
        "--global-batch", "8", "--ckpt-every", "2", "--device", "cpu"]
FLOAT32_MAIN = str(Path(__file__).with_name("torch_launch_float32.py"))
RUNS = {"one": (1, []), "1x2": (2, ["--mesh", "1x2"]),
        "2x1x2 none": (4, ["--mesh", "2x1x2", "--codec", "none"]),
        "2x1x2 int8": (4, ["--mesh", "2x1x2", "--codec", "int8"])}


@pytest.fixture(scope="module")
def losses():
    """Every run's losses, as rank 0 prints them."""
    procs = {}
    for name, (nproc, extra) in RUNS.items():
        head = [sys.executable] + ([] if nproc == 1 else [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc)])
        procs[name] = subprocess.Popen(
            head + [FLOAT32_MAIN] + ARGS + extra, env=env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (name, stderr[-4000:])
            lines = [x for x in stdout.splitlines()
                     if x.startswith("[train] losses ")]
            assert len(lines) == 1, (name, stdout)   # rank 0 alone prints
            out[name] = json.loads(lines[0][len("[train] losses "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("name", ["1x2", "2x1x2 none", "2x1x2 int8"])
def test_mesh_launch_matches_one_device(losses, name):
    rtol = INT8_LOSS_RTOL if name.endswith("int8") else LOSS_RTOL
    assert len(losses[name]) == 4
    for got, want in zip(losses[name], losses["one"], strict=True):
        assert abs(got / want - 1) <= rtol, (name, losses[name],
                                             losses["one"])


@pytest.mark.parametrize("flag", [["--spares", "1"],
                                  ["--heartbeat-timeout", "30"]])
def test_the_fault_path_over_a_mesh_raises(monkeypatch, flag):
    """With a world of 2 the launcher refuses the fault path before it
    joins a process group."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="item 7.6e"):
        launch_train.main(ARGS + flag)


def test_a_mesh_without_torchrun_raises(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        launch_train.main(ARGS + ["--mesh", "2x1x2"])


def test_state_bytes_count_each_pods_residuals():
    """A compressed pod reduction's checkpoint holds each pod's float32
    residual of every padded bucket beside the params and moments."""
    api = build_model(get_config("qwen2-1.5b", smoke=True))
    padded = sum(grad_bucket_plan(api).padded_sizes)
    assert launch_train.state_bytes(api, 2) == \
        launch_train.state_bytes(api) + 2 * 4 * padded
