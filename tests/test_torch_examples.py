"""The port's example twins (``examples/*_torch.py``), each run at SMOKE
size with ``--device cpu`` in a subprocess with a timeout, and with no
``--device``: on a machine without a card that raises the port's
device-policy error, on one with a card it runs there."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300                       # seconds, each run

# example -> (extra arguments, a line its output must hold)
EXAMPLES = {
    "quickstart": ([], "copied bytes    : 0"),
    "crash_recovery": ([], "all 500 records recovered"),
    "serve_kv": (["--requests", "6", "--max-batch", "2"], "prefix cache: hits="),
    "train_lm": (["--steps", "8", "--crash-at", "6"], "resumed from step 5"),
}


def run(name: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"), *args],
        capture_output=True, text=True, env=env, timeout=TIMEOUT, cwd=ROOT)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, expect = EXAMPLES[name]
    if name == "serve_kv":
        args = args + ["--trace", str(tmp_path / "trace.json")]
    proc = run(name, *args, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert expect in proc.stdout, proc.stdout[-4000:]
    if name == "serve_kv":
        assert (tmp_path / "trace.json").stat().st_size > 0
    if name == "train_lm":
        first, last = proc.stdout.split("loss: ")[1].split(" over")[0] \
            .split(" -> ")
        assert float(last) < float(first)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_defaults_to_the_card(name):
    args, expect = EXAMPLES[name]
    proc = run(name, *args)
    if torch.cuda.is_available():
        assert proc.returncode == 0 and expect in proc.stdout
    else:
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
