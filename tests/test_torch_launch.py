"""The port's serving entry point, ``python -m repro_torch.launch.serve``,
run as a user runs it, on the CPU at the SMOKE config: one engine
submitting everything up front, and a two-engine cluster with a spare
under open-loop traffic with the busiest engine killed mid-run.  Each
run exits 0, finishes every request and prints the summary lines the
reference's entry point (``repro.launch.serve``) prints; the kill migrates at
least one live session.  Without ``--device`` the entry point serves on
the card: it serves there, and refuses to start where there is none."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def serve(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_launch_serve_one_engine_on_the_cpu():
    run = serve("--device", "cpu", "--requests", "12",
                "--max-new-tokens", "8", "--modes", "posix,strict")
    assert run.returncode == 0, run.stderr
    out = run.stdout
    m = re.search(r"^\[serve\] 12 requests, 96 tokens in [\d.]+s "
                  r"\((\d+) engine steps, chunk=16, sessions=POSIX,STRICT\)$",
                  out, re.M)
    assert m and int(m.group(1)) > 0, out
    assert re.search(r"^\[serve\] pages relinked=\d+ CoW-copied=0 "
                     r"adopted=\d+ pool utilization=[\d.]+%$", out, re.M), out
    assert re.search(r"^\[serve\] prefix cache: hits=\d+ misses=\d+ "
                     r"tokens_saved=\d+$", out, re.M), out
    reqs = re.findall(r"^  req \d+ \[(POSIX|STRICT)\]: prompt\[\d+\] "
                      r"prefix_hit=\d+ -> \[([\d, ]+)\]$", out, re.M)
    assert len(reqs) == 3 and all(len(t.split(",")) == 8 for _, t in reqs)
    assert "stalled" not in out


def test_launch_serve_cluster_kill_on_the_cpu():
    run = serve("--device", "cpu", "--requests", "12",
                "--max-new-tokens", "16", "--modes", "posix,strict",
                "--engines", "2", "--spares", "1", "--rate", "200",
                "--kill-at", "0.05")
    assert run.returncode == 0, run.stderr
    out = run.stdout
    assert re.search(r"^\[serve\] FAULT: killing engine [01]$", out, re.M), out
    assert re.search(r"^\[serve\] 12 requests, 192 tokens in [\d.]+s "
                     r"\(\d+ cluster ticks, 2 engines \+ 1 spares, "
                     r"sessions=POSIX,STRICT\)$", out, re.M), out
    m = re.search(r"^\[serve\] router: (\d+) home / (\d+) spilled; "
                  r"migrations=(\d+) \(migrated=(\d+) requeued=(\d+)\), "
                  r"fault=\{'steals': 1, 'remeshes': 0, 'deaths': 1\}$",
                  out, re.M)
    assert m, out
    home, spilled, migrations, migrated, _ = map(int, m.groups())
    assert home + spilled == 12 and migrations == 1 and migrated >= 1
    assert re.search(r"^\[serve\] open-loop @200.0rps: TTFT p50=\d+ms "
                     r"p99=\d+ms latency p99=\d+ms$", out, re.M), out
    assert "stalled" not in out


def test_launch_serve_defaults_to_the_card():
    run = serve("--requests", "1", "--max-new-tokens", "4")
    if torch.cuda.is_available():               # it serves on the card
        assert run.returncode == 0, run.stderr
        assert re.search(r"^\[serve\] 1 requests, 4 tokens in ",
                         run.stdout, re.M), run.stdout
    else:                                       # and refuses without one
        assert run.returncode != 0
        assert "torch.cuda.is_available() is False" in run.stderr
