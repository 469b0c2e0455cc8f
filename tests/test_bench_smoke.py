"""CPU smoke test of bench.py.

Its logic gets coverage at tiny sizes on the CPU backend: argument plumbing,
problem construction, the BENCH_REAL_GP collect/train path, and the JSON
contract (which names the device it ran on). Throughput numbers from this run
are meaningless (XLA backend, B=8) — only the protocol is under test.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run_bench(extra_env):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(
        JAX_PLATFORMS="cpu",
        BENCH_BATCH="8",
        BENCH_STEPS="2",
        BENCH_BACKEND="xla",
        BENCH_HORIZON="8",
        BENCH_GP_POINTS="32",
        BENCH_GP_INDUCING="10",
        **extra_env,
    )
    return subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=850,
    )


@pytest.mark.slow
def test_bench_emits_final_json():
    r = _run_bench({})
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(l) for l in r.stdout.splitlines() if l.strip().startswith("{")]
    assert len(lines) == 1, r.stdout
    rec = lines[0]
    assert rec["metric"] == "gpmpc_solves_per_sec_1chip"
    assert rec["unit"] == "solves/s"
    assert rec["value"] > 0
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    # phase progress must reach the timing window (stderr evidence contract)
    assert "timing window done" in r.stderr


@pytest.mark.slow
def test_bench_real_gp_path():
    r = _run_bench({"BENCH_REAL_GP": "1", "BENCH_REAL_GP_STEPS": "15"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "trained on 15 real transitions" in r.stderr
    lines = [json.loads(l) for l in r.stdout.splitlines() if l.strip().startswith("{")]
    assert lines and lines[-1]["value"] > 0
