"""Script-level smoke tests (subprocess, CPU-forced).

Every invocation runs on the CPU (JAX_PLATFORMS=cpu, and --platform cpu where
the script takes it), so the subprocesses never reach for an accelerator."""

import os
import subprocess
import sys
from pathlib import Path
import pytest

REPO = Path(__file__).resolve().parents[1]


def run(args, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.slow
def test_run_multihost_virtual_smoke():
    r = run([
        "scripts/run_multihost.py", "--virtual", "4", "--scenarios", "8",
        "--steps", "1", "--horizon", "5", "--backend", "xla",
    ])
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"metric"' in r.stdout and "multihost_1proc_4dev" in r.stdout, r.stdout


@pytest.mark.slow
def test_eval_seeds_smoke(tmp_path):
    r = run([
        "scripts/eval_seeds.py", "--platform", "cpu", "--fast", "--seeds", "2",
        "--epochs", "1", "--steps", "16",
    ], timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "seeds improved over prior" in r.stdout, r.stdout
    # The artifact pair lands in the timestamped save dir the script printed
    # ("artifacts: <dir>/learning_curve_seeds_<model>.png/.csv" — family-
    # suffixed since the round-5 --model flag).
    line = [l for l in r.stdout.splitlines() if l.startswith("artifacts:")][0]
    stem = Path(line.split(" ", 1)[1].rsplit(".png", 1)[0])
    assert stem.name == "learning_curve_seeds_quadrotor", line
    assert stem.with_suffix(".png").exists()
    assert stem.with_suffix(".csv").exists()


@pytest.mark.slow
def test_serve_bench_smoke():
    r = run([
        "scripts/serve_bench.py", "--platform", "cpu", "--clients", "3",
        "--steps", "6", "--tile", "4", "--backend", "xla", "--max-wait-ms", "10",
    ], timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [l for l in r.stdout.splitlines() if '"metric"' in l][0]
    import json

    out = json.loads(line)
    assert out["metric"] == "served_actions_per_sec" and out["value"] > 0
    assert out["mean_batch_size"] >= 1.0
