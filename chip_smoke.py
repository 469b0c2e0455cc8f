"""Smoke test of the GP-MPC main path on one NVIDIA GPU.

    python chip_smoke.py           # phases 1-6 on one card
    python chip_smoke.py --four    # phase 7 only, on four cards

Phases, in one process:
  1. device check: JAX must find a GPU; exits non-zero otherwise.
  2. QP-kernel parity at real widths: QPs from a linearized closed-loop step
     (quadrotor B=1024 T=25 hard and soft bounds, T=200 B=256, cartpole and
     two-link arm T=25), kernel vs `boxqp.solve_ocp_qp` at HIGHEST precision.
  3. main path: closed-loop `batched_gpmpc_step` steps at the bench default
     cell (quadrotor, T=25, 3 GPs, 40 inducing points, B=1024), kernel path
     vs the XLA path, action RMSE and finite diagnostics.
  4. learning loop through the reference-shaped GPMPC API.
  5. serving: ControlServer sessions in threads, with one GP hot swap.
  6. the tests marked `gpu`, run in this process.
  7. (--four only) the scenario batch sharded over four cards vs one card.

A failed check exits non-zero. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
_T0 = time.perf_counter()


class CheckFailed(Exception):
    pass


def log(msg: str):
    print(f"[smoke +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def phase_qp_parity(parity, build_problem):
    cases = [
        ("quadrotor T=25 B=1024 hard", "quadrotor", 25, 1024, None),
        ("quadrotor T=25 B=1024 soft", "quadrotor", 25, 1024, 50.0),
        ("quadrotor T=200 B=256 hard", "quadrotor", 200, 256, None),
        ("cartpole T=25 B=1024 hard", "cartpole", 25, 1024, None),
        ("twolink T=25 B=1024 hard", "twolink", 25, 1024, None),
    ]
    for name, family, T, B, soft in cases:
        problem = build_problem(family, horizon=T)
        qp = parity.step_qp(problem, B, soft)
        cfg = problem.ctrl.cfg
        res = parity.qp_parity(qp, cfg, soft)
        tol = parity.qp_tol(soft is not None, cfg.qp_mehrotra)
        log(f"phase 2 {name}: {json.dumps(res)}, primal bar {tol}")
        check(
            parity.qp_parity_ok(res, soft is not None, cfg.qp_mehrotra),
            f"{name}: kernel vs boxqp primal difference above {tol}",
        )


def phase_main_path(jax, parity, problem):
    B = 1024
    records, compiled = parity.closed_loop_parity(problem, B, n_steps=3)
    for r in records:
        log(f"phase 3 step {r['step']}: {json.dumps(r)}")
    log(f"phase 3 kernel-path step memory_analysis: {compiled.memory_analysis()}")
    check(parity.action_rmse_ok(records), "kernel vs XLA closed-loop action parity")


def phase_learning_loop(np, jnp, parity, build_problem):
    problem = build_problem("quadrotor")
    ctrl, env = problem.ctrl, problem.env
    check(ctrl.step_backend == "auto", "GPMPC step_backend default")
    check(ctrl._resolve_step_backend() == "lanes", "GPMPC auto backend on a GPU")
    # prior rollout, preprocess_data, train_gp at the config default
    _, noise = parity.rollout_trained_gp(problem)
    log(f"phase 4 trained GP noise: {noise.tolist()}")
    ctrl.reset()
    obs, _ = env.reset(seed=1)
    actions = []
    for _ in range(5):
        u = ctrl.select_action(np.asarray(obs))
        obs, *_ = env.step(jnp.asarray(u))
        actions.append(np.asarray(u))
    log(f"phase 4 GPMPC actions after training: {np.asarray(actions).round(4).tolist()}")
    check(np.all(np.isfinite(actions)), "GPMPC.select_action after train_gp")
    return ctrl.gp_model


def phase_serving(np, jnp, problem, new_gp):
    from gpmpc_tpu.runtime.server import ControlServer

    ctrl = problem.ctrl
    server = ControlServer(
        problem.model, ctrl.cfg, ctrl.consts, problem.gp, tile=8, max_wait_ms=5.0
    )
    results, errors = {}, []
    swapped = threading.Event()

    def client(i):
        try:
            sid = server.open_session()
            obs = np.asarray(problem.ctrl.traj[0]) + 0.01 * i
            us = []
            for k in range(4):
                if i == 0 and k == 2:
                    server.update_gp(new_gp)
                    swapped.set()
                us.append(server.step(sid, obs))
            results[i] = np.asarray(us)
            server.close_session(sid)
        except Exception as e:  # reported below, after the threads join
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = server.stats
    server.close()
    log(f"phase 5 served {stats.n_requests} requests in {stats.n_batches} batches")
    check(not errors, f"serving errors: {errors}")
    check(swapped.is_set(), "GP hot swap happened")
    check(len(results) == 3 and all(np.all(np.isfinite(v)) for v in results.values()),
          "every session got finite actions")


def phase_gpu_tests():
    import pytest

    os.environ["GPMPC_TEST_PLATFORM"] = "gpu"
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
        str(REPO / "tests" / "test_gpu.py"),
    ])
    log(f"phase 6 pytest -m gpu exit code {int(rc)}")
    check(int(rc) == 0, "tests marked gpu")


def phase_four(jax, jnp, np, parity, build_problem):
    from gpmpc_tpu.parallel.batch import make_batched_controller_step
    from gpmpc_tpu.parallel.mesh import make_mesh, replicate, shard_leading_axis

    n = 4
    check(len(jax.devices()) >= n, f"--four needs {n} GPUs, found {len(jax.devices())}")
    per_card = 1024
    B = n * per_card
    problem = build_problem("quadrotor")
    model, ctrl, gp = problem.model, problem.ctrl, problem.gp
    _, states, obs = parity.initial_states(problem, B)
    mesh = make_mesh(n)
    sharded = make_batched_controller_step(model, ctrl.cfg, mesh)
    args_sh = (
        replicate(ctrl.consts, mesh), replicate(gp, mesh),
        shard_leading_axis(states, mesh), shard_leading_axis(obs, mesh),
    )
    compiled = sharded.lower(*args_sh).compile()
    hlo = compiled.as_text()
    kernel_lines = [l for l in hlo.splitlines() if "__gpu$xla.gpu.triton" in l]
    full_batch = [l for l in kernel_lines if f",{B}]" in l]
    log(f"phase 7 kernel launches in the sharded HLO: {len(kernel_lines)}, "
        f"with the full batch {B}: {len(full_batch)}")
    check(kernel_lines and not full_batch, "no card sees the full scenario batch")
    single = make_batched_controller_step(model, ctrl.cfg)
    dev0 = jax.devices()[0]
    args_1 = jax.device_put((ctrl.consts, gp, states, obs), dev0)
    u_sh, st_sh, _ = compiled(*args_sh)
    u_1, st_1, _ = single(*args_1)
    jax.block_until_ready((u_sh, u_1))
    diff = parity.max_abs(u_sh, u_1)
    rmse = float(jnp.sqrt(jnp.mean((jnp.asarray(np.asarray(u_sh)) - u_1) ** 2)))
    times = {}
    for name, fn, a in (("sharded", compiled, args_sh), ("single", single, args_1)):
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(*a)
        jax.block_until_ready(out)
        times[name] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"phase 7 sharded {n}x{per_card} vs one card: max |du| {diff:.3e}, "
        f"rmse {rmse:.3e}; step ms {json.dumps(times)}")
    check(bool(np.all(np.isfinite(np.asarray(u_sh)))), "finite sharded actions")
    check(rmse <= parity.ACTION_RMSE_TOL, "sharded vs single-card action parity")


def main(argv) -> int:
    four = "--four" in argv
    if not (REPO / "gpmpc_tpu").is_dir():
        print("chip_smoke.py runs from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # the card stays the default device; the host CPU runs the QP reference
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} devices only", file=sys.stderr)
        return 1
    import jax.numpy as jnp
    import numpy as np

    from gpmpc_tpu.utils import parity
    from gpmpc_tpu.utils.benchkit import build_problem
    from gpmpc_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    print(card_info(), flush=True)
    log(f"phase 1 devices: {len(devices)} x {dev.device_kind}; compile cache {cache}")
    try:
        if four:
            phase_four(jax, jnp, np, parity, build_problem)
        else:
            phase_qp_parity(parity, build_problem)
            problem = build_problem("quadrotor")
            phase_main_path(jax, parity, problem)
            new_gp = phase_learning_loop(np, jnp, parity, build_problem)
            phase_serving(np, jnp, problem, new_gp)
            phase_gpu_tests()
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr, flush=True)
        return 1
    print(result_line(dev.platform, dev.device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
