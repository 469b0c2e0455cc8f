"""Scaling benchmark sweep over the BASELINE.json configs that fit one chip.

Covers:
  * config 3: 1k+ domain-randomized scenarios, batched closed-loop GP-MPC
  * config 4: large-dataset GP (5k training points) with 2x horizon (T=50)
  * backend comparison: lanes (Pallas) vs xla at several batch sizes

Prints one JSON line per measurement (same schema as bench.py). Run on the GPU:
  python scripts/bench_scaling.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def virtual_mesh_worker(n_devices: int, per_device: int, horizon: int, n_steps: int):
    """Measure the sharded batched GP-MPC step on `n_devices` virtual CPU devices.

    Runs in a subprocess (XLA device count must be fixed before jax import —
    the parent sets XLA_FLAGS/JAX_PLATFORMS and re-execs this file). Prints one
    JSON line with aggregate solves/s at fixed per-device batch (weak scaling).
    """
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs import drone
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude
    from gpmpc_tpu.parallel.batch import batched_gpmpc_step
    from gpmpc_tpu.parallel.mesh import make_mesh, replicate, shard_leading_axis
    from gpmpc_tpu.utils.benchkit import (
        Q_MPC, R_MPC, reference_prior_dict, synthetic_gp_model,
    )

    assert len(jax.devices()) >= n_devices, (n_devices, jax.devices())
    B = n_devices * per_device
    prior = reference_prior_dict()
    env = DroneFigureEightEnv()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(model, env.trajectory, prior, horizon=horizon, q_mpc=Q_MPC,
                 r_mpc=R_MPC, sparse_gp=True, max_gp_samples=16, seed=1,
                 max_gp_points=32, sqp_iters=3, qp_iters=5)
    gp = synthetic_gp_model(max_points=32, max_inducing=16, n_data=24, n_train=10)

    mesh = make_mesh(n_devices)
    env_p = env.p

    def closed_loop(consts, gpm, env_states, ctrl_states, obs):
        u, ctrl_states, _ = batched_gpmpc_step(
            model, ctrl.cfg, consts, gpm, ctrl_states, obs, backend="xla"
        )
        env_states, obs, _, _, _ = jax.vmap(
            lambda s, a: drone.env_step(env_p, s, a)
        )(env_states, u)
        return env_states, ctrl_states, obs, u

    step = jax.jit(closed_loop)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    env_states, obs = jax.vmap(lambda k: drone.env_reset(env_p, k))(keys)
    ctrl_states = jax.vmap(lambda _: mpc_mod.init_state(horizon, 12, 4))(jnp.arange(B))
    # Shard the scenario axis over the mesh; consts/GP replicate.
    consts = replicate(ctrl.consts, mesh)
    gp = replicate(gp, mesh)
    env_states, ctrl_states, obs = (
        shard_leading_axis(t, mesh) for t in (env_states, ctrl_states, obs)
    )

    env_states, ctrl_states, obs, u = step(consts, gp, env_states, ctrl_states, obs)
    jax.block_until_ready(u)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        env_states, ctrl_states, obs, u = step(consts, gp, env_states, ctrl_states, obs)
    jax.block_until_ready(u)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"virtual_mesh_{n_devices}dev",
        "value": round(B * n_steps / dt, 1),
        "unit": "solves/s",
        "n_devices": n_devices,
        "batch": B,
    }), flush=True)


def virtual_mesh_sweep(counts, out_path, per_device=8, horizon=10, n_steps=3):
    """Spawn one worker per device count; aggregate a weak-scaling table."""
    import os
    import subprocess

    rows = []
    for n in counts:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={n}"
        )
        r = subprocess.run(
            [sys.executable, __file__, "--virtual-mesh-worker", str(n),
             "--per-device", str(per_device), "--horizon", str(horizon),
             "--steps", str(n_steps)],
            env=env, capture_output=True, text=True, timeout=900,
        )
        if r.returncode != 0:
            raise RuntimeError(f"worker n={n} failed:\n{r.stderr[-2000:]}")
        line = [l for l in r.stdout.splitlines() if l.startswith("{")][-1]
        rows.append(json.loads(line))
        print(line, flush=True)
    base = rows[0]["value"] / rows[0]["n_devices"]
    table = {
        "metric": "virtual_mesh_weak_scaling",
        "per_device_batch": per_device,
        "rows": rows,
        "efficiency": {
            str(r["n_devices"]): round(r["value"] / r["n_devices"] / base, 3) for r in rows
        },
    }
    if out_path:
        Path(out_path).write_text(json.dumps(table, indent=2))
    print(json.dumps(table["efficiency"]), flush=True)
    return table


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--virtual-mesh", default=None,
                    help="comma-separated device counts for the CPU weak-scaling table")
    ap.add_argument("--virtual-mesh-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--per-device", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.virtual_mesh_worker is not None:
        virtual_mesh_worker(args.virtual_mesh_worker, args.per_device, args.horizon, args.steps)
        return
    if args.virtual_mesh is not None:
        counts = [int(c) for c in args.virtual_mesh.split(",")]
        virtual_mesh_sweep(counts, args.out, args.per_device, args.horizon, args.steps)
        return

    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs import drone
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude
    from gpmpc_tpu.parallel.batch import batched_gpmpc_step

    from gpmpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from gpmpc_tpu.utils.benchkit import Q_MPC as q, R_MPC as r, reference_prior_dict, synthetic_gp_model

    prior = reference_prior_dict()
    env = DroneFigureEightEnv()

    def make_gp(n_data, max_points, max_inducing):
        return synthetic_gp_model(
            max_points=max_points, max_inducing=max_inducing, n_data=n_data, n_train=20
        )

    def run_case(name, horizon, B, backend, gp, model, ctrl, steps):
        env_p = env.p

        def closed_loop(consts, gpm, env_states, ctrl_states, obs):
            u, ctrl_states, _ = batched_gpmpc_step(
                model, ctrl.cfg, consts, gpm, ctrl_states, obs, backend=backend
            )
            env_states, obs, _, _, _ = jax.vmap(
                lambda s, a: drone.env_step(env_p, s, a)
            )(env_states, u)
            return env_states, ctrl_states, obs, u

        step = jax.jit(closed_loop)
        keys = jax.random.split(jax.random.PRNGKey(1), B)
        env_states, obs = jax.vmap(lambda k: drone.env_reset(env_p, k))(keys)
        ctrl_states = jax.vmap(lambda _: mpc_mod.init_state(horizon, 12, 4))(jnp.arange(B))
        for _ in range(2):
            env_states, ctrl_states, obs, u = step(ctrl.consts, gp, env_states, ctrl_states, obs)
        jax.block_until_ready(u)
        t0 = time.perf_counter()
        for _ in range(steps):
            env_states, ctrl_states, obs, u = step(ctrl.consts, gp, env_states, ctrl_states, obs)
        jax.block_until_ready(u)
        dt = time.perf_counter() - t0
        sps = B * steps / dt
        print(json.dumps({
            "metric": f"solves_per_sec[{name}]",
            "value": round(sps, 1), "unit": "solves/s",
        }), flush=True)

    steps = 3 if args.quick else 10

    # config 3: 1k scenarios, default problem size
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(model, env.trajectory, prior, horizon=25, q_mpc=q, r_mpc=r,
                 sparse_gp=True, max_gp_samples=40, seed=1, max_gp_points=128,
                 sqp_iters=6, qp_iters=10)
    gp = make_gp(60, 128, 40)
    for backend in ("lanes", "xla"):
        for B in ((1024,) if args.quick else (1024, 4096)):
            run_case(f"T25_gp128_{backend}_B{B}", 25, B, backend, gp, model, ctrl, steps)

    # config 4: large GP (5k points padded to 5120) + 2x horizon
    ctrl50 = GPMPC(model, env.trajectory, prior, horizon=50, q_mpc=q, r_mpc=r,
                   sparse_gp=True, max_gp_samples=128, seed=1, max_gp_points=5120,
                   sqp_iters=6, qp_iters=10)
    gp_big = make_gp(5000, 5120, 128)
    run_case("T50_gp5k_lanes_B256", 50, 256, "lanes", gp_big, model, ctrl50, steps)


if __name__ == "__main__":
    main()
