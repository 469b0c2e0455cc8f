"""Multi-host / multi-chip scale-out driver (BASELINE config 5: 64k scenarios).

Shards a large scenario batch over every available device (NVLink within a
host, the network across hosts after `jax.distributed.initialize`) and runs
closed-loop GP-MPC steps; per-device work is the batched controller step,
cross-device reductions (mean tracking error, aggregate solves/s) ride XLA
collectives.

Run modes:
  * GPU hosts, multi-host:        python scripts/run_multihost.py --distributed \
                                      --coordinator HOST:PORT --num-processes N --process-id I
  * GPUs of one host:             python scripts/run_multihost.py
  * local validation (no GPU):    python scripts/run_multihost.py --virtual 8 \
                                      --scenarios 64 --steps 2 --backend xla
  * local MULTI-PROCESS validation (exercises jax.distributed.initialize +
    cross-process Gloo collectives on CPU — the DCN code path with N local
    processes standing in for N hosts):
        python scripts/run_multihost.py --virtual-hosts 2 --scenarios 16 \
            --steps 1 --backend xla --horizon 10 --gp-points 32 --parity

The driver's `__graft_entry__.dryrun_multichip` exercises the same sharded path
in CI; this script is the operational entry point. `tests/test_multihost.py`
runs the --virtual-hosts parity mode so the multi-host init path
(parallel/mesh.py::init_distributed) is executed by the suite.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--backend", default="auto", choices=["auto", "lanes", "xla"])
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--gp-points", type=int, default=128)
    ap.add_argument("--distributed", action="store_true", help="jax.distributed.initialize()")
    ap.add_argument("--virtual", type=int, default=0, help="force N virtual CPU devices")
    ap.add_argument(
        "--virtual-hosts", type=int, default=0,
        help="spawn N local CPU processes as virtual hosts (multi-process "
        "jax.distributed over 127.0.0.1; each host gets --virtual devices, "
        "default 2)",
    )
    ap.add_argument(
        "--parity", action="store_true",
        help="after the sharded run, recompute the step locally (unsharded) "
        "and assert cross-process / sharded-vs-local parity",
    )
    ap.add_argument(
        "--sweep", type=int, default=0, metavar="N_SEEDS",
        help="instead of the closed-loop step benchmark, run an N_SEEDS-seed "
        "learning sweep (parallel/sweep.py) with the seed axis sharded over "
        "the global (multi-process) mesh; --parity compares the sharded "
        "cost matrix against a local unsharded recomputation",
    )
    ap.add_argument(
        "--worker-timeout", type=float, default=600.0,
        help="per-worker wait in --virtual-hosts mode; keep BELOW any outer "
        "subprocess timeout so a hung worker is reaped here (with its "
        "siblings), not by an external kill of the orchestrator",
    )
    # Worker-mode plumbing (set by the --virtual-hosts orchestrator, not by hand).
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def orchestrate_virtual_hosts(args) -> int:
    """Spawn N copies of this script as local 'hosts' sharing one coordinator."""
    import socket
    import tempfile

    n = args.virtual_hosts
    devices_per_host = args.virtual or 2

    # Hold the probe socket bound until immediately before spawning: the old
    # bind/close/spawn sequence left a window for another process to claim the
    # port (TOCTOU — advisor finding, round 4). The coordinator itself sets
    # SO_REUSEADDR, so it can bind while this socket lingers in TIME_WAIT.
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]

    base = [
        sys.executable, os.path.abspath(__file__),
        "--scenarios", str(args.scenarios), "--steps", str(args.steps),
        "--backend", args.backend, "--horizon", str(args.horizon),
        "--gp-points", str(args.gp_points),
        "--virtual", str(devices_per_host),
        "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", str(n),
        "--sweep", str(args.sweep),
    ]
    if args.parity:
        base.append("--parity")
    # Workers write to temp files, not PIPEs: a later worker filling a 64KB
    # pipe while an earlier one is barriered in a collective would deadlock a
    # sequential drain.
    logs = [tempfile.TemporaryFile(mode="w+", prefix=f"vhost{i}_") for i in range(n)]
    s.close()
    procs = [
        subprocess.Popen(
            base + ["--process-id", str(i)],
            stdout=logs[i], stderr=subprocess.STDOUT, text=True,
        )
        for i in range(n)
    ]
    # One shared deadline (--worker-timeout, default 600 s — kept below the
    # callers' outer subprocess timeouts so a hang is reaped HERE); on the
    # first failure or timeout, kill every sibling so no worker outlives the
    # orchestrator blocked in a collective.
    deadline = time.monotonic() + args.worker_timeout
    rc = 0
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = rc or 1
        if rc == 0 and p.returncode not in (0, None):
            rc = p.returncode or 1
        if rc != 0:
            break
    if rc != 0:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            rc = rc or p.returncode or 1
    for i, f in enumerate(logs):
        f.seek(0)
        # Process 0 carries the metric line; echo every host's output with a
        # prefix so failures are diagnosable from the orchestrator's log.
        for line in f.read().splitlines():
            print(line if i == 0 and not line.startswith("[") else f"[host{i}] {line}")
        f.close()
    return rc


def run_sweep(args, pid: int, n_dev: int):
    """Multi-process seed sweep: S learning runs, seed axis sharded over the
    global (DCN) mesh; --parity recomputes unsharded locally and compares.

    Exercises the round-4 gap: `parallel/sweep.py::seed_sweep` with `mesh`
    spanning multiple PROCESSES (the make_array_from_callback sharding path),
    not just multiple devices of one process."""
    import time as _time

    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs import drone
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude
    from gpmpc_tpu.parallel.mesh import make_mesh
    from gpmpc_tpu.parallel.sweep import seed_sweep
    from gpmpc_tpu.utils.benchkit import Q_MPC as q, R_MPC as r, reference_prior_dict

    S = args.sweep
    n_epochs = 2
    n_steps = max(args.steps, 20)
    prior = reference_prior_dict()
    env = DroneFigureEightEnv()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(
        model, env.trajectory, prior, horizon=args.horizon, q_mpc=q, r_mpc=r,
        sparse_gp=True, max_gp_samples=10, seed=1, max_gp_points=64,
        sqp_iters=3, qp_iters=6,
    )
    kw = dict(
        n_seeds=S, n_epochs=n_epochs, n_steps=n_steps,
        samples_per_epoch=min(16, n_steps), max_inducing=10, sparse=True,
        gp_iters=20, master_seed=0, env_mod=drone, backend=args.backend,
    )
    mesh = make_mesh(n_dev)
    t0 = _time.perf_counter()
    res = seed_sweep(model, ctrl.cfg, env.p, ctrl.consts, mesh=mesh, **kw)
    # Reshard the (epochs+1, S) cost matrix to replicated: every host then
    # holds the full value in its local shards (legal to read anywhere).
    costs = np.asarray(
        jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(res.costs)
    )
    dt = _time.perf_counter() - t0

    if args.parity:
        res_local = seed_sweep(model, ctrl.cfg, env.p, ctrl.consts, mesh=None, **kw)
        dcost = float(np.max(np.abs(costs - np.asarray(res_local.costs))))
        rel = dcost / max(1e-9, float(np.max(np.abs(costs))))
        ok = rel < 1e-3
        print(
            f"SWEEP-PARITY pid={pid} max|dcost|={dcost:.3e} rel={rel:.3e} ok={ok}",
            flush=True,
        )
        if not ok:
            sys.exit(3)

    if pid == 0:
        improved = int(np.sum(costs[-1] < costs[0]))
        print(json.dumps({
            "metric": (
                f"sweep[multihost_{jax.process_count()}proc_{n_dev}dev_"
                f"S{S}_{args.backend}]"
            ),
            "seeds_improved": improved, "n_seeds": S,
            "wall_s": round(dt, 1),
            "mean_cost_prior": round(float(costs[0].mean()), 4),
            "mean_cost_final": round(float(costs[-1].mean()), 4),
        }))


def main():
    args = parse_args()
    if args.virtual_hosts and args.process_id is None:
        sys.exit(orchestrate_virtual_hosts(args))

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={args.virtual}"
        )
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    if args.distributed or args.coordinator is not None:
        # `jax.distributed.initialize` must run before anything touches the
        # XLA backend; importing gpmpc_tpu is safe here because the package
        # performs no device ops at import time (tests/test_import_hygiene.py
        # locks this in).
        from gpmpc_tpu.parallel.mesh import init_distributed

        # Explicit coordinator triple: a local virtual-host worker or a GPU
        # host (JAX has no cluster auto-detection on plain GPU hosts).
        init_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs import drone
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude
    from gpmpc_tpu.parallel.batch import make_batched_controller_step
    from gpmpc_tpu.parallel.mesh import make_mesh

    pid = jax.process_index()
    n_dev = len(jax.devices())
    if args.sweep:
        return run_sweep(args, pid, n_dev)
    B = args.scenarios - (args.scenarios % n_dev) or n_dev
    mesh = make_mesh(n_dev)
    shard = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    from gpmpc_tpu.utils.benchkit import Q_MPC as q, R_MPC as r, reference_prior_dict, synthetic_gp_model

    prior = reference_prior_dict()
    env = DroneFigureEightEnv()
    model = symbolic_attitude(dt=0.02, params=prior)
    gp_inducing = min(40, args.gp_points)
    ctrl = GPMPC(model, env.trajectory, prior, horizon=args.horizon, q_mpc=q, r_mpc=r,
                 sparse_gp=True, max_gp_samples=gp_inducing, seed=1,
                 max_gp_points=args.gp_points, sqp_iters=6, qp_iters=10)
    gp = synthetic_gp_model(
        max_points=args.gp_points, max_inducing=gp_inducing,
        n_data=args.gp_points, n_train=20,
    )

    env_p = env.p
    traj = env.trajectory

    # The controller step shards the scenario axis itself (under shard_map on
    # the kernel path, which XLA would not partition).
    ctrl_step = make_batched_controller_step(model, ctrl.cfg, mesh, backend=args.backend)

    def closed_loop(consts, gpm, env_states, ctrl_states, obs):
        u, ctrl_states, _ = ctrl_step(consts, gpm, ctrl_states, obs)
        env_states, obs, _, _, _ = jax.vmap(lambda s, a: drone.env_step(env_p, s, a))(env_states, u)
        # Cross-device reduction over the sharded scenario axis (XLA collective).
        ref = traj[jnp.mod(ctrl_states.traj_step[0], traj.shape[0])]
        err = jnp.sqrt((obs[:, 0] - ref[0]) ** 2 + (obs[:, 2] - ref[2]) ** 2 + (obs[:, 4] - ref[4]) ** 2)
        return env_states, ctrl_states, obs, u, jnp.mean(err)

    step = jax.jit(
        closed_loop,
        in_shardings=(repl, repl, shard, shard, shard),
        out_shardings=(shard, shard, shard, shard, repl),
    )

    # Every process builds the identical full-batch initial state (deterministic
    # from the seed), then the global sharded arrays are assembled shard-by-shard
    # — device_put of a host array onto a mesh spanning non-addressable devices
    # is not legal in multi-process mode, make_array_from_callback is.
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    env_states0, obs0 = jax.vmap(lambda k: drone.env_reset(env_p, k))(keys)
    ctrl_states0 = jax.vmap(lambda _: mpc_mod.init_state(args.horizon, 12, 4))(jnp.arange(B))

    def globalize(tree, sharding):
        def _mk(leaf):
            host = np.asarray(leaf)
            return jax.make_array_from_callback(host.shape, sharding, lambda idx: host[idx])

        return jax.tree.map(_mk, tree)

    env_states = globalize(env_states0, shard)
    ctrl_states = globalize(ctrl_states0, shard)
    obs = globalize(obs0, shard)
    consts_g = globalize(ctrl.consts, repl)
    gp_g = globalize(gp, repl)

    for _ in range(2):
        env_states, ctrl_states, obs, u, err = step(consts_g, gp_g, env_states, ctrl_states, obs)
    err.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        env_states, ctrl_states, obs, u, err = step(consts_g, gp_g, env_states, ctrl_states, obs)
    err.block_until_ready()
    dt = time.perf_counter() - t0
    sps = B * args.steps / dt

    if args.parity:
        # Re-run the same 2+steps window locally (unsharded, this process's
        # default device) and compare against the globally-sharded result —
        # cross-process parity of the full control trace.
        from jax.experimental import multihost_utils

        local_step = jax.jit(closed_loop)
        es, cs, ob = env_states0, ctrl_states0, obs0
        for _ in range(2 + args.steps):
            es, cs, ob, u_loc, err_loc = local_step(ctrl.consts, gp, es, cs, ob)
        u_glob = multihost_utils.process_allgather(u, tiled=True)
        du = float(np.max(np.abs(np.asarray(u_glob) - np.asarray(u_loc))))
        derr = abs(float(err) - float(err_loc))
        ok = du < 1e-4 and derr < 1e-4
        print(f"PARITY pid={pid} max|du|={du:.3e} |derr|={derr:.3e} ok={ok}", flush=True)
        if not ok:
            sys.exit(3)

    if pid == 0:
        print(json.dumps({
            "metric": f"solves_per_sec[multihost_{jax.process_count()}proc_{n_dev}dev_B{B}_{args.backend}]",
            "value": round(sps, 1), "unit": "solves/s",
            "mean_tracking_err_m": round(float(err), 4),
        }))


if __name__ == "__main__":
    main()
