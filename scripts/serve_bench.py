"""Serving-throughput benchmark for the micro-batching control server.

Spawns C client threads, each an independent control session replaying a
realistic observation stream (recorded from one batched closed-loop episode),
and measures served actions/s end-to-end through the dynamic-batching
dispatcher (gpmpc_tpu/runtime/server.py). Prints one JSON line.

Usage:
  python scripts/serve_bench.py [--clients 64] [--steps 50] [--tile 128]
                                [--backend auto|lanes|xla] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None)
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--tile", type=int, default=128)
    p.add_argument("--backend", default="auto")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--pipeline", type=int, default=2, help="in-flight batch depth")
    p.add_argument(
        "--actions-per-step", type=int, default=1,
        help="N-step action-horizon replies: each request returns the first N "
        "actions of the plan and the client comes back after N plant steps — "
        "amortizes the per-request round-trip over N actions",
    )
    args = p.parse_args()
    if args.clients > args.tile:
        p.error(f"--clients {args.clients} > --tile {args.tile}: sessions are tile slots")
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import numpy as np

    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude
    from gpmpc_tpu.parallel.batch import batched_episode
    from gpmpc_tpu.runtime.server import ControlServer
    from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict

    prior = reference_prior_dict()
    env = DroneFigureEightEnv()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(
        model, env.trajectory, prior, horizon=25, q_mpc=Q_MPC, r_mpc=R_MPC,
        sparse_gp=True, max_gp_samples=40, seed=1, sqp_iters=6, qp_iters=10,
    )
    rng = np.random.default_rng(0)
    ctrl.train_gp(
        rng.normal(0, 0.3, (40, 7)).astype(np.float32),
        rng.normal(0, 0.3, (40, 3)).astype(np.float32),
        lr=0.05, iterations=50,
    )

    # Realistic per-client observation streams: one batched closed-loop episode.
    # Cap the recording batch; clients beyond it replay a stream modulo (the
    # serving path doesn't care whether two clients fly the same trajectory).
    n_streams = min(args.clients, 64)
    keys = jax.random.split(jax.random.PRNGKey(0), n_streams)
    ep = batched_episode(
        model, ctrl.cfg, env.p, ctrl.consts, ctrl.gp_model, keys, args.steps,
        use_gp=True,
    )
    obs_streams = np.asarray(jax.device_get(ep.obs))  # (n_streams, steps+1, 12)
    nu = model.nu

    n_act = args.actions_per_step
    server = ControlServer(
        model, ctrl.cfg, ctrl.consts, ctrl.gp_model,
        tile=args.tile, backend=args.backend, max_wait_ms=args.max_wait_ms,
        pipeline_depth=args.pipeline, actions_per_step=n_act,
    )
    barrier = threading.Barrier(args.clients + 1)

    lat_lock = threading.Lock()
    latencies_ms: list[float] = []

    def client(i):
        sid = server.open_session()
        stream = obs_streams[i % len(obs_streams)]
        local: list[float] = []
        barrier.wait()  # start together (also absorbs the first-compile cost)
        # With N-step replies the client requests every N-th observation and
        # applies the returned plan head open-loop in between — one round-trip
        # per N control steps.
        for k in range(0, args.steps, n_act):
            t0 = time.perf_counter()
            u = server.step(sid, stream[k])
            local.append(1e3 * (time.perf_counter() - t0))
            assert np.all(np.isfinite(u))
            assert u.shape == ((nu,) if n_act == 1 else (n_act, nu))
        server.close_session(sid)
        with lat_lock:
            latencies_ms.extend(local)

    # Warm the compiled dispatch before timing.
    warm = server.open_session()
    server.step(warm, obs_streams[0, 0])
    server.close_session(warm)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(args.clients)]
    for t in threads:
        t.start()
    barrier.wait()
    s0 = server.stats
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    s1 = server.stats
    server.close()

    requests_per_client = len(range(0, args.steps, n_act))
    total = args.clients * requests_per_client * n_act  # actions delivered
    stats = type(s1)(s1.n_requests - s0.n_requests, s1.n_batches - s0.n_batches)
    lat = np.asarray(latencies_ms)
    out = {
        "metric": "served_actions_per_sec",
        "value": round(total / wall, 1),
        "unit": "actions/s",
        "clients": args.clients,
        "tile": args.tile,
        "backend": args.backend,
        "actions_per_step": n_act,
        "mean_batch_size": round(stats.mean_batch_size, 2),
        "n_batches": stats.n_batches,
        "mean_dispatch_ms": round(1e3 * wall / stats.n_batches, 3),
        # Per-request end-to-end latency (enqueue -> action in hand), the
        # number a control loop actually budgets against — not a projection.
        "latency_p50_ms": round(float(np.percentile(lat, 50)), 3),
        "latency_p95_ms": round(float(np.percentile(lat, 95)), 3),
        "latency_p99_ms": round(float(np.percentile(lat, 99)), 3),
    }
    if n_act > 1:
        # Amortized per-action latency: one round-trip buys N actions, so a
        # 50 Hz control loop budgets request_latency / N per applied action.
        out["effective_action_latency_p50_ms"] = round(
            float(np.percentile(lat, 50)) / n_act, 3
        )
        out["effective_action_latency_p95_ms"] = round(
            float(np.percentile(lat, 95)) / n_act, 3
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
