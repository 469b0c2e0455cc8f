"""GP training-time benchmark at production dataset scale (round-5 verdict #7).

The reference trains its GPs as a first-class timed phase
(/root/reference/scripts/run_gp_mpc.py:119-134) at N<=45 points; BASELINE
config 4 scales serving to a 5,120-point GP. This script times `fit_gp` — a
full Cholesky of the masked (N, N) Gram per Adam iteration — across dataset
sizes up to that scale on the attached device, and prints per-iteration cost
plus the projected config-default (500-iteration) fit time, one JSON line per
size.

Usage:
  python scripts/bench_gp_fit.py [--platform cpu] [--sizes 320,1280,5120]
                                 [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None)
    p.add_argument("--sizes", default="320,1280,5120")
    p.add_argument("--iters", type=int, default=20,
                   help="timed Adam iterations (per-iteration cost is flat, so "
                   "a short run projects the 500-iteration default)")
    args = p.parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpmpc_tpu.gp.exact_gp import GPData, fit_gp

    sizes = [int(s) for s in args.sizes.split(",")]
    rng = np.random.default_rng(0)
    for n in sizes:
        # Smooth synthetic residual surface, same 7-d input width as the
        # quadrotor ensemble's widest slice.
        x = rng.normal(0.0, 0.5, (n, 7)).astype(np.float32)
        y = (np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.normal(size=n)).astype(
            np.float32
        )
        data = GPData(
            x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.ones((n,), jnp.float32)
        )
        fit = jax.jit(lambda d: fit_gp(d, n_train=args.iters, lr=0.01))
        # fetching the scalar loss forces the whole fit
        t0 = time.perf_counter()
        loss = jax.device_get(fit(data)[1])
        compile_and_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss = jax.device_get(fit(data)[1])
        warm = time.perf_counter() - t0
        per_iter_ms = 1e3 * warm / args.iters
        print(json.dumps({
            "metric": f"gp_fit[N={n}]",
            "value": round(per_iter_ms, 3),
            "unit": "ms/iteration",
            "iters_timed": args.iters,
            "warm_wall_s": round(warm, 3),
            "compile_plus_first_s": round(compile_and_first, 3),
            "projected_500_iter_s": round(0.5 * per_iter_ms, 3),
            "final_loss": round(float(loss), 5),
            "finite": bool(np.isfinite(float(loss))),
        }), flush=True)


if __name__ == "__main__":
    main()
