"""Closed-loop step time per path, and where the device time of a step goes.

For each requested path (`lanes` = the Pallas QP kernel, `xla` = vmapped
select_action), times chained closed-loop steps (controller + plant) at one
cell, ending each window with `block_until_ready`. With --trace, records a
`jax.profiler` trace of a few kernel-path steps and sums the device time of
every op by the named scope it ran under (gp_variance, tightening, linearize,
qp_kernel; everything else is "other").

    python scripts/bench_step_breakdown.py --batch 1024 --horizon 25 --trace /tmp/tr

Prints one JSON line per path and, with --trace, one line of scope totals.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SCOPES = ("gp_variance", "tightening", "linearize", "qp_kernel")


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the op_name metadata it was built from (which
    carries the jax.named_scope path), from a compiled module's text."""
    out = {}
    for m in re.finditer(r'%?([\w.\-]+) = [^\n]*?op_name="([^"]+)"', hlo_text):
        out[m.group(1)] = m.group(2)
        # GPU kernel events spell "input_reduce_fusion.8" as "..._fusion_8"
        out.setdefault(m.group(1).replace(".", "_"), m.group(2))
    return out


def scope_of(event, names: dict) -> str:
    """The named scope a device op ran under: by its HLO instruction (the
    event's name or its hlo_op stat), else by any stat naming the scope. The
    QP kernel's events carry the kernel's own name (the pallas_call name)."""
    if "ocp_qp_ip" in event.name:
        return "qp_kernel"
    texts = [names.get(event.name, event.name)]
    for k, v in event.stats:
        texts.append(str(v))
        if k in ("hlo_op", "name") and str(v) in names:
            texts.append(names[str(v)])
    for s in SCOPES:
        if any(f"/{s}/" in t or t.endswith(f"/{s}") for t in texts):
            return s
    return "other"


def device_scope_times(trace_dir: str, hlo_text: str) -> dict:
    """Sum of device-op durations per named scope over the recorded window,
    plus the window's device busy time and its span."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    names = hlo_scopes(hlo_text)
    totals = defaultdict(float)
    other = defaultdict(float)  # unattributed device time by event name
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        # XLA's op line when the trace has one; the per-stream kernel lines
        # otherwise (they list the same kernels, so never both).
        lines = [l for l in plane.lines if l.name == "XLA Ops"] or [
            l for l in plane.lines if l.name.startswith("Stream")
        ]
        for line in lines:
            for ev in line.events:
                scope = scope_of(ev, names)
                totals[scope] += ev.duration_ns / 1e6
                if scope == "other":
                    other[ev.name[:80]] += ev.duration_ns / 1e6
                intervals.append((ev.start_ns, ev.end_ns))
    busy, span = 0.0, 0.0
    if intervals:
        intervals.sort()
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        span = intervals[-1][1] - intervals[0][0]
    return {
        "scope_ms": {k: round(v, 3) for k, v in sorted(totals.items())},
        "device_busy_ms": busy / 1e6, "window_span_ms": span / 1e6,
        "top_other_ms": dict(sorted(other.items(), key=lambda kv: -kv[1])[:8]),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", default="quadrotor")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--paths", default="lanes,xla")
    ap.add_argument("--trace", default=None, help="directory for a kernel-path trace")
    args = ap.parse_args()

    import jax

    from gpmpc_tpu.utils import parity
    from gpmpc_tpu.utils.benchkit import build_problem
    from gpmpc_tpu.parallel.batch import batched_gpmpc_step
    from gpmpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    problem = build_problem(args.family, horizon=args.horizon)
    model, ctrl, gp = problem.model, problem.ctrl, problem.gp
    env_p, env_step = problem.env_params, problem.env_step

    def make_step(path):
        def step(consts, gpm, env_states, ctrl_states, obs):
            u, ctrl_states, _ = batched_gpmpc_step(
                model, ctrl.cfg, consts, gpm, ctrl_states, obs, backend=path
            )
            env_states, obs, _, _, _ = jax.vmap(lambda s, a: env_step(env_p, s, a))(
                env_states, u
            )
            return env_states, ctrl_states, obs

        return jax.jit(step)

    for path in args.paths.split(","):
        step = make_step(path)
        carry = parity.initial_states(problem, args.batch)
        t0 = time.perf_counter()
        carry = step(ctrl.consts, gp, *carry)
        jax.block_until_ready(carry)
        compile_s = time.perf_counter() - t0
        carry = step(ctrl.consts, gp, *carry)  # into the warm-started regime
        jax.block_until_ready(carry)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            carry = step(ctrl.consts, gp, *carry)
        jax.block_until_ready(carry)
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        print(json.dumps({
            "path": path, "family": args.family, "batch": args.batch,
            "horizon": args.horizon, "ms_per_step": ms,
            "solves_per_s": args.batch / ms * 1e3, "first_call_s": compile_s,
            "device": {"platform": dev.platform, "kind": dev.device_kind},
        }), flush=True)
        if args.trace and path == "lanes":
            with jax.profiler.trace(args.trace):
                for _ in range(3):
                    carry = step(ctrl.consts, gp, *carry)
                jax.block_until_ready(carry)
            hlo = step.lower(ctrl.consts, gp, *carry).compile().as_text()
            print(json.dumps({"path": path, "trace_steps": 3,
                              **device_scope_times(args.trace, hlo)}), flush=True)


if __name__ == "__main__":
    main()
