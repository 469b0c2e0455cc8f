"""GP-MPC experiment driver.

≙ /root/reference/scripts/run_gp_mpc.py:22-215: the epoch loop
(prior rollout -> sample -> preprocess -> accumulate -> train GP -> test -> collect)
with per-step inference timing, epoch timing table, plot bundle, and a final
evaluation on a fresh seed. Differences are architectural: the env is the
in-repo jitted simulator (no JaxToNumpy bridge, no quat flattening needed — the env
observes the canonical 12-state directly), and retraining the GP never recompiles
the controller (padded GP buffers; see control/gpmpc.py).

Usage:
  python scripts/run_gp_mpc.py [--platform cpu|gpu] [--fast] [--config PATH]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None, help="JAX platform override (cpu or gpu; default: JAX's choice)")
    p.add_argument("--fast", action="store_true", help="short episodes / few iters (smoke run)")
    p.add_argument("--config", default=str(Path(__file__).parent / "gp_mpc_config.yaml"))
    p.add_argument(
        "--checkpoint-dir", default=None,
        help="save per-epoch checkpoints here and resume from the latest on restart",
    )
    p.add_argument("--epochs", type=int, default=None, help="override run.num_epochs")
    p.add_argument("--steps", type=int, default=None, help="override episode length")
    p.add_argument(
        "--profile", action="store_true",
        help="capture a jax.profiler device trace of the final evaluation "
        "(written to <save_dir>/trace, viewable in TensorBoard/xprof)",
    )
    return p.parse_args()


def run_evaluation(env, ctrl, seed: int, n_steps: int) -> dict:
    """One evaluation episode with per-step inference timing.

    ≙ run_evaluation, run_gp_mpc.py:42-72, plus a populated `controller_data`
    field: the reference declares it but appends nothing (run_gp_mpc.py:51,70);
    here it carries real per-step solver diagnostics (SQP step norm, final QP
    complementarity gap, SQP iteration count) from the controller's last solve.
    """
    import numpy as np

    episode_data = defaultdict(list)
    ctrl_data = defaultdict(list)
    ctrl.reset()
    obs, _ = env.reset(seed=seed)
    episode_data["obs"].append(np.asarray(obs))
    inference_time_data = []

    for _ in range(n_steps):
        t0 = time.perf_counter()
        action = ctrl.select_action(obs)
        inference_time_data.append(time.perf_counter() - t0)
        info = getattr(ctrl, "_last_info", None)
        if info is not None:
            ctrl_data["step_norm"].append(float(info.step_norm))
            ctrl_data["qp_gap"].append(float(info.qp_gap))
            ctrl_data["n_iters"].append(int(info.n_iters))
            if hasattr(info, "clamp_frac"):
                ctrl_data["tightening_clamp_frac"].append(float(info.clamp_frac))
        obs, reward, terminated, truncated, _ = env.step(action)
        step_data = {
            "obs": np.asarray(obs), "action": np.asarray(action),
            "done": terminated or truncated, "reward": float(reward), "length": 1,
        }
        for key, val in step_data.items():
            episode_data[key].append(val)
        if terminated or truncated:
            break
    out = {k: np.array(v) for k, v in episode_data.items()}
    out["controller_data"] = {k: np.asarray(v) for k, v in ctrl_data.items()}
    out["inference_time_data"] = inference_time_data
    return out


def sample_data(data, n_samples: int, rng):
    """Uniform-without-replacement transition sampling. ≙ run_gp_mpc.py:75-83."""
    import numpy as np

    n = data["action"].shape[0]
    idx = rng.choice(n - 1, n_samples, replace=False) if n_samples < n else np.arange(n - 1)
    obs = np.asarray(data["obs"])
    actions = np.asarray(data["action"])
    return obs[idx], actions[idx], obs[idx + 1]


def episode_seed_plan(seed: int, n_epochs: int):
    """Derive (rng, eval_seed, per-epoch episode seeds) from the master seed.

    Contract (the reference's reproducibility goal, run_gp_mpc.py:98-105):
    epoch k's seed depends on the master seed alone, never on n_epochs, and all
    epoch seeds are distinct. The reference pre-draws a fixed 1e6-entry
    without-replacement table and truncates it; here the same contract costs
    O(n_epochs) and extends past 1e6 epochs: epoch seeds are an affine
    bijection k -> (a*k + b) mod 2**31 with a seed-derived odd multiplier
    (invertible mod a power of two, so distinctness is structural).
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    int32_max = np.iinfo(np.int32).max
    eval_seed = int(rng.integers(int32_max))
    mult = (int(rng.integers(1 << 30)) << 1) | 1  # odd => bijective mod 2**31
    offset = int(rng.integers(1 << 31))
    k = np.arange(n_epochs + 1, dtype=np.uint64)
    table = ((mult * k + offset) % (1 << 31)).astype(np.int64)
    return rng, eval_seed, table


def learn(
    n_epochs, ctrl, env, lr, gp_iterations, seed, samples_per_epoch, n_steps,
    checkpoint_dir=None,
):
    """Multi-epoch learning loop. ≙ learn, run_gp_mpc.py:86-137.

    With `checkpoint_dir`, the accumulated GP dataset + trained GP state are
    checkpointed after every epoch (the reference persists nothing, SURVEY.md §5);
    an interrupted run resumes from the latest epoch.
    """
    import numpy as np

    from gpmpc_tpu.utils.checkpoint import ExperimentCheckpoint
    from gpmpc_tpu.utils.profiling import PhaseTimer

    train_runs, test_runs = {}, {}
    rng, eval_seed, epoch_seeds = episode_seed_plan(seed, n_epochs)

    ckpt = ExperimentCheckpoint(checkpoint_dir) if checkpoint_dir else None
    start_epoch = 1
    x_train, y_train = np.zeros((0, 7)), np.zeros((0, 3))
    resumed = False
    if ckpt is not None and (latest := ckpt.latest_epoch()) is not None:
        # Restores the GP state, accumulated dataset, all completed episode runs,
        # and the exact numpy RNG state — bit-exact continuation.
        x_train, y_train, tr_saved, te_saved = ckpt.restore(latest, ctrl, rng=rng)
        if tr_saved is not None:
            train_runs.update(tr_saved)
        if te_saved is not None:
            test_runs.update(te_saved)
        resumed = tr_saved is not None and (latest in tr_saved) and 0 in tr_saved
        if resumed:
            start_epoch = latest + 1
            print(f"resumed from checkpoint epoch {latest} ({x_train.shape[0]} samples)")
        else:  # runs missing (old/partial checkpoint): restart cleanly
            import jax as _jax

            from gpmpc_tpu.control.gpmpc import empty_gp_model

            # Undo the partial restore so the restart is bit-identical to a
            # fresh run with the same seed.
            ctrl.gp_model = empty_gp_model(
                ctrl.max_gp_points,
                ctrl.max_gp_samples if ctrl.sparse else ctrl.max_gp_points,
                ard=ctrl.ard_gp,
            )
            ctrl._gp_key = _jax.random.PRNGKey(seed)
            x_train, y_train = np.zeros((0, 7)), np.zeros((0, 3))
            rng, eval_seed, epoch_seeds = episode_seed_plan(seed, n_epochs)
            print("checkpoint incomplete; restarting from epoch 1")

    if not resumed:
        train_runs[0] = run_evaluation(env, ctrl.prior_ctrl, int(epoch_seeds[0]), n_steps)
        test_runs[0] = run_evaluation(env, ctrl.prior_ctrl, eval_seed, n_steps)

    try:  # epoch progress bar (≙ run_gp_mpc.py:107,135); plain loop if absent
        from tqdm import tqdm
    except ImportError:
        tqdm = None
    progress = tqdm(total=n_epochs, initial=start_epoch - 1,
                    desc="GP-MPC", dynamic_ncols=True) if tqdm else None

    for epoch in range(start_epoch, n_epochs + 1):
        timer = PhaseTimer()
        state, actions, next_state = sample_data(train_runs[epoch - 1], samples_per_epoch, rng)
        inputs, targets = ctrl.preprocess_data(state, actions, next_state)
        x_train = np.vstack((x_train, inputs))
        y_train = np.vstack((y_train, targets))
        with timer.phase("Train GP"):
            ctrl.train_gp(x=x_train, y=y_train, lr=lr, iterations=gp_iterations)
        with timer.phase("Test GPMPC Performance"):
            test_runs[epoch] = run_evaluation(env, ctrl, eval_seed, n_steps)
        with timer.phase("Collect GP Data"):
            train_runs[epoch] = run_evaluation(env, ctrl, int(epoch_seeds[epoch]), n_steps)
        if ckpt is not None:
            ckpt.save(
                epoch, ctrl, x_train, y_train,
                rng=rng, train_runs=train_runs, test_runs=test_runs,
            )
        # Per-epoch phase timing report (the reference prints an equivalent
        # three-row wall-clock table after each epoch, run_gp_mpc.py:128-134).
        print(f"\n[epoch {epoch}] phase wall times:")
        for phase, samples in timer.samples.items():
            print(f"  {phase}: {sum(samples):.2f} s")
        if progress is not None:
            progress.update(1)
    if progress is not None:
        progress.close()
    return train_runs, test_runs


def run():
    """Experiment main. ≙ run, run_gp_mpc.py:140-189."""
    args = parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import numpy as np

    from gpmpc_tpu.config import load_config
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude
    from gpmpc_tpu.utils.plotting import make_quad_plots, plot_quad_eval

    config = load_config(args.config)
    g = config.gpmpc

    prior_model = symbolic_attitude(dt=0.02, params=g.prior_params)
    env = DroneFigureEightEnv()
    traj = env.trajectory
    n_steps = env.p.n_steps if not args.fast else 80
    gp_iterations = config.train.iterations if not args.fast else 100
    lr = config.train.lr if not args.fast else 0.05
    if args.steps is not None:
        n_steps = args.steps
    n_epochs = config.run.num_epochs if args.epochs is None else args.epochs

    ctrl = GPMPC(
        prior_model,
        traj=traj,
        prior_params=g.prior_params,
        horizon=g.horizon,
        q_mpc=g.q_mpc,
        r_mpc=g.r_mpc,
        sparse_gp=g.sparse_gp,
        prob=g.prob,
        max_gp_samples=g.max_gp_samples,
        seed=config.seed,
        device=g.device,
        output_dir=Path(config.save_dir),
        max_gp_points=g.max_gp_points,
        sqp_iters=g.sqp_iters,
        qp_iters=g.qp_iters,
        parallel_scan=g.parallel_scan,
        soft_constraints=g.soft_constraints,
        lm_reg=g.lm_reg,
        step_backend=g.step_backend,
    )

    train_runs, test_runs = learn(
        n_epochs=n_epochs,
        ctrl=ctrl,
        env=env,
        lr=lr,
        gp_iterations=gp_iterations,
        seed=config.seed,
        samples_per_epoch=config.train.samples_per_epoch,
        n_steps=n_steps,
        checkpoint_dir=(Path(args.checkpoint_dir) if args.checkpoint_dir else None),
    )

    make_quad_plots(
        test_runs=test_runs,
        train_runs=train_runs,
        trajectory=np.asarray(ctrl.traj),
        save_dir=Path(config.save_dir),
    )
    import contextlib

    if args.profile:
        from gpmpc_tpu.utils.profiling import device_trace

        trace_ctx = device_trace(Path(config.save_dir) / "trace")
    else:
        trace_ctx = contextlib.nullcontext()
    with trace_ctx:
        trajs_data = run_evaluation(env, ctrl, seed=config.seed + 1, n_steps=n_steps)
    env.close()
    plot_quad_eval(trajs_data, np.asarray(traj).T, prior_model.dt, Path(config.save_dir))

    # Summary line for quick health checks. The reference trajectory is periodic;
    # obs has one more row (initial state) than steps, so index modulo the period.
    traj_np = np.asarray(traj)
    for epoch in sorted(test_runs):
        obs = test_runs[epoch]["obs"]
        ref = traj_np[np.arange(obs.shape[0]) % traj_np.shape[0]]
        err = np.sqrt(
            (obs[:, 0] - ref[:, 0]) ** 2 + (obs[:, 2] - ref[:, 2]) ** 2 + (obs[:, 4] - ref[:, 4]) ** 2
        )
        print(f"epoch {epoch}: mean position error {err.mean():.4f} m")
    print(f"results in {config.save_dir}")


if __name__ == "__main__":
    _t0 = time.perf_counter()
    run()
    print(f"total experiment wall time: {time.perf_counter() - _t0:.2f} s")
