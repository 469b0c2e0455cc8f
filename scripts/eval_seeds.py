"""Multi-seed GP-MPC learning evaluation: S independent learning runs on-device.

Statistical counterpart of scripts/run_gp_mpc.py: where the reference driver
(and its ancestor, /root/reference/scripts/run_gp_mpc.py) evaluates learning on
ONE seed per process, this script runs S full learning cycles (collect ->
sample -> accumulate -> GP refit -> held-out eval) in parallel as vmapped jitted
programs (gpmpc_tpu/parallel/sweep.py) and reports the learning curve as a
mean +/- std band across seeds, with per-seed improvement statistics.

Family-generic since round 5 (verdict item 5): `--model quadrotor|cartpole|
twolink` selects the plant family; everything model-specific (env module,
GPMPC hyperparameters, residual structure) comes from the FAMILIES table
below, whose controller settings mirror the single-seed learning thresholds in
tests/test_learning_loop.py. The quadrotor keeps its reference-schema YAML
config; the other families use their test-proven settings.

Artifacts (in <save_dir>): learning_curve_seeds_<model>.png/csv.

Usage:
  python scripts/eval_seeds.py [--platform cpu|gpu] [--model quadrotor]
                               [--seeds 16] [--epochs 3] [--steps 160] [--fast]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None, help="jax platform override (cpu for local)")
    p.add_argument("--config", default=str(Path(__file__).parent / "gp_mpc_config.yaml"))
    p.add_argument(
        "--model", default="quadrotor", choices=["quadrotor", "cartpole", "twolink"],
        help="plant family (quadrotor = the reference's; others via the family registry)",
    )
    p.add_argument("--seeds", type=int, default=16, help="number of parallel learning runs")
    p.add_argument("--epochs", type=int, default=None, help="override epoch count")
    p.add_argument("--steps", type=int, default=None, help="override episode length")
    p.add_argument("--samples", type=int, default=None, help="override samples/epoch")
    p.add_argument("--master-seed", type=int, default=None, help="override master seed")
    p.add_argument("--fast", action="store_true", help="tiny shapes (smoke run)")
    p.add_argument(
        "--backend", default="auto", choices=["auto", "lanes", "xla"],
        help="controller-step backend for every episode, decided by "
        "parallel/batch.py::dispatch_decision: 'auto'/'lanes' solve the QPs in "
        "the Pallas kernel on a GPU (per-seed GP algebra runs vmapped under "
        "XLA) and take the XLA path on the CPU",
    )
    return p.parse_args()


@dataclass
class FamilySetup:
    """Everything seed_sweep needs for one plant family."""

    env_mod: object
    env_params: object
    trajectory: object
    model: object
    n_steps: int
    n_epochs: int
    samples_per_epoch: int
    sparse: bool
    max_inducing: int
    ard: bool
    gp_iters: int
    gp_lr: float
    master_seed: int
    gpmpc_kwargs: dict = field(default_factory=dict)


def _quadrotor_setup(config, args) -> FamilySetup:
    """Reference family: settings from the reference-schema YAML config."""
    from gpmpc_tpu.envs import drone
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude

    g = config.gpmpc
    env = DroneFigureEightEnv()
    model = symbolic_attitude(dt=0.02, params=g.prior_params)
    n_epochs = config.run.num_epochs if args.epochs is None else args.epochs
    samples = config.train.samples_per_epoch if args.samples is None else args.samples
    cap = max(n_epochs * samples, 1)
    return FamilySetup(
        env_mod=drone, env_params=env.p, trajectory=env.trajectory, model=model,
        n_steps=env.p.n_steps, n_epochs=n_epochs, samples_per_epoch=samples,
        sparse=g.sparse_gp, max_inducing=g.max_gp_samples if g.sparse_gp else cap,
        ard=False, gp_iters=config.train.iterations, gp_lr=config.train.lr,
        master_seed=config.seed,
        gpmpc_kwargs=dict(
            prior_params=g.prior_params, horizon=g.horizon, q_mpc=g.q_mpc,
            r_mpc=g.r_mpc, sparse_gp=g.sparse_gp, prob=g.prob,
            max_gp_samples=g.max_gp_samples, sqp_iters=g.sqp_iters,
            qp_iters=g.qp_iters, soft_constraints=g.soft_constraints,
        ),
    )


def _cartpole_setup(config, args) -> FamilySetup:
    """Second family; controller settings mirror tests/test_learning_loop.py."""
    from gpmpc_tpu.envs import cartpole_env
    from gpmpc_tpu.models import cartpole

    envp = cartpole_env.EnvParams.default()._replace(
        n_steps=80, traj_period_steps=300, force_bias=2.5, gain=0.85
    )
    env = cartpole_env.CartpoleTrackEnv(envp)
    model = cartpole.symbolic_cartpole(dt=0.02)
    n_epochs = 3 if args.epochs is None else args.epochs
    samples = 26 if args.samples is None else args.samples
    return FamilySetup(
        env_mod=cartpole_env, env_params=envp, trajectory=env.trajectory,
        model=model, n_steps=envp.n_steps, n_epochs=n_epochs,
        samples_per_epoch=samples, sparse=True, max_inducing=30, ard=False,
        gp_iters=config.train.iterations, gp_lr=0.05, master_seed=config.seed,
        gpmpc_kwargs=dict(
            prior_params=None, horizon=20, q_mpc=[5.0, 0.1, 20.0, 0.5],
            r_mpc=[0.05], sparse_gp=True, max_gp_samples=30,
            sqp_iters=5, qp_iters=8,
            bounds=(cartpole.state_bounds(), cartpole.input_bounds()),
        ),
    )


def _twolink_setup(config, args) -> FamilySetup:
    """Third family (exact ARD GPs + LM damping), per tests/test_learning_loop.py."""
    from gpmpc_tpu.envs import twolink_env
    from gpmpc_tpu.models import twolink

    envp = twolink_env.EnvParams.default()
    env = twolink_env.TwoLinkTrackEnv(envp)
    model = twolink.symbolic_twolink(dt=0.02)
    n_epochs = 4 if args.epochs is None else args.epochs
    samples = 75 if args.samples is None else args.samples
    cap = max(n_epochs * samples, 1)
    return FamilySetup(
        env_mod=twolink_env, env_params=envp, trajectory=env.trajectory,
        model=model, n_steps=150, n_epochs=n_epochs, samples_per_epoch=samples,
        sparse=False, max_inducing=cap, ard=True,
        gp_iters=config.train.iterations, gp_lr=0.05, master_seed=config.seed,
        gpmpc_kwargs=dict(
            prior_params=None, horizon=20, q_mpc=[20.0, 20.0, 0.5, 0.5],
            r_mpc=[0.1, 0.1], sparse_gp=False, max_gp_samples=40,
            sqp_iters=8, qp_iters=10, ard_gp=True, lm_reg=0.5,
            bounds=(twolink.state_bounds(), twolink.input_bounds()),
        ),
    )


FAMILIES = {
    "quadrotor": _quadrotor_setup,
    "cartpole": _cartpole_setup,
    "twolink": _twolink_setup,
}


def main():
    args = parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import numpy as np

    from gpmpc_tpu.config import load_config
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.parallel.sweep import seed_sweep
    from gpmpc_tpu.utils.plotting import plot_learning_curve_band

    config = load_config(args.config)
    fam = FAMILIES[args.model](config, args)
    if args.master_seed is not None:
        fam.master_seed = args.master_seed
    if args.steps is not None:
        fam.n_steps = args.steps
    if args.fast:
        fam.n_steps = min(fam.n_steps, 60)
        fam.samples_per_epoch = min(fam.samples_per_epoch, fam.n_steps)
        fam.gp_iters, fam.gp_lr = 50, 0.05

    cap = max(fam.n_epochs * fam.samples_per_epoch, 1)
    ctrl = GPMPC(
        fam.model, fam.trajectory, seed=fam.master_seed, max_gp_points=cap,
        **fam.gpmpc_kwargs,
    )

    from gpmpc_tpu.parallel.batch import dispatch_decision

    backend = dispatch_decision(args.backend).path
    print(f"seed sweep [{args.model}]: {args.seeds} seeds x {fam.n_epochs} epochs "
          f"x {fam.n_steps} steps ({fam.samples_per_epoch} samples/epoch, "
          f"{fam.gp_iters} GP iters, backend={backend})")
    t0 = time.perf_counter()
    res = seed_sweep(
        fam.model, ctrl.cfg, fam.env_params, ctrl.consts,
        n_seeds=args.seeds, n_epochs=fam.n_epochs, n_steps=fam.n_steps,
        samples_per_epoch=fam.samples_per_epoch,
        max_inducing=min(fam.max_inducing, cap),
        sparse=fam.sparse, ard=fam.ard, gp_iters=fam.gp_iters, gp_lr=fam.gp_lr,
        master_seed=fam.master_seed, env_mod=fam.env_mod, backend=backend,
    )
    costs = np.asarray(jax.device_get(res.costs))  # (n_epochs+1, S)
    wall = time.perf_counter() - t0
    episodes = args.seeds * (2 * fam.n_epochs + 1)  # collect + eval per epoch, + baseline
    print(f"done in {wall:.1f} s ({episodes} episodes, "
          f"{episodes * fam.n_steps / wall:.0f} closed-loop GP-MPC steps/s incl. GP refits)")

    rmse = np.sqrt(costs / fam.n_steps)  # per-step tracking RMSE, interpretable units
    # A destabilized seed overflows its episode to non-finite cost (a real
    # closed-loop divergence, not a numerics bug — e.g. a GP extrapolating
    # off-manifold can destabilize the mismatched plant). Report divergences
    # explicitly instead of letting one NaN poison every aggregate.
    print("\nepoch | tracking RMSE: mean +/- std (min .. max over finite seeds)")
    for e in range(costs.shape[0]):
        r = rmse[e][np.isfinite(rmse[e])]
        tag = "prior" if e == 0 else f"  {e:3d}"
        div = args.seeds - r.size
        note = f"  [{div} diverged]" if div else ""
        if r.size:
            print(f" {tag} | {r.mean():.4f} +/- {r.std():.4f} "
                  f"({r.min():.4f} .. {r.max():.4f}){note}")
        else:
            print(f" {tag} | all seeds diverged")

    ok = np.isfinite(rmse[0]) & np.isfinite(rmse[-1])
    improved = ok & (rmse[-1] < rmse[0])
    n_div = int((~np.isfinite(rmse[-1])).sum())
    reduction = 1.0 - rmse[-1][ok] / rmse[0][ok]
    print(f"\nseeds improved over prior: {improved.sum()}/{args.seeds}"
          + (f" ({n_div} diverged)" if n_div else "")
          + (f" (mean RMSE reduction {100 * reduction.mean():.1f}% over finite seeds)"
             if ok.any() else ""))

    save_dir = Path(config.save_dir)
    name = f"learning_curve_seeds_{args.model}"
    plot_learning_curve_band(costs, np.asarray(res.n_points), name, save_dir)
    print(f"artifacts: {save_dir}/{name}.png/.csv")


if __name__ == "__main__":
    main()
