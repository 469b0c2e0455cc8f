"""Multi-seed GP-MPC learning sweep: S independent learning runs as ONE program.

The reference evaluates learning statistically by re-running its whole driver
process per seed (sequential: episode loop -> GPyTorch fit -> acados recompile,
per seed). Here the *entire* learning cycle — closed-loop data collection,
transition sampling, dataset accumulation, GP ensemble refit, and the held-out
evaluation episode — is pure jnp, so S seeds run as one vmapped, jitted program
per epoch on one device: every seed's episodes batch into the same scanned XLA
program (`parallel/batch.py::batched_episode(gp_batched=True)`), and every
seed's 3-GP ensemble trains inside one `vmap(train_gp_models)`.

Epoch semantics mirror the reference driver (run_gp_mpc.py:86-137): each epoch
collects one episode with the current controller (epoch 1 uses the untrained
GP, whose zero posterior mean IS the prior controller — control/gpmpc.py:651),
samples `samples_per_epoch` transitions uniformly without replacement,
accumulates them, refits the GPs on everything seen so far, and scores a fixed
per-seed held-out evaluation episode. Row 0 of the returned cost matrix is the
prior controller's baseline on the same evaluation keys.

One jit covers all epochs: the write offset into the padded dataset buffer and
the active-row mask are functions of a *traced* epoch index
(`lax.dynamic_update_slice` + `arange < count`), so growing the dataset never
changes shapes — the same no-recompile invariant the controller itself holds.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpmpc_tpu.control.gpmpc import (
    GpModel,
    GpMpcConsts,
    empty_gp_model,
    model_spec,
    pack_training_buffers,
    train_gp_models,
)
from gpmpc_tpu.envs import drone
from gpmpc_tpu.models.symbolic import SymbolicModel
from gpmpc_tpu.ops.sqp import SqpConfig
from gpmpc_tpu.parallel.batch import batched_episode


class SweepResult(NamedTuple):
    costs: jax.Array  # (n_epochs+1, S) cumulative squared position error per eval episode
    n_points: jax.Array  # (n_epochs+1,) training-set size at each row
    gp: GpModel  # final per-seed GP ensembles (leaves lead with S)


def seed_sweep(
    model: SymbolicModel,
    cfg: SqpConfig,
    env_params,
    consts: GpMpcConsts,
    prior_params: dict | None = None,
    *,
    n_seeds: int,
    n_epochs: int,
    n_steps: int,
    samples_per_epoch: int,
    max_inducing: int,
    sparse: bool = True,
    ard: bool = False,
    gp_iters: int = 100,
    gp_lr: float = 0.05,
    master_seed: int = 0,
    mesh=None,
    env_mod=drone,
    backend: str = "xla",
) -> SweepResult:
    """Run `n_seeds` independent GP-MPC learning runs in parallel on-device.

    Model-agnostic: residual structure (GP inputs, target preprocessing, buffer
    widths) comes from the model's ResidualSpec, and `env_mod` selects the
    plant family (envs/drone.py surface; see parallel/batch.py::batched_episode).
    `prior_params` is accepted for API compatibility but unused — the thrust
    map now rides the spec's own make_targets (the model's prior parameters).

    backend takes the path of parallel/batch.py::dispatch_decision: on a GPU
    every episode's QPs go through the Pallas QP kernel (per-seed GP algebra
    runs vmapped under XLA).

    With `mesh` (a 1-D `jax.sharding.Mesh`), the seed axis is sharded over the
    mesh's devices: every per-seed leaf (GP ensemble, dataset buffer, keys)
    lives shard-local, the epoch program runs SPMD with zero cross-seed
    communication (seeds are independent by construction, so XLA inserts no
    collectives on the hot path), and `n_seeds` must divide by the mesh size.
    """
    if samples_per_epoch > n_steps:
        raise ValueError(
            f"samples_per_epoch={samples_per_epoch} > n_steps={n_steps}: an "
            "episode yields n_steps transitions to sample without replacement"
        )
    cap = n_epochs * samples_per_epoch
    max_inducing = min(max_inducing, cap)  # can't induce more points than exist
    spec = model_spec(model)

    root = jax.random.PRNGKey(master_seed)
    seed_keys = jax.random.split(root, n_seeds)  # (S, 2)
    # Per-seed: a fixed evaluation key (same held-out episode every epoch, the
    # reference's eval_seed contract) and an epoch-key chain for collection.
    eval_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(seed_keys)

    # Multi-process meshes forbid CLOSING OVER global arrays (they span
    # non-addressable devices), so the per-seed key tables are explicit
    # arguments of every jitted function here.
    def eval_cost(gp, eval_keys, gp_batched):
        ep = batched_episode(
            model, cfg, env_params, consts, gp, eval_keys, n_steps,
            use_gp=True, gp_batched=gp_batched, env_mod=env_mod, backend=backend,
        )
        return -ep.rewards.sum(axis=-1)  # (S,)

    def epoch_step(epoch_idx, gp, bufx, bufy, seed_keys, eval_keys):
        # 1. Data-parallel collection: each seed one closed-loop episode with
        #    its own current GP (untrained GP -> prior controller).
        collect_keys = jax.vmap(
            lambda k: jax.random.fold_in(jax.random.fold_in(k, 1), epoch_idx)
        )(seed_keys)
        ep = batched_episode(
            model, cfg, env_params, consts, gp, collect_keys, n_steps,
            use_gp=True, gp_batched=True, env_mod=env_mod, backend=backend,
        )

        # 2. Per-seed transition sampling + residual-target preprocessing +
        #    accumulation into the padded dataset buffer.
        def accumulate(obs, actions, key, bx, by):
            idx = jax.random.choice(key, n_steps, (samples_per_epoch,), replace=False)
            x, u, x_next = obs[idx], actions[idx], obs[idx + 1]
            xi, ti = spec.make_targets(model, x, u, x_next)
            start = epoch_idx * samples_per_epoch
            bx = jax.lax.dynamic_update_slice(bx, xi.astype(bx.dtype), (start, 0))
            by = jax.lax.dynamic_update_slice(by, ti.astype(by.dtype), (start, 0))
            return bx, by

        sample_keys = jax.vmap(
            lambda k: jax.random.fold_in(jax.random.fold_in(k, 2), epoch_idx)
        )(seed_keys)
        bufx, bufy = jax.vmap(accumulate)(ep.obs, ep.actions, sample_keys, bufx, bufy)

        # 3. Refit every seed's GP ensemble on its accumulated dataset.
        n_active = (epoch_idx + 1) * samples_per_epoch

        def refit(bx, by, key):
            return train_gp_models(
                pack_training_buffers(bx, by, n_active, spec), key,
                sparse=sparse, max_inducing=max_inducing,
                n_train=gp_iters, lr=gp_lr, ard=ard,
            )

        fit_keys = jax.vmap(
            lambda k: jax.random.fold_in(jax.random.fold_in(k, 3), epoch_idx)
        )(seed_keys)
        gp = jax.vmap(refit)(bufx, bufy, fit_keys)

        # 4. Held-out evaluation with the refit controllers.
        cost = eval_cost(gp, eval_keys, gp_batched=True)
        return gp, bufx, bufy, cost

    gp0 = empty_gp_model(cap, max_inducing if sparse else cap, ard=ard, spec=spec)
    prior_cost = jax.jit(partial(eval_cost, gp_batched=False))(gp0, eval_keys)

    bufx = jnp.zeros((n_seeds, cap, spec.z_dim), jnp.float32)
    bufy = jnp.zeros((n_seeds, cap, spec.num_gps), jnp.float32)
    gp = jax.tree.map(lambda l: jnp.broadcast_to(l[None], (n_seeds,) + l.shape), gp0)

    if mesh is not None:
        import numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P

        if n_seeds % mesh.size != 0:
            raise ValueError(f"n_seeds={n_seeds} must divide over {mesh.size} devices")
        # Every per-seed leaf (incl. the broadcast `trained` flag) has a leading
        # seed axis; committing the operands is enough — jit propagates the
        # shardings through the SPMD epoch program, no annotations needed.
        # make_array_from_callback (not device_put): when the mesh spans
        # multiple PROCESSES (scripts/run_multihost.py --sweep), each process
        # may only place its own addressable shards — device_put onto
        # non-addressable devices is illegal; the callback form assembles the
        # global array shard-by-shard and is equivalent single-process.
        seeded = NamedSharding(mesh, P(mesh.axis_names[0]))

        def shard(t):
            def _mk(leaf):
                host = np.asarray(leaf)
                return jax.make_array_from_callback(
                    host.shape, seeded, lambda idx: host[idx]
                )

            return jax.tree.map(_mk, t)

        gp, bufx, bufy = shard(gp), shard(bufx), shard(bufy)
        seed_keys, eval_keys = shard(seed_keys), shard(eval_keys)
        # The prior row was computed process-locally (before sharding);
        # globalize it replicated so the final stack is a pure-global op —
        # multi-process jax forbids mixing host-local and global operands.
        repl = NamedSharding(mesh, P())
        host_prior = np.asarray(prior_cost)
        prior_cost = jax.make_array_from_callback(
            host_prior.shape, repl, lambda idx: host_prior[idx]
        )

    step = jax.jit(epoch_step)  # one compile for ALL epochs (traced epoch_idx)
    costs = [prior_cost]
    for e in range(n_epochs):
        gp, bufx, bufy, cost = step(jnp.asarray(e), gp, bufx, bufy, seed_keys, eval_keys)
        costs.append(cost)

    n_points = jnp.arange(n_epochs + 1) * samples_per_epoch
    return SweepResult(costs=jnp.stack(costs), n_points=n_points, gp=gp)
