"""Scenario-batched GP-MPC: batched controller steps and fused on-device episodes.

A single controller solve works on 12x12/12x4 blocks, far too small to occupy
an accelerator, so throughput comes from solving thousands of scenarios at
once: on a GPU through the scenario-blocked Pallas QP kernel
(ops/pallas_ocp.py), on the CPU through `vmap` of the plain XLA step. The
scenario axis shards over a device mesh (`make_batched_controller_step`). The
reference has no counterpart (it solves one OCP per step through a ctypes
boundary, SURVEY.md §2.3).

`batched_episode` additionally fuses the env into the controller scan, so a whole
closed-loop episode (controller solve -> plant integration -> next obs) for B
scenarios runs as ONE XLA program with zero host round-trips — versus the
reference's per-step Python->C (acados) and JAX->numpy (JaxToNumpy) crossings.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpmpc_tpu.control import gpmpc as gpmpc_mod
from gpmpc_tpu.control import mpc as mpc_mod
from gpmpc_tpu.control.gpmpc import GpModel, GpMpcConsts
from gpmpc_tpu.control.mpc import MpcState
from gpmpc_tpu.envs import drone
from gpmpc_tpu.models.symbolic import SymbolicModel
from gpmpc_tpu.ops.sqp import SqpConfig


class DispatchDecision(NamedTuple):
    """Outcome of `dispatch_decision`: the path ("lanes" = the Pallas QP
    kernel, "xla" = vmapped `select_action`), why, whether the kernel runs in
    interpret mode, and whether the path is below what the caller asked for
    (`backend="lanes"` on a CPU without interpret mode), which warns once."""

    path: str
    reason: str
    interpret: bool = False
    degraded: bool = False


BACKENDS = ("auto", "lanes", "xla")


def dispatch_decision(
    backend: str = "auto",
    platform: str | None = None,
    interpret: bool = False,
    gp_batched: bool = False,
) -> DispatchDecision:
    """The one place that decides the step path from the platform.

    `batched_gpmpc_step`, `batched_episode`, `make_batched_controller_step`
    and `GPMPC` execute exactly this decision; `tests/test_dispatch.py`
    asserts every cell and the README dispatch matrix is generated from it
    (`scripts/gen_dispatch_table.py`).

      gpu  -> "lanes": the Pallas QP kernel, compiled for the card (a kernel
              that does not compile fails; there is no fallback).
      cpu  -> "xla", unless interpret=True is passed explicitly: then the
              same kernel runs in Pallas interpret mode (the CPU test path).
      any other platform raises.
    backend="xla" takes the XLA path on any supported platform.
    """
    if platform is None:
        platform = jax.default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if platform not in ("gpu", "cpu"):
        raise ValueError(
            f"unsupported platform {platform!r}: the QP kernel is built for "
            "NVIDIA GPUs (Pallas/Triton); use a GPU or the CPU"
        )
    if backend == "xla":
        return DispatchDecision("xla", "requested explicitly")
    if platform == "gpu":
        if interpret:
            raise ValueError(
                "interpret mode is the CPU test path; on a GPU the kernel compiles"
            )
        reason = "Pallas QP kernel, jacfwd linearization under XLA"
        if gp_batched:
            reason += " (per-scenario GP population: each scenario's own Jacobians)"
        return DispatchDecision("lanes", reason)
    if interpret:
        return DispatchDecision(
            "lanes", "Pallas QP kernel in interpret mode (requested explicitly)",
            interpret=True,
        )
    return DispatchDecision(
        "xla",
        "no GPU: the QP kernel runs on the CPU only in interpret mode "
        "(pass interpret=True)",
        degraded=backend == "lanes",
    )


# One-time warnings, keyed by reason: each distinct degradation fires once per
# process.
_DISPATCH_WARNED: set[str] = set()


def _warn_dispatch(decision: DispatchDecision):
    if not decision.degraded or decision.reason in _DISPATCH_WARNED:
        return
    _DISPATCH_WARNED.add(decision.reason)
    import warnings

    warnings.warn(
        f"gpmpc dispatch: lanes backend requested but taking the "
        f"'{decision.path}' path — {decision.reason}",
        stacklevel=3,
    )


def batched_gpmpc_step(
    model: SymbolicModel,
    cfg: SqpConfig,
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,  # leaves with leading batch axis B
    obs: jax.Array,  # (B, nx)
    backend: str = "auto",
    var_bf16: bool = False,
    interpret: bool = False,
):
    """One GP-MPC solve for B scenarios. consts/gp are broadcast (replicated),
    or carry a leading B axis (a per-scenario GP population).

    The path is `dispatch_decision(backend, interpret=...)`: the Pallas QP
    kernel on a GPU (control/gpmpc.py::batched_select_action_lanes), the
    vmapped XLA `select_action` on the CPU. var_bf16 selects the bf16
    tightening-variance GEMM (control/gpmpc.py::gp_variances).
    """
    gp_batched = gp.Zs.ndim == 4  # per-scenario GP population
    decision = dispatch_decision(backend, interpret=interpret, gp_batched=gp_batched)
    _warn_dispatch(decision)
    if decision.path == "lanes":
        return gpmpc_mod.batched_select_action_lanes(
            model, cfg, consts, gp, states, obs,
            var_bf16=var_bf16, interpret=decision.interpret,
        )
    step = partial(gpmpc_mod.select_action, model, cfg)
    gp_axis = 0 if gp_batched else None
    return jax.vmap(step, in_axes=(None, gp_axis, 0, 0))(consts, gp, states, obs)


def make_batched_controller_step(model, cfg, mesh=None, backend="auto", interpret=False):
    """jit-compiled batched step; if `mesh` is given, the batch axis is sharded
    over its first axis.

    On the kernel path the step runs under `shard_map`: XLA does not partition
    a Pallas custom call, and would otherwise gather the whole batch onto every
    device. Each device solves its own scenario shard; consts and gp are
    replicated. The XLA path is partitioned by `jit` from its shardings."""
    fn = partial(batched_gpmpc_step, model, cfg, backend=backend, interpret=interpret)
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    if dispatch_decision(backend, interpret=interpret).path == "lanes":
        return jax.jit(jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis)),
            check_vma=False,
        ))
    batched = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    return jax.jit(
        fn,
        in_shardings=(repl, repl, batched, batched),
        out_shardings=(batched, batched, batched),
    )


class EpisodeResult(NamedTuple):
    obs: jax.Array  # (B, n_steps+1, nx)
    actions: jax.Array  # (B, n_steps, nu)
    rewards: jax.Array  # (B, n_steps)


def batched_episode(
    model: SymbolicModel,
    cfg: SqpConfig,
    env_params,
    consts: GpMpcConsts,
    gp: GpModel,
    keys: jax.Array,  # (B,) PRNG keys
    n_steps: int,
    use_gp: bool = True,
    param_scale: float | None = None,
    backend: str = "auto",
    interpret: bool = False,
    gp_batched: bool = False,
    env_mod=drone,
) -> EpisodeResult:
    """Full closed-loop episodes for B scenarios as one scanned XLA program.

    `env_mod` selects the environment family: any module with the
    `envs/drone.py` functional surface (`env_reset`, `env_step_dynamic`,
    `params_to_array`, `randomize_params`) — `envs/cartpole_env.py` is the
    second instance. The model/env pairing is the caller's contract.

    With `param_scale`, every scenario runs against its own randomized plant
    coefficients (BASELINE config 3: domain-randomized rollouts) while the
    controller keeps the shared prior/GP model.

    With `gp_batched=True`, every `gp` leaf carries a leading B axis and each
    scenario runs its OWN GP model — a population of independently-learned
    controllers evaluated as one program (the multi-seed learning sweep,
    parallel/sweep.py, rides this; the reference can only run such populations
    as sequential processes). Supported on both paths: the kernel path keeps
    the QPs in the kernel and runs the per-scenario GP algebra vmapped under
    XLA.

    The GP-MPC step takes the path `dispatch_decision(backend, interpret=...)`
    picks (on the kernel path the batch axis sits inside the scan); the
    prior-only MPC (use_gp=False) always runs the XLA path.
    """
    if not use_gp and backend == "lanes":
        raise ValueError("backend='lanes' requires use_gp=True (GP-MPC step)")
    if use_gp and dispatch_decision(
        backend, interpret=interpret, gp_batched=gp_batched
    ).path == "lanes":
        return _batched_episode_lanes(
            model, cfg, env_params, consts, gp, keys, n_steps,
            param_scale=param_scale, interpret=interpret, env_mod=env_mod,
        )

    def single_episode(gp_i, key):
        k_env, k_par = jax.random.split(key)
        if param_scale is None:
            plant = env_mod.params_to_array(env_params.params)
        else:
            plant = env_mod.randomize_params(k_par, env_params.params, scale=param_scale)
        env_state, obs0 = env_mod.env_reset(env_params, k_env)
        ctrl_state = mpc_mod.init_state(cfg_horizon(consts), model.nx, model.nu)

        def step(carry, _):
            env_state, ctrl_state, obs = carry
            if use_gp:
                u, ctrl_state, _ = gpmpc_mod.select_action(
                    model, cfg, consts, gp_i, ctrl_state, obs
                )
            else:
                u, ctrl_state, _ = mpc_mod.select_action(
                    model, cfg, consts.mpc, ctrl_state, obs
                )
            env_state, obs_next, reward, _, _ = env_mod.env_step_dynamic(
                env_params, plant, env_state, u
            )
            return (env_state, ctrl_state, obs_next), (obs_next, u, reward)

        (_, _, _), (obs_path, actions, rewards) = jax.lax.scan(
            step, (env_state, ctrl_state, obs0), None, length=n_steps
        )
        obs_full = jnp.concatenate([obs0[None], obs_path], axis=0)
        return EpisodeResult(obs=obs_full, actions=actions, rewards=rewards)

    return jax.vmap(single_episode, in_axes=(0 if gp_batched else None, 0))(gp, keys)


def _batched_episode_lanes(
    model: SymbolicModel,
    cfg: SqpConfig,
    env_params,
    consts: GpMpcConsts,
    gp: GpModel,
    keys: jax.Array,
    n_steps: int,
    param_scale: float | None,
    interpret: bool,
    env_mod=drone,
) -> EpisodeResult:
    """Batch-inside-scan episode runner on the Pallas QP kernel path.
    `gp` leaves may carry a leading per-scenario axis (GP populations)."""
    k_env, k_par = jax.vmap(jax.random.split, out_axes=1)(keys)
    plant0 = env_mod.params_to_array(env_params.params)
    if param_scale is None:
        plant = jnp.broadcast_to(plant0, (keys.shape[0],) + plant0.shape)
    else:
        plant = jax.vmap(
            lambda k: env_mod.randomize_params(k, env_params.params, scale=param_scale)
        )(k_par)
    env_states, obs0 = jax.vmap(lambda k: env_mod.env_reset(env_params, k))(k_env)
    T = cfg_horizon(consts)
    ctrl_states = jax.vmap(lambda _: mpc_mod.init_state(T, model.nx, model.nu))(
        jnp.arange(keys.shape[0])
    )

    def step(carry, _):
        env_states, ctrl_states, obs = carry
        u, ctrl_states, _ = gpmpc_mod.batched_select_action_lanes(
            model, cfg, consts, gp, ctrl_states, obs, interpret=interpret
        )
        env_states, obs_next, reward, _, _ = jax.vmap(
            lambda p, s, a: env_mod.env_step_dynamic(env_params, p, s, a)
        )(plant, env_states, u)
        return (env_states, ctrl_states, obs_next), (obs_next, u, reward)

    (_, _, _), (obs_path, actions, rewards) = jax.lax.scan(
        step, (env_states, ctrl_states, obs0), None, length=n_steps
    )
    # scan stacks time-first; episode results are batch-first
    obs_full = jnp.concatenate([obs0[:, None], jnp.moveaxis(obs_path, 0, 1)], axis=1)
    return EpisodeResult(
        obs=obs_full,
        actions=jnp.moveaxis(actions, 0, 1),
        rewards=jnp.moveaxis(rewards, 0, 1),
    )


def cfg_horizon(consts: GpMpcConsts) -> int:
    return consts.mpc.uref.shape[0]


def batched_episode_randomized(
    model: SymbolicModel,
    cfg: SqpConfig,
    env_params: drone.EnvParams,
    consts: GpMpcConsts,
    gp: GpModel,
    keys: jax.Array,
    n_steps: int,
    param_scale: float = 0.1,
    use_gp: bool = True,
) -> EpisodeResult:
    """Domain-randomized episodes — thin wrapper over `batched_episode`."""
    return batched_episode(
        model, cfg, env_params, consts, gp, keys, n_steps,
        use_gp=use_gp, param_scale=param_scale,
    )
