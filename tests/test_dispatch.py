"""Backend-dispatch semantics: every cell of the documented matrix, and no
silent fallback cliffs.

`parallel/batch.py::dispatch_decision` is the single place that decides the
step path from the platform (the Pallas QP kernel on a GPU, the XLA path on
the CPU unless interpret mode is requested explicitly); `batched_gpmpc_step`
executes it and warns ONCE per distinct degradation reason.
`scripts/gen_dispatch_table.py` renders the same function into the README
matrix, so these cells and the docs cannot drift apart.
"""

import warnings

import numpy as np
import pytest

from gpmpc_tpu.models import cartpole as cartpole_mod
from gpmpc_tpu.parallel.batch import dispatch_decision

# The documented dispatch matrix (README "Dispatch semantics"), cell by cell.
MATRIX = [
    # (backend, platform, interpret, gp_batched) -> (path, reason-substring, interpret)
    (("xla", "gpu", False, False), ("xla", "requested", False)),
    (("xla", "cpu", False, False), ("xla", "requested", False)),
    (("xla", "gpu", False, True), ("xla", "requested", False)),
    (("xla", "cpu", True, False), ("xla", "requested", False)),
    (("auto", "gpu", False, False), ("lanes", "Pallas QP kernel", False)),
    (("lanes", "gpu", False, False), ("lanes", "Pallas QP kernel", False)),
    (("auto", "gpu", False, True), ("lanes", "population", False)),
    (("lanes", "gpu", False, True), ("lanes", "population", False)),
    (("auto", "cpu", False, False), ("xla", "no GPU", False)),
    (("lanes", "cpu", False, False), ("xla", "no GPU", False)),
    (("auto", "cpu", False, True), ("xla", "no GPU", False)),
    (("auto", "cpu", True, False), ("lanes", "interpret mode", True)),
    (("lanes", "cpu", True, False), ("lanes", "interpret mode", True)),
    (("lanes", "cpu", True, True), ("lanes", "interpret mode", True)),
]


@pytest.mark.parametrize("case", MATRIX, ids=[f"cell{i}" for i in range(len(MATRIX))])
def test_dispatch_matrix(case):
    (backend, platform, interpret, gp_batched), (want_path, want_reason, want_interp) = case
    d = dispatch_decision(backend, platform, interpret, gp_batched)
    assert d.path == want_path, (d.path, d.reason)
    assert want_reason in d.reason, d.reason
    assert d.interpret == want_interp


@pytest.mark.parametrize("platform,interpret,want", [
    ("gpu", False, ("lanes", False)),
    ("cpu", False, ("xla", False)),
    ("cpu", True, ("lanes", True)),
    ("rocm", False, ValueError),
], ids=["gpu", "cpu", "interpret", "unknown"])
def test_dispatch_per_platform(platform, interpret, want):
    """The default request on each platform: the kernel on a GPU, XLA on the
    CPU, the kernel in interpret mode on the CPU only when asked, and an error
    on any other platform (no silent fallback)."""
    if want is ValueError:
        with pytest.raises(ValueError, match="unsupported platform"):
            dispatch_decision(platform=platform, interpret=interpret)
        return
    d = dispatch_decision(platform=platform, interpret=interpret)
    assert (d.path, d.interpret) == want


def test_degraded_flag_is_structured():
    """Warning policy keys off dispatch_decision's `degraded` flag, not on
    substring matching of the reason text."""
    # explicit user choices and platform defaults: not degraded
    assert not dispatch_decision("xla", "cpu").degraded
    assert not dispatch_decision("auto", "cpu").degraded
    assert not dispatch_decision("auto", "gpu").degraded
    assert not dispatch_decision("lanes", "cpu", interpret=True).degraded
    # the kernel was asked for but the platform cannot run it compiled
    assert dispatch_decision("lanes", "cpu").degraded


def test_gpu_interpret_rejected():
    """interpret mode is never taken on a GPU, not even when asked for: a
    kernel that does not compile there must fail, not fall back."""
    with pytest.raises(ValueError, match="interpret mode"):
        dispatch_decision("auto", "gpu", interpret=True)
    with pytest.raises(ValueError, match="backend"):
        dispatch_decision("pallas", "gpu")


def test_cpu_fallback_warns_once():
    """A real batched_gpmpc_step that asks for the kernel on the CPU without
    interpret mode takes the XLA path and emits ONE structured warning naming
    the reason, and only once per process for that reason."""
    import jax
    import jax.numpy as jnp

    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs import cartpole_env
    from gpmpc_tpu.parallel import batch as batch_mod
    from gpmpc_tpu.parallel.batch import batched_gpmpc_step
    from gpmpc_tpu.utils.benchkit import synthetic_cartpole_gp_model

    T = 8
    env = cartpole_env.CartpoleTrackEnv(cartpole_env.EnvParams.default())
    model = cartpole_mod.symbolic_cartpole(dt=0.02)
    ctrl = GPMPC(
        model, env.trajectory, None, horizon=T,
        q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05],
        sparse_gp=True, max_gp_samples=10, seed=1, max_gp_points=32,
        sqp_iters=2, qp_iters=3,
        bounds=(cartpole_mod.state_bounds(), cartpole_mod.input_bounds()),
    )
    gp = synthetic_cartpole_gp_model(max_points=32, max_inducing=10, n_data=20, n_train=5)
    B = 2
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    _, obs = jax.vmap(lambda k: cartpole_env.env_reset(env.p, k))(keys)
    states = jax.vmap(lambda _: mpc_mod.init_state(T, model.nx, model.nu))(jnp.arange(B))

    batch_mod._DISPATCH_WARNED.clear()
    with pytest.warns(UserWarning, match="no GPU"):
        u, _, _ = batched_gpmpc_step(
            model, ctrl.cfg, ctrl.consts, gp, states, obs, backend="lanes"
        )
    assert np.all(np.isfinite(np.asarray(u)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # second identical fallback: silent
        batched_gpmpc_step(
            model, ctrl.cfg, ctrl.consts, gp, states, obs, backend="lanes"
        )


@pytest.mark.slow
def test_wrapper_lanes_backend_parity():
    """GPMPC.select_action routed through the QP kernel (the reference-shaped
    API takes the kernel path on a GPU) matches the XLA path step-for-step. On
    the CPU the kernel runs in interpret mode — slow, hence the tiny horizon
    and step count."""
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs import cartpole_env
    from gpmpc_tpu.models import cartpole

    env = cartpole_env.CartpoleTrackEnv(cartpole_env.EnvParams.default())
    model = cartpole.symbolic_cartpole(dt=0.02)

    def build(backend):
        return GPMPC(
            model, env.trajectory, None, horizon=8,
            q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05],
            sparse_gp=True, max_gp_samples=10, seed=1, max_gp_points=32,
            sqp_iters=3, qp_iters=6, step_backend=backend,
            interpret=backend == "lanes",
            bounds=(cartpole.state_bounds(), cartpole.input_bounds()),
        )

    rng = np.random.default_rng(0)
    xz = np.zeros((24, 4), np.float32)
    xz[:, 0] = rng.normal(0, 0.5, 24)
    xz[:, 1] = rng.normal(0, 0.2, 24)
    xz[:, 2] = rng.normal(0, 0.5, 24)
    xz[:, 3] = rng.uniform(-6, 6, 24)
    y = np.stack([-0.3 * xz[:, 0], -0.4 * xz[:, 2]], axis=1).astype(np.float32)

    actions = {}
    for backend in ("xla", "lanes"):
        ctrl = build(backend)
        assert ctrl._resolve_step_backend() == backend
        ctrl.train_gp(xz, y, lr=0.05, iterations=20)
        obs, _ = env.reset(seed=0)
        ctrl.reset()
        us = []
        for _ in range(5):
            u = ctrl.select_action(obs)
            obs, _, _, _, _ = env.step(u)
            us.append(u)
        actions[backend] = np.asarray(us)

    np.testing.assert_allclose(actions["lanes"], actions["xla"], atol=2e-4)


def test_readme_dispatch_table_matches_generator():
    """The README's dispatch matrix must be the VERBATIM output of
    scripts/gen_dispatch_table.py — the single-source-of-truth contract both
    claim. Regenerate with `python scripts/gen_dispatch_table.py` on drift."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "scripts/gen_dispatch_table.py"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    table = r.stdout.strip()
    readme = (repo / "README.md").read_text()
    assert table in readme, (
        "README dispatch matrix drifted from scripts/gen_dispatch_table.py "
        "output — regenerate and paste verbatim"
    )


def test_gpmpc_step_backend_follows_dispatch():
    """The reference-shaped GPMPC resolves its step path through
    dispatch_decision: XLA on the CPU by default, the kernel in interpret mode
    only when asked, and a named error for an unknown backend."""
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs import cartpole_env

    env = cartpole_env.CartpoleTrackEnv(cartpole_env.EnvParams.default())
    model = cartpole_mod.symbolic_cartpole(dt=0.02)

    def build(**kw):
        return GPMPC(
            model, env.trajectory, None, horizon=8,
            q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05],
            sparse_gp=True, max_gp_samples=10, seed=1, max_gp_points=32,
            sqp_iters=2, qp_iters=3,
            bounds=(cartpole_mod.state_bounds(), cartpole_mod.input_bounds()), **kw,
        )

    assert build()._resolve_step_backend() == "xla"
    assert build(step_backend="xla")._resolve_step_backend() == "xla"
    assert build(step_backend="lanes", interpret=True)._resolve_step_backend() == "lanes"
    with pytest.raises(ValueError, match="step_backend"):
        build(step_backend="pallas")
