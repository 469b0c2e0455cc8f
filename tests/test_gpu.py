"""Kernel-path parity at cell size, on the card.

Marked `gpu`: each test takes the `gpu` fixture (tests/conftest.py), which
skips it where JAX finds no GPU. Run on the card with

    GPMPC_TEST_PLATFORM=gpu python -m pytest -m gpu tests/

(chip_smoke.py runs them in its phase 6).
"""

import numpy as np
import pytest

from gpmpc_tpu.utils import parity
from gpmpc_tpu.utils.benchkit import build_problem

pytestmark = pytest.mark.gpu


def test_kernel_step_matches_xla_at_default_cell(gpu):
    """The bench default cell (quadrotor, T=25, 40 inducing points, B=1024):
    closed-loop actions of the kernel path vs the XLA path."""
    records, _ = parity.closed_loop_parity(build_problem("quadrotor"), 1024, n_steps=2)
    assert parity.action_rmse_ok(records), records


def test_kernel_step_matches_xla_with_rollout_trained_gp(gpu):
    """The default cell with GPs trained as the learning loop trains them
    (prior rollout, the config-default 500 Adam iterations): low trained
    noise and GP-mean weights of ~1e2, where reduced-precision matmuls on the
    kernel path would show as a gap to the XLA path or as NaN."""
    problem = build_problem("quadrotor")
    gp, noise = parity.rollout_trained_gp(problem)
    alpha_max = float(np.max(np.abs(np.asarray(gp.alpha_s))))
    records, _ = parity.closed_loop_parity(problem._replace(gp=gp), 1024, n_steps=2)
    assert parity.action_rmse_ok(records), (noise, alpha_max, records)


def test_kernel_qp_long_horizon(gpu):
    """T=200 at B=256, the long-horizon cell: the kernel vs boxqp on a
    linearized step."""
    problem = build_problem("quadrotor", horizon=200)
    res = parity.qp_parity(parity.step_qp(problem, 256), problem.ctrl.cfg)
    assert parity.qp_parity_ok(res, soft=False, mehrotra=problem.ctrl.cfg.qp_mehrotra), res
