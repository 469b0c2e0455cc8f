"""gpmpc_tpu — a GPU-native Gaussian-process model-predictive-control framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of `amacati/gp-mpc`
(reference mounted read-only at /root/reference). The reference delegates all heavy
compute to native libraries (acados C SQP solver + HPIPM, CasADi C++ symbolic algebra,
GPyTorch/LibTorch); here the entire control loop — dynamics, GP posterior, SQP with an
interior-point OCP-QP, covariance propagation, and the simulator — is a single jitted,
batchable, shardable JAX program that runs on the accelerator without host round-trips.

Layer map (mirrors SURVEY.md §1):
  L0  ops/        — Riccati, box-constrained OCP-QP interior point, SQP, linalg
  L1  models/     — quadrotor symbolic dynamics (jnp functions + AD Jacobians)
  L2  gp/         — exact GP training, SE kernels, FITC sparse posterior
  L3  control/    — MPC and GPMPC controllers (functional cores + stateful wrappers)
  L4  scripts/    — experiment driver (run_gp_mpc.py)
  L5  envs/       — on-device quadrotor figure-eight environment
  L6  utils/      — plotting / telemetry / checkpointing / profiling
  par parallel/   — device mesh, scenario-batch sharding, multi-host init
"""

__version__ = "0.1.0"

from gpmpc_tpu.models.symbolic import SymbolicModel, symbolic_attitude
from gpmpc_tpu.models.trajectory import figure_eight_trajectory

__all__ = [
    "SymbolicModel",
    "symbolic_attitude",
    "figure_eight_trajectory",
    "__version__",
]
