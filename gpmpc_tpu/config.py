"""Structured experiment configuration.

The YAML schema of the reference (`scripts/gp_mpc_config.yaml:1-30`, loaded into a
munch attrdict at /root/reference/scripts/run_gp_mpc.py:22-29) is kept as the
compatibility surface, but parsed into typed dataclasses with validation instead of
an untyped dict. Unknown keys raise; the prior-params check mirrors
/root/reference/gpmpc/gpmpc.py:43-44.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from datetime import datetime
from itertools import chain, count
from pathlib import Path
from typing import Any


def _build(cls, data: dict[str, Any]):
    names = {f.name for f in fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**data)


@dataclass
class GpMpcSection:
    horizon: int = 25
    q_mpc: list = field(
        default_factory=lambda: [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
    )
    r_mpc: list = field(default_factory=lambda: [3, 3, 3, 0.1])
    prior_params: dict = field(
        default_factory=lambda: {
            "a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
            "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653,
        }
    )
    prob: float = 0.95
    device: str = "gpu"  # informational; JAX owns placement
    sparse_gp: bool = True
    max_gp_samples: int = 40
    # Additions with no reference counterpart:
    sqp_iters: int = 25  # ≙ acados nlp_solver_max_iter
    qp_iters: int = 15  # interior-point iterations per QP
    max_gp_points: int = 128  # padded GP dataset capacity (avoids re-jit on growth)
    parallel_scan: bool = False  # O(log T) associative-scan Riccati (long horizons)
    # L1 penalty weight for soft (slack-penalized) chance-tightened state
    # bounds; null/None = hard bounds with the 45% feasibility clamp. See
    # ops/boxqp.py (bounded-multiplier IP) and MpcInfo.soft_viol.
    soft_constraints: float | None = None
    # Levenberg-Marquardt SQP damping (≙ acados levenberg_marquardt): added
    # to the GN Hessian blocks only; 0 = off. See ops/sqp.py SqpConfig.lm_reg.
    lm_reg: float = 0.0
    # Per-step solve backend of the reference-shaped API, decided by
    # parallel/batch.py::dispatch_decision: "auto"/"lanes" take the Pallas QP
    # kernel on a GPU and the XLA path on the CPU; "xla" forces XLA.
    step_backend: str = "auto"

    _STEP_BACKENDS = ("auto", "lanes", "xla")

    def __post_init__(self):
        if self.prior_params is None or any(
            k not in self.prior_params for k in ("a", "b")
        ):
            raise ValueError("gpmpc requires prior_params containing 'a' and 'b'.")
        assert len(self.q_mpc) == 12 and len(self.r_mpc) == 4
        if self.step_backend not in self._STEP_BACKENDS:
            raise ValueError(
                f"step_backend must be one of {self._STEP_BACKENDS}, "
                f"got {self.step_backend!r}"
            )


@dataclass
class RunSection:
    num_epochs: int = 3


@dataclass
class TrainSection:
    eval_size: float = 0.2
    iterations: int = 500
    lr: float = 0.001
    samples_per_epoch: int = 15


@dataclass
class Config:
    save_dir: str = "saves/"
    task: str = "quadrotor"
    seed: int = 1
    gpmpc: GpMpcSection = field(default_factory=GpMpcSection)
    run: RunSection = field(default_factory=RunSection)
    train: TrainSection = field(default_factory=TrainSection)

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        import yaml  # only the YAML driver path needs PyYAML

        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        raw = dict(raw or {})
        sections = {
            "gpmpc": _build(GpMpcSection, raw.pop("gpmpc", {})),
            "run": _build(RunSection, raw.pop("run", {})),
            "train": _build(TrainSection, raw.pop("train", {})),
        }
        return _build(Config, {**raw, **sections})


def load_config(path: str | Path, make_save_dir: bool = True) -> Config:
    """Load a config and create a timestamped save dir.

    ≙ load_config + mkdir_date, /root/reference/scripts/run_gp_mpc.py:22-29,192-209.
    """
    cfg = Config.from_yaml(path)
    if make_save_dir:
        # Anchor relative save dirs at the CWD (the reference anchored at the
        # config file's grandparent, which escapes to '/' for configs outside a
        # repo checkout).
        root = Path(cfg.save_dir)
        if not root.is_absolute():
            root = Path.cwd() / root
        root.mkdir(parents=True, exist_ok=True)
        cfg.save_dir = str(mkdir_date(root))
    return cfg


def mkdir_date(path: Path) -> Path:
    """Create and return a fresh timestamped results directory under `path`.

    Fills the role of the reference's timestamped save-dir scheme
    (run_gp_mpc.py:192-209) with the same name format (minute-resolution
    timestamp, `_(k)` suffix on collision), but claims the directory with an
    exclusive mkdir so two runs started in the same minute can never race into
    sharing one directory.
    """
    if not path.is_dir():
        raise NotADirectoryError(f"save root {path} is not a directory")
    stamp = datetime.now().strftime("%Y_%m_%d_%H_%M")
    for suffix in chain([""], (f"_({k})" for k in count(1))):
        candidate = path / f"{stamp}{suffix}"
        try:
            candidate.mkdir()
        except FileExistsError:
            continue
        return candidate
