"""Config schema: reference-YAML compatibility and validation."""

from pathlib import Path

import pytest

from gpmpc_tpu.config import Config

REPO = Path(__file__).resolve().parents[1]


def test_shipped_yaml_loads():
    cfg = Config.from_yaml(REPO / "scripts" / "gp_mpc_config.yaml")
    assert cfg.gpmpc.horizon == 25
    assert len(cfg.gpmpc.q_mpc) == 12 and len(cfg.gpmpc.r_mpc) == 4
    assert cfg.gpmpc.prior_params["a"] == pytest.approx(12.1432)
    assert cfg.run.num_epochs == 3
    assert cfg.train.samples_per_epoch == 15


def test_reference_schema_subset_loads():
    """A config written for the reference (none of the keys this framework adds) must load."""
    raw = {
        "save_dir": "saves/", "task": "quadrotor", "seed": 1,
        "gpmpc": {
            "horizon": 25,
            "q_mpc": [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001],
            "r_mpc": [3, 3, 3, 0.1],
            "prior_params": {"a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
                             "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653},
            "prob": 0.95, "device": "cpu", "sparse_gp": True, "max_gp_samples": 40,
        },
        "run": {"num_epochs": 3},
        "train": {"eval_size": 0.2, "iterations": 500, "lr": 0.001, "samples_per_epoch": 15},
    }
    cfg = Config.from_dict(raw)
    assert cfg.gpmpc.sparse_gp is True
    # the added keys take their defaults
    assert cfg.gpmpc.max_gp_points == 128
    assert cfg.gpmpc.parallel_scan is False


def test_validation_errors():
    with pytest.raises(ValueError):
        Config.from_dict({"gpmpc": {"not_a_key": 1}})
    with pytest.raises(ValueError):
        Config.from_dict({"gpmpc": {"prior_params": {"c": 1.0}}})
    with pytest.raises(AssertionError):
        Config.from_dict({"gpmpc": {"q_mpc": [1, 2, 3]}})


def test_lm_reg_key_parses():
    cfg = Config.from_dict(
        {"gpmpc": {"prior_params": {"a": 1.0, "b": 2.0}, "lm_reg": 0.5}}
    )
    assert cfg.gpmpc.lm_reg == 0.5
    assert Config.from_dict({}).gpmpc.lm_reg == 0.0


def test_step_backend_validated():
    import pytest

    from gpmpc_tpu.config import GpMpcSection

    assert GpMpcSection().step_backend == "auto"
    assert GpMpcSection(step_backend="lanes").step_backend == "lanes"
    with pytest.raises(ValueError, match="step_backend"):
        GpMpcSection(step_backend="cuda")
