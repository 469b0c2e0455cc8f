"""The trace reducer of scripts/bench_step_breakdown.py: which named scope a
device event is charged to."""

import importlib.util
from pathlib import Path
from typing import NamedTuple

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "bench_step_breakdown.py"
_spec = importlib.util.spec_from_file_location("bench_step_breakdown", _PATH)
bsb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bsb)

HLO = """
  %fusion.12 = f32[1024,25,12]{2,1,0} fusion(%p.1), kind=kLoop, metadata={op_name="jit(step)/jit(main)/linearize/jvp(mul)" source_file="x.py"}
  %dot.3 = f32[1024,40]{1,0} dot(%a, %b), metadata={op_name="jit(step)/jit(main)/gp_variance/dot_general"}
  %while.7 = (s32[]) while(%t), metadata={op_name="jit(step)/jit(main)/tightening/while"}
  %add.9 = f32[4]{0} add(%x, %y), metadata={op_name="jit(step)/jit(main)/add"}
"""


class Event(NamedTuple):
    name: str
    stats: tuple = ()


def test_hlo_scopes_maps_instructions_to_op_names():
    names = bsb.hlo_scopes(HLO)
    assert names["fusion.12"] == "jit(step)/jit(main)/linearize/jvp(mul)"
    assert names["dot.3"].endswith("/gp_variance/dot_general")
    assert {"fusion.12", "dot.3", "while.7", "add.9"} <= set(names)
    assert names["fusion_12"] == names["fusion.12"]


@pytest.mark.parametrize("event,scope", [
    (Event("ocp_qp_ip_0d1d2d"), "qp_kernel"),
    (Event("fusion.12"), "linearize"),
    (Event("fusion_12"), "linearize"),
    (Event("sm90_xmma_gemm_f32f32", (("hlo_op", "dot.3"),)), "gp_variance"),
    (Event("loop_fusion", (("long_name", "jit(step)/tightening/while"),)), "tightening"),
    (Event("add.9"), "other"),
], ids=["kernel-name", "hlo-name", "kernel-spelling", "hlo-op-stat", "scope-in-stat",
        "unscoped"])
def test_scope_of(event, scope):
    assert bsb.scope_of(event, bsb.hlo_scopes(HLO)) == scope
