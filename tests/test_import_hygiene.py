"""Importing the package must not initialize the XLA backend.

Two production paths depend on this:
  * `jax.distributed.initialize` (multi-host init, scripts/run_multihost.py)
    must run before anything touches the backend — an import-time jnp constant
    anywhere in the package would make `import gpmpc_tpu` fatal for DCN init.
  * Importing the package must stay cheap and side-effect free: a process
    chooses its platform (and, on a GPU, reserves the card) only when it first
    computes.

The check runs in a subprocess with `xla_bridge.backends` patched to abort, so
any import-time device op (jnp module constants, NamedTuple defaults built
with jnp, eager trig in a factory) fails loudly with the offending file:line.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import os, sys, traceback
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import jax
from jax._src import xla_bridge

def patched(*a, **k):
    for f in reversed(traceback.extract_stack()):
        if "/gpmpc_tpu/" in f.filename.replace("\\", "/"):
            print(f"BACKEND INIT at {{f.filename}}:{{f.lineno}}: {{f.line}}")
            break
    raise SystemExit(1)

xla_bridge.backends = patched
import gpmpc_tpu
import gpmpc_tpu.control.gpmpc
import gpmpc_tpu.control.mpc
import gpmpc_tpu.envs.drone
import gpmpc_tpu.envs.cartpole_env
import gpmpc_tpu.envs.twolink_env
import gpmpc_tpu.gp.exact_gp
import gpmpc_tpu.models.residual
import gpmpc_tpu.ops.pallas_ocp
import gpmpc_tpu.ops.sqp_lanes
import gpmpc_tpu.parallel.batch
import gpmpc_tpu.parallel.sweep
import gpmpc_tpu.runtime.server
import gpmpc_tpu.utils.benchkit
import gpmpc_tpu.utils.checkpoint
print("CLEAN")
"""


def test_package_import_does_not_initialize_backend():
    r = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0 and "CLEAN" in r.stdout, (
        f"import-time device op detected:\n{r.stdout}\n{r.stderr}"
    )
