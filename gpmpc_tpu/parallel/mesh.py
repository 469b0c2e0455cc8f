"""Device mesh / topology module.

The reference has no distributed layer at all (SURVEY.md §2.3: single process,
single env, the only concurrency being OpenMP inside acados). Here scale-out
is a first-class component: scenario batches are sharded over a
`jax.sharding.Mesh` so that per-scenario OCP solves run on every device in
parallel, with collectives over NVLink within a host and the network across
hosts. Every device reaches every other at the same rate, so the mesh is a
plain 1-D scenario axis. This module owns mesh
construction, sharding specs for the scenario axis, and multi-host runtime init —
the moral replacement for an NCCL/MPI "communication backend": with XLA the
collectives are compiler-inserted from sharding annotations, so the only runtime
component we own is topology description.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
STAGE_AXIS = "stage"  # used by the long-horizon stage-parallel Riccati path


def make_mesh(n_devices: int | None = None, axis_names=(DATA_AXIS,), shape=None) -> Mesh:
    """Build a mesh over the first `n_devices` devices.

    Default: 1-D scenario-parallel mesh. Pass `shape` + `axis_names` for 2-D
    layouts (e.g. (data, stage) for horizon sharding on top of batch sharding).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if shape is None:
        shape = (n_devices,)
    assert int(np.prod(shape)) == n_devices, f"mesh shape {shape} != {n_devices} devices"
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def shard_leading_axis(tree, mesh: Mesh, axis: str = DATA_AXIS):
    """Place every leaf's leading axis on `axis`, replicating the rest."""
    def _shard(leaf):
        spec = P(axis, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(_shard, tree)


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree across the mesh."""
    def _rep(leaf):
        return jax.device_put(leaf, NamedSharding(mesh, P()))

    return jax.tree.map(_rep, tree)


def batch_spec(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Multi-host (DCN) runtime init. Wraps `jax.distributed.initialize`; with no
    arguments, relies on JAX's cluster auto-detection."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
