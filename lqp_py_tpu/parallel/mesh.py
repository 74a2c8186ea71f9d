"""Device-mesh construction and multi-host initialization.

The reference is single-process/single-device (SURVEY.md §2: no DP/TP/PP,
no NCCL/MPI).  The batched equivalent is batch-sharded data parallelism
over a ``jax.sharding.Mesh``: the ADMM state is embarrassingly parallel
over the batch axis; the only cross-chip communication the algorithm needs
is the all-reduce hidden inside the global convergence test
(``jnp.all(is_optimal)`` in the while condition), which XLA lowers to a
collective (NCCL on GPUs) automatically under GSPMD.  Every card reaches
every other at the same rate, so the mesh is flat: its shape follows the
algorithm alone.

A second 'tp' axis is exposed for sharding the n_x (KKT operator) axis of
very large single problems and for tensor-parallel layers feeding the QP.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp",),
              devices=None) -> Mesh:
    """Build a mesh over the available devices.

    Default: a 1-D 'dp' mesh over all devices.  Pass ``shape=(d, t)`` and
    ``axis_names=('dp', 'tp')`` for a 2-D layout.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    devs = np.asarray(devices[:n]).reshape(shape)
    return Mesh(devs, tuple(axis_names))


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "dp") -> NamedSharding:
    """NamedSharding that splits the leading (batch) axis, replicating the
    rest: P('dp', None, ...)."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_batch(tree, mesh: Mesh, axis: str = "dp"):
    """Device-put every array in a pytree with its batch axis sharded."""
    def put(x):
        if x is None:
            return None
        return jax.device_put(x, batch_sharding(mesh, jax.numpy.ndim(x), axis))
    return jax.tree_util.tree_map(put, tree)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (``jax.distributed.initialize``).  No-op when
    single-process (the common case in tests and single-host benches)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
