"""Batch-sharded QP solving over a device mesh.

Two styles:

- ``boxqp_sharded`` / ``solve_box_qp_sharded``: GSPMD — annotate the batch
  axis with a NamedSharding and jit; XLA partitions every batched op and
  inserts the convergence all-reduce across devices.  This is the recommended
  path (works for the backward pass too, since the implicit VJP is just
  more batched linear algebra).
- ``solve_box_qp_shard_map``: explicit shard_map over the 'dp' axis for
  users who want manual control; each shard runs a purely *local*
  convergence test and may exit at a different iteration count (the
  per-element ADMM states are independent, so results match the lock-step
  global solve — see the function docstring).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from lqp_py_tpu.config import BoxQPConfig
from lqp_py_tpu.models.box_qp import solve_box_qp
from lqp_py_tpu.models.layers import boxqp
from lqp_py_tpu.parallel.mesh import batch_sharding


def _shard_args(mesh, axis, *arrays):
    out = []
    for x in arrays:
        if x is None:
            out.append(None)
        else:
            x = jnp.asarray(x)
            out.append(jax.device_put(
                x, batch_sharding(mesh, x.ndim, axis)))
    return tuple(out)


def solve_box_qp_sharded(mesh: Mesh, Q, p, A=None, b=None, lb=None, ub=None,
                         config: BoxQPConfig = BoxQPConfig(),
                         axis: str = "dp"):
    """Batch-sharded forward solve (GSPMD).  Returns a BoxQPSolution whose
    arrays are sharded over ``axis``."""
    Q, p, A, b, lb, ub = _shard_args(mesh, axis, Q, p, A, b, lb, ub)

    @functools.partial(jax.jit, static_argnums=())
    def run(Q, p, A, b, lb, ub):
        return solve_box_qp(Q, p, A, b, lb, ub, config)

    return run(Q, p, A, b, lb, ub)


def boxqp_sharded(mesh: Mesh, Q, p, A=None, b=None, lb=None, ub=None,
                  config: BoxQPConfig = BoxQPConfig(), axis: str = "dp"):
    """Batch-sharded differentiable layer call (GSPMD)."""
    Q, p, A, b, lb, ub = _shard_args(mesh, axis, Q, p, A, b, lb, ub)
    return boxqp(Q, p, A, b, lb, ub, config=config)


def solve_box_qp_shard_map(mesh: Mesh, Q, p, A=None, b=None, lb=None,
                           ub=None, config: BoxQPConfig = BoxQPConfig(),
                           axis: str = "dp"):
    """Explicit shard_map variant: each shard solves its batch slice; the
    global convergence decision is the only cross-shard communication.

    The per-shard solver reuses ``solve_box_qp`` unchanged — its while
    condition ``jnp.all(is_optimal)`` is evaluated on the *local* shard, so
    shards may exit at different iteration counts.  That matches the
    algorithm (per-element states are independent); the returned per-element
    solutions are identical to the lock-step global solve up to stopping
    iteration, and residual/convergence reporting stays per-element.
    """
    shard_map = jax.shard_map

    names = ["Q", "p", "A", "b", "lb", "ub"]
    given = {n: jnp.asarray(v) for n, v in
             zip(names, (Q, p, A, b, lb, ub)) if v is not None}

    def spec_for(x):
        return P(axis, *([None] * (jnp.ndim(x) - 1)))

    def local_solve(kw):
        full = {n: kw.get(n) for n in names}
        sol = solve_box_qp(full["Q"], full["p"], full["A"], full["b"],
                           full["lb"], full["ub"], config)
        # Broadcast the scalar iteration count per element so every output
        # leaf carries the batch axis (shards may exit at different counts).
        return sol.replace(
            iterations=jnp.broadcast_to(sol.iterations,
                                        sol.converged.shape))

    in_specs = ({n: spec_for(v) for n, v in given.items()},)
    shapes = {n: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for n, v in given.items()}
    out_shape = jax.eval_shape(local_solve, shapes)
    out_specs = jax.tree_util.tree_map(
        lambda s: P(axis, *([None] * (s.ndim - 1))), out_shape)

    fn = shard_map(local_solve, mesh=mesh,
                   in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return fn(given)
