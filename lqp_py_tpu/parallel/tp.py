"""Tensor-parallel ('tp') sharding of the KKT operator itself.

The batch axis ('dp') is embarrassingly parallel; the second mesh axis
'tp' exists for the other scaling direction SURVEY §5 calls "the long
axis": a single problem whose n_x makes the (B, n, n) reduced inverse too
large for one card's HBM (n=4096 at B=128 f32 is 8.6 GB for ``H^-1``
alone).

Here the column (last) axis of every n x n operator — Q, H = Q + rho I,
the Schur-recursion intermediates, and the materialized inverse
``H^-1`` — is sharded over 'tp' via GSPMD: inputs are placed with
``P(dp, None, tp)`` shardings and XLA's SPMD partitioner propagates them
through the whole solve, turning the hot-loop GEMV ``x = H^-1 r`` into a
column-sharded partial product + all-reduce across cards, and
partitioning the factorization GEMMs the same way.

The one op XLA cannot partition is the Pallas sweep kernel (a custom
call), so this path forces the pure-lax Cholesky leaves
(``ops.linalg.lax_linalg_only``) — slower than the sweep leaves on one
card but partitionable, which is what this entry point is for.

Verified in tests/test_parallel.py: results match the unsharded solve on a
virtual 8-device mesh, and XLA's per-device memory analysis confirms the
temporaries actually shrink with the tp degree (i.e. the partitioner did
not silently replicate the factorization).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lqp_py_tpu.config import BoxQPConfig, GenQPConfig, OptNetConfig
from lqp_py_tpu.models.box_ip import solve_box_qp_ip
from lqp_py_tpu.models.box_qp import solve_box_qp
from lqp_py_tpu.models.genqp import solve_qp_gen
from lqp_py_tpu.models.optnet import solve_qp_optnet
from lqp_py_tpu.ops.linalg import lax_linalg_only


def _shardings(mesh, batch_axis, model_axis):
    def mat(x):  # (B, k, n): columns over tp
        return NamedSharding(mesh, P(batch_axis, None, model_axis))

    def vec(x):  # (B, n): replicated over tp
        return NamedSharding(mesh, P(batch_axis, None))

    return mat, vec


def shard_problem_tp(mesh: Mesh, Q, p, A=None, b=None, lb=None, ub=None,
                     batch_axis: str = "dp", model_axis: str = "tp"):
    """Place problem data with batch over ``batch_axis`` and the n (column)
    axis of the matrix operands over ``model_axis``."""
    mat, vec = _shardings(mesh, batch_axis, model_axis)
    put = lambda x, s: None if x is None else jax.device_put(
        jnp.asarray(x), s(x))
    return (put(Q, mat), put(p, vec), put(A, mat), put(b, vec),
            put(lb, vec), put(ub, vec))


def _solve_tp(mesh, solver, args6, batch_axis, model_axis,
              lower_only=False, mat_idx=(0, 2)):
    """Shared tp driver: every solver here takes six operands whose matrix
    entries (Q, A, G) get their column (n) axis over ``model_axis`` and
    whose vector entries replicate over it.  The solve is traced under
    ``lax_linalg_only`` so every factorization leaf — ``spd_inverse_fast``
    / ``spd_solve_fast`` are shared by the box ADMM, genqp splitting, and
    both interior points — stays partitionable.  ``solver`` is a closure
    over its config taking the six placed args.

    ``mat_idx`` lists the argument positions that hold matrices ((0, 2)
    for the box solvers' Q/A, (0, 2, 4) when slot 4 carries G).  Matrix
    slots are identified positionally, NOT by shape: a (B, k, 1) array is
    a genuine matrix when n_x == 1 but the (B, n, 1) column-vector layout
    everywhere else, so a shape heuristic would squeeze real operators.
    Vectors in the documented ``(B, n, 1)`` layout are canonicalized to
    ``(B, n)`` before placement — sharding their size-1 trailing axis
    over ``model_axis`` would fail."""
    mat, vec = _shardings(mesh, batch_axis, model_axis)

    def place(i, x):
        if x is None:
            return None
        x = jnp.asarray(x)
        if i in mat_idx:
            return jax.device_put(x, mat(x))
        if x.ndim == 3 and x.shape[-1] == 1:   # (B, n, 1) vector layout
            x = x[..., 0]
        return jax.device_put(x, vec(x))

    placed = tuple(place(i, x) for i, x in enumerate(args6))
    with lax_linalg_only():
        fn = jax.jit(solver)
        if lower_only:
            return fn.lower(*placed).compile().memory_analysis()
        return fn(*placed)


def solve_box_qp_tp(mesh: Mesh, Q, p, A=None, b=None, lb=None, ub=None,
                    config: BoxQPConfig = BoxQPConfig(),
                    batch_axis: str = "dp", model_axis: str = "tp"):
    """Forward box-QP solve with the KKT operator column-sharded over
    ``model_axis`` (and the batch over ``batch_axis``).

    Semantics identical to ``solve_box_qp``; only the data layout differs.
    Returns a BoxQPSolution whose matrix-shaped internals lived sharded.
    """
    return _solve_tp(mesh,
                     lambda *a: solve_box_qp(*a, config=config),
                     (Q, p, A, b, lb, ub), batch_axis, model_axis)


def solve_qp_gen_tp(mesh: Mesh, Q, p, A=None, b=None, G=None, h=None,
                    config: GenQPConfig = GenQPConfig(),
                    batch_axis: str = "dp", model_axis: str = "tp"):
    """General-inequality (SCS-capability) solve with Q/A/G column-sharded
    over ``model_axis``: the splitting's KKT factorization and the hot-loop
    G/G' products partition the same way as the box solver's (all leaves
    are the shared ``spd_*_fast`` shapes)."""
    return _solve_tp(mesh,
                     lambda *a: solve_qp_gen(*a, config=config),
                     (Q, p, A, b, G, h), batch_axis, model_axis,
                     mat_idx=(0, 2, 4))


def solve_qp_optnet_tp(mesh: Mesh, Q, p, A=None, b=None, G=None, h=None,
                       config: OptNetConfig = OptNetConfig(),
                       batch_axis: str = "dp", model_axis: str = "tp"):
    """Interior-point solve with the condensed/schur factorization
    column-sharded over ``model_axis`` (same ``spd_inverse_fast`` shapes
    as the ADMM KKT operator)."""
    return _solve_tp(mesh,
                     lambda *a: solve_qp_optnet(*a, config=config),
                     (Q, p, A, b, G, h), batch_axis, model_axis,
                     mat_idx=(0, 2, 4))


def solve_box_qp_ip_tp(mesh: Mesh, Q, p, A=None, b=None, lb=None, ub=None,
                       config: OptNetConfig = OptNetConfig(),
                       batch_axis: str = "dp", model_axis: str = "tp"):
    """Box-structured interior-point solve, column-sharded like the rest of
    the family (its condensed operator is Q + diag, factorized through the
    same partitionable leaves)."""
    return _solve_tp(mesh,
                     lambda *a: solve_box_qp_ip(*a, config=config),
                     (Q, p, A, b, lb, ub), batch_axis, model_axis)


# solver name -> (solve fn, default config, matrix operand slots, operand
# names).  mat_idx lives here — the single source of which slots carry
# column-shardable operators — so memory analysis and a future entry point
# cannot drift from the solver's own wrapper above.
_TP_SOLVERS = {
    "box": (solve_box_qp, BoxQPConfig, (0, 2),
            ("Q", "p", "A", "b", "lb", "ub")),
    "genqp": (solve_qp_gen, GenQPConfig, (0, 2, 4),
              ("Q", "p", "A", "b", "G", "h")),
    "optnet": (solve_qp_optnet, OptNetConfig, (0, 2, 4),
               ("Q", "p", "A", "b", "G", "h")),
    "box_ip": (solve_box_qp_ip, OptNetConfig, (0, 2),
               ("Q", "p", "A", "b", "lb", "ub")),
}


def lowered_tp_memory(mesh: Mesh, *operands, config=None,
                      solver: str = "box",
                      batch_axis: str = "dp", model_axis: str = "tp"):
    """Compile a tp-sharded solve and return XLA's per-device memory
    analysis (argument/output/temp bytes).  Used by tests and the scaling
    experiment to prove the factorization is genuinely partitioned.

    ``operands`` are positional in the target solver's own order —
    'box'/'box_ip': (Q, p, A, b, lb, ub); 'genqp'/'optnet':
    (Q, p, A, b, G, h) — so a G matrix is never smuggled through a
    parameter named ``lb``.  Trailing ``None`` operands may be omitted."""
    fn, default_cfg, mat_idx, names = _TP_SOLVERS[solver]
    if len(operands) > len(names):
        raise TypeError(
            f"solver '{solver}' takes operands {names}, got "
            f"{len(operands)} positional arguments")
    operands = operands + (None,) * (len(names) - len(operands))
    cfg = default_cfg() if config is None else config
    return _solve_tp(mesh, lambda *a: fn(*a, config=cfg),
                     operands, batch_axis, model_axis,
                     lower_only=True, mat_idx=mat_idx)
