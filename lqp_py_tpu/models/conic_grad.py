"""SCS-style implicit differentiation through the conic projection
fixed point.

Batched JAX implementation of the reference's SCS backward
(``torch_solve_qp_scs_grads``, scs_qp.py:121-189): given a primal-dual
solution ``(x, lams, slacks)`` of

    min 0.5 x'Qx + p'x   s.t.  Ax = b,  Gx <= h

the gradients of all six problem data follow from one batched solve of

    (M o D^T - diag(D) + I + 1e-8 I)^T d = D o [-dl_dx; 0]

where ``M = [[Q, Abar^T], [-Abar, 0]]`` with ``Abar = [A; G]`` and ``D`` is
the derivative of the Euclidean projection onto the cone (identity on the
x and zero-cone blocks, step function on the nonnegative block).

Memory model: the self-dual system is materialized DENSE and NON-SYMMETRIC
at ``(B, N, N)`` with ``N = n + n_eq + k`` — for the box shape
``k = 2n`` that is ``(B, 3n+n_eq, 3n+n_eq)``, i.e. ~4.6 GB at the
flagship (B=128, n=1000) — the very operand class the condensed KKT
backward exists to avoid (box_qp_grad.py:228-233).  This is a PARITY mode
for small problems; ``_genqp_bwd`` auto-falls back to the condensed
``'kkt'`` rule (with a warning) when the system would exceed
``CONIC_BACKWARD_MAX_BYTES``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

#: Trace-time budget for the materialized (B, N, N) self-dual system.
#: 1 GiB keeps the conic mode usable through n~300 at B=128 while
#: refusing the 4.6 GB flagship-shape operand.
CONIC_BACKWARD_MAX_BYTES = 1 << 30


def conic_backward_bytes(B, n, n_eq, k, itemsize) -> int:
    """Bytes of the dense self-dual system the conic backward materializes."""
    N = n + n_eq + k
    return B * N * N * itemsize


def conic_qp_grads(dl_dx, x, lams, slacks, Q, A, G) -> Tuple:
    """Returns (dQ, dp, dA, db, dG, dh); dA/db are None when A is None.

    lams/slacks are the stacked multipliers/slacks of [A; G] when A is
    present in the reference (scs_qp.py:92); here lams/slacks correspond to
    the inequality block only and the equality block's lam-s entries are
    reconstructed as (nu, 0) — for a converged solution the equality slacks
    are 0 and the duals free, which matches SCS's (y, s) layout.
    """
    B, n = x.shape
    dtype = x.dtype
    k = G.shape[-2]
    n_eq = 0 if A is None else A.shape[-2]

    if A is not None:
        Abar = jnp.concatenate([A, G], axis=-2)
    else:
        Abar = G
    n_con = n_eq + k

    # w = [x; y - s] with y the duals, s the slacks (scs_qp.py:135).
    if A is not None:
        # Equality block: slack 0; the dual enters only via the projection
        # derivative, which is identity on that block regardless of value.
        y_minus_s = jnp.concatenate(
            [jnp.zeros((B, n_eq), dtype), lams - slacks], axis=-1)
        lams_full = jnp.concatenate(
            [jnp.zeros((B, n_eq), dtype), lams], axis=-1)
    else:
        y_minus_s = lams - slacks
        lams_full = lams

    # M = [[Q, Abar^T], [-Abar, 0]]  (scs_qp.py:144-147).
    top = jnp.concatenate([Q, jnp.swapaxes(Abar, -1, -2)], axis=-1)
    bot = jnp.concatenate(
        [-Abar, jnp.zeros((B, n_con, n_con), dtype)], axis=-1)
    M = jnp.concatenate([top, bot], axis=-2)
    N = n + n_con

    # Projection derivative D (scs_qp.py:150-154): identity on x and the
    # zero cone's dual block, 0.5*(sign+1) on the nonnegative block.
    D_y = 0.5 * (jnp.sign(y_minus_s[..., n_eq:]) + 1.0)
    D = jnp.concatenate(
        [jnp.ones((B, n + n_eq), dtype), D_y], axis=-1)

    rhs = jnp.concatenate(
        [-dl_dx, jnp.zeros((B, n_con), dtype)], axis=-1)
    rhs = D * rhs

    eye = jnp.eye(N, dtype=dtype)
    mat = M * D[..., None, :] - eye * D[..., None, :] + eye + 1e-8 * eye
    d = jnp.linalg.solve(jnp.swapaxes(mat, -1, -2), rhs[..., None])[..., 0]

    dx = d[..., :n]
    dy = d[..., n:]

    def outer(a, b):
        return jnp.einsum("...i,...j->...ij", a, b)

    dl_dp = dx
    dQ_half = 0.5 * outer(dx, x)
    dl_dQ = dQ_half + jnp.swapaxes(dQ_half, -1, -2)

    dl_dAmat = outer(lams_full, dx) - outer(dy, x)

    if A is not None:
        dl_dA = dl_dAmat[..., :n_eq, :]
        dl_db = dy[..., :n_eq]
        dl_dG = dl_dAmat[..., n_eq:, :]
        dl_dh = dy[..., n_eq:]
    else:
        dl_dA = None
        dl_db = None
        dl_dG = dl_dAmat
        dl_dh = dy

    return dl_dQ, dl_dp, dl_dA, dl_db, dl_dG, dl_dh
