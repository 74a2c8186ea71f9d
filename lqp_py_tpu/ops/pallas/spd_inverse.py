"""Pallas kernel (Triton route): batched SPD inverse of 128x128 leaves via
the symmetric SWEEP operator.

Why this exists
---------------
``ops/linalg.py`` inverts an SPD (B, n, n) operand by a block Schur
recursion whose O(n^3) work is batched GEMMs; what is left at the bottom
is a batch of 128x128 diagonal-block inverses.  Done in plain XLA, each of
the 128 pivot steps of such a leaf is a separate pass over device memory.
One 128x128 f32 leaf is 64 KB, so one Triton program can hold it in
registers for all of its pivots and touch device memory twice: one load,
one store.

The SWEEP operator (Beaton 1964; standard in regression computations):
for a symmetric A, sweeping index k maps

    A[k,k] -> -1/d            (d = A[k,k])
    A[i,k] -> A[i,k]/d        (i != k), same for row k by symmetry
    A[i,j] -> A[i,j] - A[i,k] A[k,j] / d

Sweeping all k of an SPD matrix yields ``-A^-1``; every pivot is a Schur
complement diagonal of an SPD matrix, hence positive — no pivoting
needed.  Sweep preserves symmetry, so each step needs only ONE masked
column extraction (reused as the row) plus one rank-1 update.

Hopper layout: one program per leaf (grid over the batch), block
(1, 128, 128), the tile carried through the pivot loop as a register
value.  Pivots go two at a time: the second pivot's column is corrected
for the first with an O(m) vector op, so the tile takes one fused rank-2
update per pair.

Reference parity note: replaces the role of ``torch.linalg.lu_factor`` /
``lu_solve`` prep (solve_box_qp_admm_torch.py:206-215).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

LEAF = 128          # SPD block size handled by one program
#: Warps per program; 8 warps hold the 128x128 f32 tile at 64 registers
#: a thread.
NUM_WARPS = 8


def _sweep_kernel(h_ref, o_ref):
    """Sweep all pivots of one (m, m) symmetric tile (m even)."""
    m = h_ref.shape[-1]
    dtype = h_ref.dtype
    zero = jnp.zeros((), dtype)
    row_id = jax.lax.broadcasted_iota(jnp.int32, (m, m), 0)
    col_id = jax.lax.broadcasted_iota(jnp.int32, (m, m), 1)
    vec_id = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)

    def column(X, k):            # X[:, k] (== X[k, :] by symmetry)
        return jnp.sum(jnp.where(col_id == k, X, zero), axis=1)

    def pick(v, k):              # v[k] as a scalar
        return jnp.sum(jnp.where(vec_id == k, v, zero))

    def step(j, X):
        k1 = 2 * j
        k2 = k1 + 1
        e1 = (vec_id == k1).astype(dtype)
        e2 = (vec_id == k2).astype(dtype)
        # Per sweep step, with u = X[:, k] - e_k and v = u / d:
        #   (X - u v^T)[i,j] = X[i,j] - X[i,k]X[k,j]/d   (i,j != k)
        #   (X - u v^T)[k,j] = X[k,j]/d,  same for column k by symmetry
        #   (X - u v^T)[k,k] = 2 - 1/d    (needs a -2 correction)
        c1 = column(X, k1)
        u1 = c1 - e1
        v1 = u1 / pick(c1, k1)
        # Column k2 AFTER the first sweep, computed without touching the
        # tile: c2' = c2 - X[k2,k1] v1.
        c2 = column(X, k2) - pick(c1, k2) * v1
        u2 = c2 - e2
        v2 = u2 / pick(c2, k2)
        pivot = (row_id == col_id) & ((row_id == k1) | (row_id == k2))
        return (X - u1[:, None] * v1[None, :] - u2[:, None] * v2[None, :]
                - jnp.where(pivot, 2.0, 0.0).astype(dtype))

    X = jax.lax.fori_loop(0, m // 2, step, h_ref[...])
    o_ref[...] = -X


def sweep_spd_inverse(H, *, interpret: bool, num_warps: int = NUM_WARPS):
    """Batched SPD inverse of (B, m, m), m a power of two.  ``interpret``
    runs the same kernel through the Pallas interpreter (CPU)."""
    B, m, m2 = H.shape
    if m != m2 or m % 2 or m & (m - 1):
        raise ValueError(f"sweep leaf needs square power-of-two blocks, "
                         f"got {H.shape}")
    spec = pl.BlockSpec((None, m, m), lambda i: (i, 0, 0))
    return pl.pallas_call(
        _sweep_kernel,
        grid=(B,),
        in_specs=[spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(H.shape, H.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="sweep_spd_inverse",
    )(H)


def interpret_on(platform: str) -> bool:
    """Whether the leaf runs interpreted on ``platform``: compiled through
    Triton on CUDA, interpreted on the CPU (tests); any other platform has
    no route and raises."""
    if platform == "cuda":
        return False
    if platform == "cpu":
        return True
    raise ValueError(f"the sweep leaf has no route to platform {platform!r}")


def spd_inverse_leaf(H):
    """``sweep_spd_inverse`` with the mode chosen by the platform the
    enclosing computation is lowered for (not the default device)."""
    return jax.lax.platform_dependent(H, **{
        p: functools.partial(sweep_spd_inverse, interpret=interpret_on(p))
        for p in ("cpu", "cuda")})
