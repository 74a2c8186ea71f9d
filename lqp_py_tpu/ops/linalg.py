"""Batched KKT factorization and solves — the L1 numerics of the framework.

Design
------
The reference factorizes the full ``(n_x+n_eq)^2`` KKT matrix with LU and does
an ``lu_solve`` every ADMM iteration (solve_box_qp_admm_torch.py:206-267).
Triangular substitution is sequential and leaves a wide accelerator mostly
idle, and a per-iteration ``lu_solve`` with one right-hand side is
latency-bound.

Here the KKT operator

    M = [[H, A^T],
         [A, 0  ]],   H = Q + rho*I  (SPD)

is reduced by a Schur complement on ``H``:

    S    = A H^-1 A^T            (n_eq x n_eq, tiny in practice)
    x    = P r + W S^-1 b,       P = H^-1 - W S^-1 W^T,  W = H^-1 A^T
    nu   = S^-1 (W^T r - b)

With ``H^-1`` and the rank-``n_eq`` pieces computed once (mode
``'inverse'``), every ADMM iteration is one batched GEMV plus rank-``n_eq``
corrections — dense, static-shaped, HBM-bandwidth-bound work.  ``H^-1`` in
f32 comes from a block Schur recursion over batched GEMMs with a Pallas
sweep kernel at the 128x128 leaves (``spd_inverse_fast``).  A
``'cholesky'`` mode keeps triangular factors and does two batched
triangular solves per iteration instead (slightly better rounding
behavior, slower); both are jit/vmap/shard_map compatible.

Ref parity: replaces components #1's factorization path and #5 (TorchLU,
lu_layer.py:5-58) — see ``kkt_solve_cached`` for the cached-factor
differentiable solve used by unrolled mode.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from jax.lax import linalg as lax_linalg

from lqp_py_tpu.utils import pytree


def _eye_like(Q):
    n = Q.shape[-1]
    return jnp.eye(n, dtype=Q.dtype)


def chol_solve(L, rhs):
    """Solve ``(L L^T) x = rhs`` for batched lower-triangular ``L``.

    ``rhs`` is ``(..., n)`` or ``(..., n, k)``.
    """
    vec = rhs.ndim == L.ndim - 1
    if vec:
        rhs = rhs[..., None]
    y = lax_linalg.triangular_solve(L, rhs, left_side=True, lower=True,
                                    transpose_a=False)
    x = lax_linalg.triangular_solve(L, y, left_side=True, lower=True,
                                    transpose_a=True)
    return x[..., 0] if vec else x


def chol_inverse(L):
    """Explicit SPD inverse from a lower Cholesky factor.

    ``H^-1 = L^-T L^-1`` computed as a triangular solve against the identity
    followed by one symmetric GEMM.
    """
    eye = jnp.broadcast_to(_eye_like(L), L.shape)
    Linv = lax_linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return jnp.einsum("...ki,...kj->...ij", Linv, Linv,
                      preferred_element_type=L.dtype)


def spd_inverse(H):
    return chol_inverse(lax_linalg.cholesky(H))


# ---------------------------------------------------------------------------
# Fast f32 SPD inverse and solve: block Schur-complement recursion over
# batched GEMMs down to 128x128 diagonal leaves, each leaf inverted by the
# Pallas/Triton sweep kernel.  On an H100 (400 W limit) at B=128, n=1000
# this path beats both cholesky + triangular solve and the same recursion
# with Cholesky leaves, per call and end to end (PERF.md, Findings).
# ---------------------------------------------------------------------------

_LEAF = 128

# When True, spd_inverse_fast / spd_solve_fast use Cholesky leaves instead
# of the Pallas sweep leaves.  Needed under GSPMD tensor-parallel sharding:
# a Pallas custom call cannot be auto-partitioned by XLA's SPMD pass, while
# the lax decomposition can (see parallel/tp.py).
_FORCE_LAX = False


@contextlib.contextmanager
def lax_linalg_only():
    """Trace-time switch forcing the partitionable lax path."""
    global _FORCE_LAX
    old = _FORCE_LAX
    _FORCE_LAX = True
    try:
        yield
    finally:
        _FORCE_LAX = old


def _sweep_leaf(H):
    from lqp_py_tpu.ops.pallas.spd_inverse import spd_inverse_leaf
    return spd_inverse_leaf(H)


def _leaf_for(H):
    """Leaf of the Schur path for operand ``H``, or None for plain
    Cholesky (every dtype but f32)."""
    if _FORCE_LAX:
        return spd_inverse
    return _sweep_leaf if H.dtype == jnp.float32 else None


#: At or below this size the f32 inverse is the batch-major Gauss-Jordan
#: instead of one 128-padded sweep leaf.  Its n pivot steps are n
#: dependent passes, so it only wins while n is tiny: on an H100 at B=128
#: it beat Cholesky and the padded leaf at n=10 and lost to both from
#: n=16 up; between 16 and 128 the leaf and Cholesky stay within their
#: call-to-call spread (PERF.md, Findings).
_GJ_MAX = 12


def _gj_inverse_small(H):
    """Batch-major SPD inverse for small n: transpose to (n, n, B) so the
    batch is the contiguous minor dimension, then run the symmetric sweep
    recurrence of the Pallas leaf (ops/pallas/spd_inverse.py) as plain
    XLA ops — every pivot step is one vectorized rank-1 pass over the
    batch.  SPD input => every pivot is positive, no pivoting needed."""
    B, n, _ = H.shape
    dtype = H.dtype
    X = jnp.moveaxis(H, 0, -1)                       # (n, n, B)
    iota = jnp.arange(n)

    def step(k, X):
        onehot = (iota == k).astype(dtype)[:, None]  # (n, 1)
        row = jax.lax.dynamic_slice_in_dim(X, k, 1, axis=0)[0]  # (n, B)
        d = jnp.sum(row * onehot, axis=0)            # (B,)
        u = row - onehot                             # (n, B)
        v = u / d
        X = X - u[:, None, :] * v[None, :, :]
        # Pivot correction (sweep: A[k,k] -> -1/d needs an extra -2 after
        # the rank-1 update; see the Pallas kernel derivation).
        return X - 2.0 * (onehot[:, None, :] * onehot[None, :, :])

    X = jax.lax.fori_loop(0, n, step, X)
    return -jnp.moveaxis(X, -1, 0)


def _schur_inverse(H, ee, leaf):
    """Recursive SPD inverse; H is (B, n, n) with n a multiple of _LEAF.

    ``leaf`` inverts the <=128 diagonal blocks (the Pallas sweep kernel, or
    plain Cholesky under ``lax_linalg_only``: the recursion itself is all
    einsums, which XLA's SPMD partitioner can shard)."""
    n = H.shape[-1]
    if n <= _LEAF:
        return leaf(H)
    h = (n // _LEAF // 2) * _LEAF
    A = H[..., :h, :h]
    Bm = H[..., :h, h:]
    C = H[..., h:, h:]
    Ai = _schur_inverse(A, ee, leaf)
    T = ee("...ij,...jk->...ik", Ai, Bm)          # Ai B        (h, n-h)
    S = C - ee("...ji,...jk->...ik", Bm, T)       # C - B^T Ai B
    Si = _schur_inverse(S, ee, leaf)
    U = ee("...ij,...jk->...ik", T, Si)           # Ai B Si     (h, n-h)
    TL = Ai + ee("...ik,...jk->...ij", U, T)      # Ai + U (Ai B)^T
    top = jnp.concatenate([TL, -U], axis=-1)
    bot = jnp.concatenate([-jnp.swapaxes(U, -1, -2), Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _schur_solve_rec(H, R, ee, leaf):
    """``H^-1 R`` without materializing the full inverse: the two half-size
    blocks are inverted (recursively) but the cross-block pieces are only
    ever applied to ``R`` — ~40% fewer FLOPs than ``_schur_inverse`` when
    only a few right-hand sides are needed.

    H: (B, n, n) SPD with n a multiple of _LEAF; R: (B, n, k).
    """
    n = H.shape[-1]
    if n <= 2 * _LEAF:
        Hi = _schur_inverse(H, ee, leaf)
        return ee("...ij,...jk->...ik", Hi, R)
    h = (n // _LEAF // 2) * _LEAF
    A = H[..., :h, :h]
    Bm = H[..., :h, h:]
    C = H[..., h:, h:]
    R1 = R[..., :h, :]
    R2 = R[..., h:, :]
    Ai = _schur_inverse(A, ee, leaf)
    T = ee("...ij,...jk->...ik", Ai, Bm)            # Ai B      (h, n-h)
    S = C - ee("...ji,...jk->...ik", Bm, T)         # C - B^T Ai B
    Si = _schur_inverse(S, ee, leaf)
    Y1 = ee("...ij,...jk->...ik", Ai, R1)
    X2 = ee("...ij,...jk->...ik",
            Si, R2 - ee("...ji,...jk->...ik", Bm, Y1))
    X1 = Y1 - ee("...ij,...jk->...ik", T, X2)
    return jnp.concatenate([X1, X2], axis=-2)


def _pad_to_leaf(H):
    """Identity-pad (B, n, n) to the next multiple of _LEAF (exact: the
    inverse of blockdiag(H, I) is blockdiag(H^-1, I))."""
    B, n, _ = H.shape
    pad = -(-n // _LEAF) * _LEAF - n
    if not pad:
        return H
    Hp = jnp.zeros((B, n + pad, n + pad), H.dtype)
    Hp = Hp.at[:, :n, :n].set(H)
    return Hp.at[:, n:, n:].set(jnp.eye(pad, dtype=H.dtype))


def schur_size(n: int, dtype) -> int:
    """The size ``spd_inverse_fast`` / ``spd_solve_fast`` factorize an
    (n, n) operand of ``dtype`` at: the next multiple of 128 on the Schur
    path, else n.  Callers that build the operand elementwise can build it
    at this size directly (identity-padded) and skip the pad copy."""
    leaf = _leaf_for(jax.ShapeDtypeStruct((n, n), dtype))
    if leaf is None or (n <= _GJ_MAX and leaf is _sweep_leaf):
        return n
    return -(-n // _LEAF) * _LEAF


def _jacobi(H):
    """``d = diag(H)^-1/2`` and the unit-diagonal ``D H D``."""
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    d = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))           # (B, n)
    return d, H * d[..., :, None] * d[..., None, :]


def spd_inverse_fast(H, precision: str = "highest", equilibrate: bool = True):
    """SPD inverse of (B, n, n).  f32: Schur recursion over GEMMs with
    sweep leaves (``n`` identity-padded to a multiple of 128), or the
    batch-major Gauss-Jordan at n <= _GJ_MAX; other dtypes: Cholesky.

    With ``equilibrate=True`` the input is Jacobi-equilibrated first
    (``H' = D H D`` with ``D = diag(H)^-1/2``, so diag(H') = 1) and the
    result unscaled as ``H^-1 = D H'^-1 D``.  Without this, matrices with
    extreme diagonal dynamic range — e.g. the interior-point Schur
    complement ``Rt + diag(1/d)`` whose diagonal spans ~1e8 near
    convergence — lose all accuracy in a fixed-order f32 sweep (observed
    as NaNs in the OptNet solver).  Callers whose operand is already
    equilibrated (the box-QP solver Jacobi-scales Q before adding rho I)
    pass ``equilibrate=False`` and skip four full (B, n, n) passes."""
    leaf = _leaf_for(H)
    if leaf is None:
        return spd_inverse(H)
    ee = functools.partial(jnp.einsum, precision=precision,
                           preferred_element_type=H.dtype)
    d, Hs = _jacobi(H) if equilibrate else (None, H)
    n = H.shape[-1]
    if n <= _GJ_MAX and leaf is _sweep_leaf:
        Hi = _gj_inverse_small(Hs)
    else:
        Hi = _schur_inverse(_pad_to_leaf(Hs), ee, leaf)[:, :n, :n]
    if d is None:
        return Hi
    return Hi * d[..., :, None] * d[..., None, :]


def spd_solve_fast(H, R, equilibrate: bool = True,
                   precision: str = "highest"):
    """Solve ``H X = R`` for SPD (B, n, n) H and (B, n, k) R.  f32:
    Jacobi-equilibrated Schur-recursion solve (cheaper than materializing
    H^-1 when k << n, e.g. the one-shot backward-pass solve); other
    dtypes: a Cholesky solve.

    ``equilibrate=False`` skips the internal diag-rescale passes — pass it
    when the operand is already (approximately) unit-diagonal; callers that
    build H elementwise can fuse the equilibration into the build for free
    (see box_qp_grad_fixed_point).

    ``precision`` controls the recursion GEMMs."""
    leaf = _leaf_for(H)
    if leaf is None:
        return chol_solve(lax_linalg.cholesky(H), R)
    ee = functools.partial(jnp.einsum, precision=precision,
                           preferred_element_type=H.dtype)
    if equilibrate:
        d, Hs = _jacobi(H)
        Rs = R * d[..., :, None]
    else:
        d, Hs, Rs = None, H, R
    n = H.shape[-1]
    if n <= _GJ_MAX and leaf is _sweep_leaf:
        X = ee("...ij,...jk->...ik", _gj_inverse_small(Hs), Rs)
    else:
        Hp = _pad_to_leaf(Hs)
        Rp = jnp.pad(Rs, ((0, 0), (0, Hp.shape[-1] - n), (0, 0)))
        X = _schur_solve_rec(Hp, Rp, ee, leaf)[:, :n, :]
    if d is None:
        return X
    return X * d[..., :, None]


@pytree.dataclass
class KKTFactors:
    """Factorization state of the reduced KKT operator.

    'inverse' mode keeps the Schur reduction IMPLICIT:
    ``Hinv = (Q + rho I)^-1`` plus the low-rank pieces ``W = H^-1 A^T``,
    ``WS = W S^-1`` and ``Sinv = (A H^-1 A^T)^-1`` — the reduced inverse
    ``P = Hinv - WS W^T`` is applied as one (B, n, n) GEMV plus two
    rank-``n_eq`` corrections (n_eq is tiny in this workload), which is
    the same per-iteration memory traffic as a materialized ``P`` without
    ever building the extra (B, n, n) operand (0.5 GB at the flagship
    shape).

    ``L`` is chol(H) in 'cholesky' mode, else None.
    ``W``/``WS``/``Sinv`` are None when n_eq == 0.
    """

    L: Optional[jax.Array]
    W: Optional[jax.Array]
    Sinv: Optional[jax.Array]
    Hinv: Optional[jax.Array] = None
    WS: Optional[jax.Array] = None


def factorize_kkt(Q, rho, A, *, mode: str = "inverse",
                  s_reg: float = 0.0, equilibrate: bool = True) -> KKTFactors:
    """Factorize ``M = [[Q + rho I, A^T], [A, 0]]`` (batched).

    Q:   (B, n, n) SPD
    rho: (B,) or scalar — per-element ADMM penalty.  ``None`` means Q is
      ALREADY the shifted operand ``H`` (built fused with the scaling
      pass, ops/scaling.py ``scale_problem_h``) — no diagonal add here.
    A:   (B, m, n) or None
    s_reg: optional Tikhonov regularizer added to the Schur complement
      (used by the backward pass where masked A rows can lose rank).
    equilibrate: passed to ``spd_inverse_fast`` — pass False when Q is
      already Jacobi-equilibrated (the solver scaling path).
    """
    if rho is None:
        H = Q
    else:
        rho = jnp.asarray(rho, dtype=Q.dtype)
        rho_diag = jnp.broadcast_to(
            rho[..., None, None] if rho.ndim == 1 else rho,
            Q.shape[:-2] + (1, 1))
        H = Q + rho_diag * _eye_like(Q)

    if mode == "inverse":
        # Materialized-inverse mode never needs a triangular factor:
        # H^-1 comes from the Schur/sweep fast path (Cholesky-free), and
        # the Schur-complement pieces are plain GEMMs against it.
        Hinv = spd_inverse_fast(H, equilibrate=equilibrate)
        if A is None:
            return KKTFactors(L=None, W=None, Sinv=None, Hinv=Hinv)
        At = jnp.swapaxes(A, -1, -2)
        W = jnp.einsum("...ij,...jk->...ik", Hinv, At,
                       preferred_element_type=Q.dtype)   # (B, n, m)
        S = jnp.einsum("...ij,...jk->...ik", A, W,
                       preferred_element_type=Q.dtype)   # (B, m, m)
        if s_reg:
            S = S + s_reg * jnp.eye(S.shape[-1], dtype=S.dtype)
        Sinv = spd_inverse(S)
        WS = jnp.einsum("...im,...mk->...ik", W, Sinv,
                        preferred_element_type=Q.dtype)
        return KKTFactors(L=None, W=W, Sinv=Sinv, Hinv=Hinv, WS=WS)

    L = lax_linalg.cholesky(H)
    if A is None:
        return KKTFactors(L=L, W=None, Sinv=None)
    At = jnp.swapaxes(A, -1, -2)
    W = chol_solve(L, At)                       # (B, n, m)
    S = jnp.einsum("...ij,...jk->...ik", A, W,
                   preferred_element_type=Q.dtype)  # (B, m, m)
    if s_reg:
        S = S + s_reg * jnp.eye(S.shape[-1], dtype=S.dtype)
    Sinv = spd_inverse(S)
    return KKTFactors(L=L, W=W, Sinv=Sinv)


def kkt_apply(f: KKTFactors, r, b) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Apply the factored KKT inverse: solve M [x; nu] = [r; b].

    r: (B, n); b: (B, m) or None.  Returns (x, nu).
    """
    if f.W is None:
        if f.Hinv is not None:
            x = jnp.einsum("...ij,...j->...i", f.Hinv, r,
                           preferred_element_type=r.dtype)
        else:
            x = chol_solve(f.L, r)
        return x, None

    Wt_r = jnp.einsum("...im,...i->...m", f.W, r,
                      preferred_element_type=r.dtype)
    nu = jnp.einsum("...mk,...k->...m", f.Sinv, Wt_r - b,
                    preferred_element_type=r.dtype)
    if f.Hinv is not None:
        # Implicit P: x = Hinv r - W nu (one dense GEMV + rank-m pieces).
        y = jnp.einsum("...ij,...j->...i", f.Hinv, r,
                       preferred_element_type=r.dtype)
        x = y - jnp.einsum("...im,...m->...i", f.W, nu,
                           preferred_element_type=r.dtype)
    else:
        y = chol_solve(f.L, r)
        x = y - jnp.einsum("...im,...m->...i", f.W, nu,
                           preferred_element_type=r.dtype)
    return x, nu


def kkt_step_operator(f: KKTFactors, b):
    """Precompute ``(Hinv, q)`` so the hot-loop solve is
    ``x = Hinv r - WS (W^T r) + q`` (the middle term drops when
    n_eq == 0).

    In 'inverse' mode with equality constraints, ``q = W Sinv b`` is constant
    across iterations, so the per-iteration work collapses to one dense
    GEMV plus two rank-``n_eq`` corrections.
    Returns (P_eff, q) or None if not in inverse mode.
    """
    dense = f.Hinv
    if dense is None:
        return None
    if f.W is None or b is None:
        q = jnp.zeros(dense.shape[:-1], dtype=dense.dtype)
    else:
        Sb = jnp.einsum("...mk,...k->...m", f.Sinv, b,
                        preferred_element_type=dense.dtype)
        q = jnp.einsum("...im,...m->...i", f.W, Sb,
                       preferred_element_type=dense.dtype)
    return dense, q


# ---------------------------------------------------------------------------
# Differentiable cached-factor KKT solve (unrolled mode).
#
# Equivalent role to the reference's TorchLU/TorchLULayer (lu_layer.py:5-58):
# the in-loop solve back-propagates through the *cached* factors instead of
# differentiating the factorization.  For the symmetric KKT operator the VJP
# is one extra factored solve:
#     d = M^-1 (-g);  dM = d [x;nu]^T;  drhs = -d
# ---------------------------------------------------------------------------


@jax.custom_vjp
def kkt_solve_cached(factors: KKTFactors, Q, A, r, b):
    """Solve M(Q, A) [x; nu] = [r; b] using prefactored ``factors``.

    Gradients flow to Q, A, r, b (via the cached factors); the factors
    themselves receive zero cotangent.  ``A``/``b`` may be None.
    """
    x, nu = kkt_apply(factors, r, b)
    return x, nu


def _kkt_solve_cached_fwd(factors, Q, A, r, b):
    x, nu = kkt_apply(factors, r, b)
    return (x, nu), (factors, A, x, nu)


def _kkt_solve_cached_bwd(res, g):
    factors, A, x, nu = res
    g_x, g_nu = g
    if g_nu is None and nu is not None:
        g_nu = jnp.zeros_like(nu)
    dx, dnu = kkt_apply(factors, -g_x,
                        None if g_nu is None else -g_nu)
    # dl/dM = [dx; dnu] [x; nu]^T  (symmetric operator, reference
    # lu_layer.py:52); restricted to the Q and A blocks:
    dQ = jnp.einsum("...i,...j->...ij", dx, x)
    if A is not None:
        # A appears in both off-diagonal blocks: dA = dnu x^T + nu dx^T
        dA = (jnp.einsum("...m,...j->...mj", dnu, x)
              + jnp.einsum("...m,...j->...mj", nu, dx))
        db = -dnu
    else:
        dA = None
        db = None
    dr = -dx
    zero_factors = jax.tree_util.tree_map(jnp.zeros_like, factors)
    return (zero_factors, dQ, dA, dr, db)


kkt_solve_cached.defvjp(_kkt_solve_cached_fwd, _kkt_solve_cached_bwd)
