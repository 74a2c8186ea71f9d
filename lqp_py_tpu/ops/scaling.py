"""Problem scaling / preconditioning for the box-QP ADMM solver.

Implements the reference's Jacobi-style diagonal scaling with quantile-blended
``beta`` and row equilibration of the equality constraints
(solve_box_qp_admm_torch.py:161-197), as pure traced functions: everything is
static-shaped and jit-safe (data-dependent branches become ``jnp.where``).

The scaled problem is

    Q' = D Q D,  p' = D p,  A' = E A D,  b' = E b,  lb' = lb / D,  ub' = ub / D

with per-batch-element diagonal vectors ``D (B, n)`` and ``E (B, m)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


class ScaledProblem(NamedTuple):
    Q: jnp.ndarray
    p: jnp.ndarray
    A: Optional[jnp.ndarray]
    b: Optional[jnp.ndarray]
    lb: jnp.ndarray
    ub: jnp.ndarray
    D: jnp.ndarray  # (B, n)
    E: Optional[jnp.ndarray]  # (B, m) or None


def _safe_colnorm(norms):
    """Replace non-positive norms with max(mean, 1e-6) per batch element
    (reference zero-column clamp, solve_box_qp_admm_torch.py:164-168)."""
    fill = jnp.maximum(jnp.mean(norms, axis=-1, keepdims=True), 1e-6)
    return jnp.where(norms <= 0.0, jnp.broadcast_to(fill, norms.shape), norms)


def _scale_pad_q(Q, D, pad):
    """One fused pass producing the scaled AND padded operand
    ``blockdiag(D Q D, I_pad)``.

    Written as pad -> elementwise so XLA fuses it into a single loop over
    the padded output (one read of Q, one padded write) instead of the
    scale-then-copy two-pass sequence — saves a full (B, n, n) HBM
    round-trip per solve."""
    if pad == 0:
        return D[..., :, None] * Q * D[..., None, :]
    n = Q.shape[-1]
    dtype = Q.dtype
    Qp = jnp.pad(Q, ((0, 0), (0, pad), (0, pad)))
    Dp = jnp.pad(D, ((0, 0), (0, pad)), constant_values=1.0)
    idx = jnp.arange(n + pad)
    tail_eye = ((idx[:, None] == idx[None, :]) & (idx[:, None] >= n)
                ).astype(dtype)
    return Dp[..., :, None] * Qp * Dp[..., None, :] + tail_eye


def scale_problem(Q, p, A, b, lb, ub, beta=None, pad: int = 0
                  ) -> ScaledProblem:
    """Compute and apply the scaling.  All inputs in (B, n)/(B, m) layout.

    With ``pad > 0`` the returned ``Q`` is the scaled operand padded to
    ``n + pad`` with an identity block (the aligned factorization
    operand — see ``_scale_pad_q``), and ``A`` gains ``pad`` zero columns;
    all (B, n)-shaped outputs stay unpadded (padding them is cheap at the
    consumer)."""
    # --- D from column inf-norms of Q, blended toward its mean by beta.
    Q_norm = jnp.max(jnp.abs(Q), axis=-2)            # (B, n) column inf-norms
    Q_norm = _safe_colnorm(Q_norm)
    D = jnp.sqrt(1.0 / Q_norm)
    if beta is None:
        # Per-element auto beta = 1 - q10(D)/q90(D)
        # (solve_box_qp_admm_torch.py:171-174).
        q = jnp.quantile(D, jnp.array([0.10, 0.90], dtype=D.dtype), axis=-1)
        beta_v = 1.0 - q[0] / q[1]                   # (B,)
        beta_v = beta_v[..., None]
    else:
        beta_v = jnp.asarray(beta, dtype=D.dtype)
    D = (1.0 - beta_v) * D + beta_v * jnp.mean(D, axis=-1, keepdims=True)

    Qs = _scale_pad_q(Q, D, pad)
    ps = D * p

    As = None
    bs = None
    E = None
    if A is not None:
        AD = A * D[..., None, :]
        A_norm = jnp.max(jnp.abs(AD), axis=-1)       # (B, m) row inf-norms
        A_norm = _safe_colnorm(A_norm)
        E = 1.0 / A_norm
        As = E[..., :, None] * AD
        if pad:
            As = jnp.pad(As, ((0, 0), (0, 0), (0, pad)))
        bs = E * b

    # Division by D keeps +/-inf bounds infinite (D > 0).
    lbs = lb / D
    ubs = ub / D
    return ScaledProblem(Q=Qs, p=ps, A=As, b=bs, lb=lbs, ub=ubs, D=D, E=E)


def _scale_pad_q_rho(Q, D, pad, rho):
    """One fused pass producing the scaled, padded FACTORIZATION
    operand ``blockdiag(D Q D, I_pad) + rho * blockdiag(I_n, 0)``.

    Same single-HBM-pass fusion as ``_scale_pad_q`` with the ADMM diagonal
    shift folded in: the solver's factorization consumes ``H = Q' + rho I``
    directly, so building Q' and then H separately would cost an extra
    full (B, n, n) round trip.  The pad
    block is exactly the identity (rho is NOT added there), which keeps
    the padded coordinates' factor decoupled and lets refactorization
    shift only the leading-block diagonal."""
    n = Q.shape[-1]
    dtype = Q.dtype
    rho_d = rho[..., None]                          # (B, 1)
    if pad == 0:
        eye = jnp.eye(n, dtype=dtype)
        return (D[..., :, None] * Q * D[..., None, :]
                + rho_d[..., None] * eye)
    Qp = jnp.pad(Q, ((0, 0), (0, pad), (0, pad)))
    Dp = jnp.pad(D, ((0, 0), (0, pad)), constant_values=1.0)
    idx = jnp.arange(n + pad)
    is_diag = (idx[:, None] == idx[None, :])
    tail_eye = (is_diag & (idx[:, None] >= n)).astype(dtype)
    lead_eye = (is_diag & (idx[:, None] < n)).astype(dtype)
    return (Dp[..., :, None] * Qp * Dp[..., None, :]
            + rho_d[..., None] * lead_eye + tail_eye)


class ScaledProblemH(NamedTuple):
    """Scaled problem with the factorization operand H pre-built (the
    scaled Q itself is NOT materialized — reconstruct as
    ``H[:, :n, :n] - rho I`` if needed, e.g. by the polish path)."""
    H: jnp.ndarray                  # (B, n+pad, n+pad) = D Q D + rho I (+pad)
    p: jnp.ndarray
    A: Optional[jnp.ndarray]
    b: Optional[jnp.ndarray]
    lb: jnp.ndarray
    ub: jnp.ndarray
    D: jnp.ndarray                  # (B, n)
    E: Optional[jnp.ndarray]        # (B, m) or None


def scale_problem_h(Q, p, A, b, lb, ub, rho, beta=None, pad: int = 0,
                    scale: bool = True):
    """Fused variant of ``scale_problem`` emitting ``H = D Q D + rho I``
    (padded) directly.

    ``rho`` is a callable ``rho(D, q_fro) -> (B,)`` receiving the scaling
    vector and the Frobenius norm of the SCALED Q (computed here as the
    vector quadratic form ``sqrt(d2' (Q∘Q) d2)`` with ``d2 = D*D`` — one
    fused reduction pass over Q instead of a pass over the materialized
    scaled operand), so the auto-rho policy stays in the solver while the
    build stays single-pass."""
    if scale:
        Q_norm = jnp.max(jnp.abs(Q), axis=-2)
        Q_norm = _safe_colnorm(Q_norm)
        D = jnp.sqrt(1.0 / Q_norm)
        if beta is None:
            q = jnp.quantile(D, jnp.array([0.10, 0.90], dtype=D.dtype),
                             axis=-1)
            beta_v = (1.0 - q[0] / q[1])[..., None]
        else:
            beta_v = jnp.asarray(beta, dtype=D.dtype)
        D = (1.0 - beta_v) * D + beta_v * jnp.mean(D, axis=-1, keepdims=True)
    else:
        D = jnp.ones_like(p)

    d2 = D * D
    # ||D Q D||_F without materializing D Q D: one reduction pass over Q.
    q_fro = jnp.sqrt(jnp.maximum(
        jnp.einsum("bi,bij,bij,bj->b", d2, Q, Q, d2), 0.0))
    rho_v = rho(D, q_fro)

    H = _scale_pad_q_rho(Q, D, pad, rho_v)
    ps = D * p

    As = None
    bs = None
    E = None
    if A is not None:
        AD = A * D[..., None, :]
        if scale:
            A_norm = jnp.max(jnp.abs(AD), axis=-1)
            A_norm = _safe_colnorm(A_norm)
            E = 1.0 / A_norm
        else:
            E = jnp.ones_like(b)
        As = E[..., :, None] * AD
        if pad:
            As = jnp.pad(As, ((0, 0), (0, 0), (0, pad)))
        bs = E * b

    lbs = lb / D
    ubs = ub / D
    return ScaledProblemH(H=H, p=ps, A=As, b=bs, lb=lbs, ub=ubs, D=D,
                          E=E), rho_v


def identity_scaling(Q, p, A, b, lb, ub, pad: int = 0) -> ScaledProblem:
    D = jnp.ones_like(p)
    E = None if A is None else jnp.ones_like(b)
    Qp = _scale_pad_q(Q, D, pad) if pad else Q
    Ap = A
    if A is not None and pad:
        Ap = jnp.pad(A, ((0, 0), (0, 0), (0, pad)))
    return ScaledProblem(Q=Qp, p=p, A=Ap, b=b, lb=lb, ub=ub, D=D, E=E)
