"""Implicit backward passes for the box-QP layer.

Two strategies, mirroring the reference's selectable backends
(solve_box_qp_admm_torch.py:62-66):

- ``fixed_point``: implicit differentiation of the ADMM fixed-point map
  (``torch_solve_box_qp_grad``, solve_box_qp_admm_torch.py:349-432).  One
  batched solve of a masked reduced KKT system.
- ``kkt``: implicit differentiation of the KKT conditions with the box
  rewritten as ``G = [-I; I], h = [-lb; ub]``
  (``torch_solve_box_qp_grad_kkt`` + helpers,
  solve_box_qp_admm_torch.py:435-584).

Everything is batched, static-shaped and jit-safe; the data-dependent
masking of the reference becomes ``jnp.where``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from lqp_py_tpu.ops.precision import solver_precision


def _outer(a, b):
    return jnp.einsum("...i,...j->...ij", a, b)


def reduced_kkt_solve(H, A, r, reg, equilibrate: bool = True,
                      precision: str = "highest"):
    """Solve ``[[H, A^T], [A, 0]] [dv; dnu] = [r; 0]`` for SPD H through
    the sweep/Schur solve-only fast path (ops/linalg.py spd_solve_fast):
    it avoids both the lax Cholesky's sequential column recurrence AND the
    cost of materializing the full inverse for a single right-hand side.
    ``A`` may be None (returns dnu=None).

    ``equilibrate=False``: the caller pre-scaled the system to unit
    diagonal (change of variables dv = D w with As = A D, rs = D r); the
    returned ``w`` must be unscaled by the caller, ``dnu`` is invariant."""
    from lqp_py_tpu.ops import linalg as lin
    dtype = r.dtype
    if A is None:
        return lin.spd_solve_fast(
            H, r[..., None], equilibrate=equilibrate,
            precision=precision)[..., 0], None
    m = A.shape[-2]
    At = jnp.swapaxes(A, -1, -2)
    R = jnp.concatenate([r[..., None], At], axis=-1)
    X = lin.spd_solve_fast(H, R, equilibrate=equilibrate,
                           precision=precision)  # (B, n, 1+m)
    x0 = X[..., 0]
    W = X[..., 1:]                                      # H^-1 A^T
    S = jnp.einsum("...mi,...ik->...mk", A, W,
                   preferred_element_type=dtype)
    S = S + reg * jnp.eye(m, dtype=dtype)
    Sinv = lin.spd_inverse(S)                           # m x m — tiny
    dnu = jnp.einsum(
        "...mk,...k->...m", Sinv,
        jnp.einsum("...mi,...i->...m", A, x0,
                   preferred_element_type=dtype),
        preferred_element_type=dtype)
    dv = x0 - jnp.einsum("...im,...m->...i", W, dnu,
                         preferred_element_type=dtype)
    return dv, dnu


def _matvec(M, v):
    return jnp.einsum("...ij,...j->...i", M, v, preferred_element_type=v.dtype)


@solver_precision
def box_qp_grad_fixed_point(dl_dz, x, u, lams, nus, Q, A, lb, ub, rho,
                            reg: float = 1e-8,
                            solve_precision: str = "high"):
    """Fixed-point implicit VJP.  All arrays in squeezed (B, n)/(B, m) layout,
    unscaled (as saved by the layer).  ``rho`` is (B,).

    The reference solves the row-masked non-symmetric system
    ``[[dpi*Q + diag(rho (1-dpi)), dpi*A^T], [A, 0]]`` with a batched LU
    (solve_box_qp_admm_torch.py:378-393).  On clamped coordinates that
    system forces ``dv_i = 0`` (the row reduces to ``rho dv_i = 0``), so it
    is equivalent to the row-AND-column masked *symmetric* system

        [[dpi Q dpi + diag(rho (1-dpi)), dpi A^T], [A dpi, 0]]

    which is SPD-quasi-definite and solved here through the Schur-reduced
    fast path (ops/linalg.py ``spd_solve_fast``) — the single hot spot of
    the backward pass.

    Returns (dQ, dp, dA, db, dlb, dub); dA/db are None when A is None.
    """
    B, n = x.shape
    dtype = x.dtype
    rho_col = rho[..., None]

    # Projection derivative: 0 where x + u violates a bound, 1 inside
    # (solve_box_qp_admm_torch.py:363-365).
    s_xu = x + u
    dpi = jnp.where((s_xu > ub) | (s_xu < lb), 0.0, 1.0).astype(dtype)

    dl_dx = dl_dz * dpi

    # Build the masked system PRE-EQUILIBRATED in one fused elementwise
    # pass: with diag(H) = dpi^2 Q_ii + rho (1 - dpi) + reg and
    # s = diag(H)^-1/2, the scaled system (s_i s_j H_ij, unit diagonal)
    # needs no further diag-rescale inside spd_solve_fast — saving two
    # full (B, n, n) HBM passes per backward.  Change of variables:
    # dv = s w, A_s = A diag(dpi s), r_s = s r; dnu is invariant.
    diag_q = jnp.diagonal(Q, axis1=-2, axis2=-1)
    diag_h = dpi * dpi * diag_q + rho_col * (1.0 - dpi) + reg
    s_eq = jax.lax.rsqrt(jnp.maximum(diag_h, 1e-30))     # (B, n)
    m_eq = dpi * s_eq

    # Build the masked system DIRECTLY at the size spd_solve_fast
    # factorizes at: padded coordinates get m = 0 and diag 1, i.e. an
    # exactly decoupled identity block — the same inert-pad invariant as
    # the forward solver — so spd_solve_fast skips its internal zero-fill
    # + copy round trip.  The pad fuses into the one elementwise build
    # pass.
    from lqp_py_tpu.ops import linalg as _lin
    pad = _lin.schur_size(n, dtype) - n
    if pad:
        Qb = jnp.pad(Q, ((0, 0), (0, pad), (0, pad)))
        m_b = jnp.pad(m_eq, ((0, 0), (0, pad)))
        dq_b = jnp.pad(diag_q, ((0, 0), (0, pad)))
        rhs_b = jnp.pad(-s_eq * dl_dx, ((0, 0), (0, pad)))
        A_b = None if A is None else jnp.pad(A, ((0, 0), (0, 0), (0, pad)))
    else:
        Qb, m_b, dq_b, rhs_b, A_b = Q, m_eq, diag_q, -s_eq * dl_dx, A
    eye_b = jnp.eye(n + pad, dtype=dtype)
    Hs = (m_b[..., :, None] * Qb * m_b[..., None, :]
          + eye_b * (1.0 - m_b * m_b * dq_b)[..., None, :])
    A_s = None if A_b is None else A_b * m_b[..., None, :]

    # Default "high" recursion GEMMs: on an H100 they run as TF32
    # tensor-core gemms, and the flagship gradient agrees with an f64
    # Cholesky reference to 5e-4 relative (chip_smoke.py; TF32's unit
    # roundoff is 4.9e-4) — within what gradient consumers resolve.
    w, dnu_ = reduced_kkt_solve(Hs, A_s, rhs_b, reg,
                                equilibrate=False,
                                precision=solve_precision)
    dv = s_eq * (w[:, :n] if pad else w)
    if A is not None:
        d = jnp.concatenate([dv, dnu_], axis=-1)
    else:
        d = dv

    dl_dp = dv
    dQ_half = 0.5 * _outer(dv, x)
    dl_dQ = dQ_half + jnp.swapaxes(dQ_half, -1, -2)

    dl_dA = None
    dl_db = None
    dnu = None
    if A is not None:
        dnu = d[..., n:]
        dl_db = -dnu
        dl_dA = _outer(dnu, x) + _outer(nus, dv)

    # Bound gradients via the stationarity residual
    # (solve_box_qp_admm_torch.py:417-427).
    kkt = -dl_dz - _matvec(Q, dv)
    if A is not None:
        kkt = kkt - _matvec(jnp.swapaxes(A, -1, -2), dnu)
    div = rho_col * u
    div = jnp.where(div == 0, 1.0, div)
    dlam = kkt / div

    dl_dlb = dlam * lams[..., :n]
    dl_dub = -dlam * lams[..., n:]

    return dl_dQ, dl_dp, dl_dA, dl_db, dl_dlb, dl_dub


def make_kkt_jacobian(Q, G, A, lams, slacks):
    """Full (non-symmetric) KKT Jacobian
    [[Q, G^T diag(lam), A^T], [G, -diag(s), 0], [A, 0, 0]]
    (``torch_qp_make_sol_mat``, solve_box_qp_admm_torch.py:472-500).
    G/A may be None."""
    B, n = Q.shape[0], Q.shape[-1]
    dtype = Q.dtype
    blocks_rows = []
    n_ineq = 0 if G is None else G.shape[-2]
    n_eq = 0 if A is None else A.shape[-2]

    row1 = [Q]
    if G is not None:
        row1.append(jnp.swapaxes(G, -1, -2) * lams[..., None, :])
    if A is not None:
        row1.append(jnp.swapaxes(A, -1, -2))
    blocks_rows.append(jnp.concatenate(row1, axis=-1))

    if G is not None:
        row2 = [G, -jax.vmap(jnp.diag)(slacks)]
        if A is not None:
            row2.append(jnp.zeros((B, n_ineq, n_eq), dtype))
        blocks_rows.append(jnp.concatenate(row2, axis=-1))

    if A is not None:
        row3 = [A]
        if G is not None:
            row3.append(jnp.zeros((B, n_eq, n_ineq), dtype))
        row3.append(jnp.zeros((B, n_eq, n_eq), dtype))
        blocks_rows.append(jnp.concatenate(row3, axis=-1))

    return jnp.concatenate(blocks_rows, axis=-2)


def solve_kkt_backwards(dl_dz, sol_mat, n_eq, n_ineq):
    """Solve the KKT Jacobian system for the differentials
    (``torch_solve_qp_backwards``, solve_box_qp_admm_torch.py:503-524)."""
    B, n = dl_dz.shape
    dtype = dl_dz.dtype
    rhs = jnp.concatenate(
        [-dl_dz, jnp.zeros((B, n_eq + n_ineq), dtype)], axis=-1)
    d = jnp.linalg.solve(sol_mat, rhs[..., None])[..., 0]
    dx = d[..., :n]
    dlam = d[..., n:n + n_ineq] if n_ineq > 0 else None
    dnu = d[..., n + n_ineq:] if n_eq > 0 else None
    return dx, dlam, dnu


def qp_int_grads(x, lams, nus, dx, dlam, dnu) -> Tuple:
    """OptNet-style gradient assembly from the differentials
    (``torch_qp_int_grads``, solve_box_qp_admm_torch.py:527-562)."""
    dl_dp = dx
    dQ_half = 0.5 * _outer(dx, x)
    dl_dQ = dQ_half + jnp.swapaxes(dQ_half, -1, -2)

    dl_dG = None
    dl_dh = None
    if dlam is not None:
        dl_dG = (lams[..., :, None] * _outer(dlam, x)) + _outer(lams, dx)
        dl_dh = -lams * dlam

    dl_dA = None
    dl_db = None
    if dnu is not None:
        dl_dA = _outer(dnu, x) + _outer(nus, dx)
        dl_db = -dnu

    return dl_dQ, dl_dp, dl_dA, dl_db, dl_dG, dl_dh


@solver_precision
def box_qp_grad_kkt(dl_dz, x, lams, nus, Q, A, lb, ub,
                    slack_clamp: float = 1e-8,
                    slack_max: float = 1e12):
    """KKT implicit VJP with the box materialized as ``G = [-I; I]``
    (``torch_solve_box_qp_grad_kkt``, solve_box_qp_admm_torch.py:435-469).

    Infinite bounds produce infinite slacks in the reference (which only
    clamps from below); here slacks are additionally clamped from above at
    ``slack_max`` so the Jacobian stays finite — the corresponding
    multipliers are ~0 and the resulting bound gradients vanish, which is
    the correct limit.
    """
    B, n = x.shape
    dtype = x.dtype
    n_eq = 0 if A is None else A.shape[-2]

    # Slacks for G = [-I; I]: s = [x - lb; ub - x].
    slacks = jnp.concatenate([x - lb, ub - x], axis=-1)
    slacks = jnp.clip(slacks, slack_clamp, slack_max)
    lams_c = jnp.clip(lams, slack_clamp, None)

    # The reference materializes and LU-solves the full (3n+m)^2 Jacobian
    # (torch_qp_make_sol_mat, solve_box_qp_admm_torch.py:472-500) — a
    # ~4.6 GB operand at (B=128, n=1000).  Eliminating the complementarity
    # rows analytically (dlam = (G dx)/s) condenses it to n x n; for the
    # box, G^T diag(lam/s) G is just a diagonal:
    w = lams_c / slacks                                   # (B, 2n)
    H = Q + jnp.eye(n, dtype=dtype) * (w[..., :n] + w[..., n:])[..., None, :]
    dx, dnu = reduced_kkt_solve(H, A, -dl_dz, reg=0.0)
    dlam = jnp.concatenate([-dx, dx], axis=-1) / slacks   # (G dx)/s
    dl_dQ, dl_dp, dl_dA, dl_db, _dl_dG, dl_dh = qp_int_grads(
        x, lams_c, nus, dx, dlam, dnu)

    # Map dl_dh back to the bounds (``torch_qp_int_grads_admm``,
    # solve_box_qp_admm_torch.py:565-584).
    dl_dlb = -dl_dh[..., :n]
    dl_dub = dl_dh[..., n:]

    return dl_dQ, dl_dp, dl_dA, dl_db, dl_dlb, dl_dub
