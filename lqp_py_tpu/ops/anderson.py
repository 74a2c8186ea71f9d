"""Batched safeguarded type-II Anderson acceleration.

The SCS ``acceleration_lookback`` capability
(/root/reference/lqp_py/control.py:39-77 exposes the knob; the SCS C
solver implements AA internally), re-designed for a lock-step jitted
batch: every quantity is per-batch-element and static-shaped, so one
``aa_step`` call accelerates all B fixed-point iterations at once inside
``lax.while_loop``/``fori_loop``.

Scheme, per element:

- Ring buffers hold the last ``m`` map outputs ``g(v_i)`` and fixed-point
  residuals ``r_i = g(v_i) - v_i``.
- The combination solves the sum-to-one-constrained least squares
  ``min_a ||R a||, 1'a = 1`` on unit-normalized residual columns (the
  normalization is what keeps the f32 normal equations solvable — squaring
  raw column scales spans ~1e12 of dynamic range near convergence):
  with ``a = b/c`` the KKT solution is ``y = M^-1 (1/c)``,
  ``a = (y/c)/sum(y/c)``, ``M = Rn'Rn + reg*I``.
- Safeguards (all per element): (1) if ``||r||`` grows past
  ``safeguard x best-||r||-since-reset``, take the plain step and RESET
  the history — a consecutive-growth monitor is too weak (slow churn that
  grows < factor/iteration never trips it; measured 201 -> 20000
  iterations on an f32 hard set); (2) reject combinations whose weight
  1-norm exceeds ``max_weight``; (3) elements flagged ``hold`` (already
  converged) stay on the plain map.
- A reset fills every slot with the current ``(g, r)`` pair; identical
  columns make the next combination reproduce the plain step exactly, so
  no warm-up counter is needed.  Callers force a reset (e.g. after a rho
  refactorization changes the map) by setting the monitor to ``-inf``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_TINY = 1e-16


class AAState(NamedTuple):
    Gh: jax.Array    # (B, m, d) ring buffer of map outputs
    Rh: jax.Array    # (B, m, d) ring buffer of residuals
    rn: jax.Array    # (B,) best residual norm since the last reset;
    #                  -inf forces a reset on the next aa_step


def aa_init(B: int, m: int, d: int, dtype) -> AAState:
    return AAState(Gh=jnp.zeros((B, m, d), dtype),
                   Rh=jnp.zeros((B, m, d), dtype),
                   rn=jnp.full((B,), -jnp.inf, dtype))


def aa_reset_where(state: AAState, mask) -> AAState:
    """Force a history reset for masked elements on their next aa_step."""
    return state._replace(rn=jnp.where(mask, -jnp.inf, state.rn))


def aa_step(state: AAState, v, gv, slot, hold, *,
            safeguard: float, reg: float, max_weight: float):
    """One accelerated update.

    v, gv: (B, d) current iterate and its plain map output.
    slot:  () int32 ring index (caller tracks the global iteration).
    hold:  (B,) bool — take the plain step for these elements.

    Returns ``(v_next, new_state)`` where ``v_next`` is the accelerated
    (or safeguarded-plain) next iterate.
    """
    Gh, Rh, rn_best = state
    B, m, _d = Gh.shape
    dtype = Gh.dtype
    r = gv - v
    rn = jnp.sqrt(jnp.sum(r * r, axis=-1))
    reset = rn > safeguard * rn_best
    rn_best = jnp.where(reset, rn, jnp.minimum(rn_best, rn))

    zero = jnp.zeros((), jnp.int32)
    Gh = jax.lax.dynamic_update_slice(Gh, gv[:, None, :],
                                      (zero, slot, zero))
    Rh = jax.lax.dynamic_update_slice(Rh, r[:, None, :],
                                      (zero, slot, zero))
    Gh = jnp.where(reset[:, None, None], gv[:, None, :], Gh)
    Rh = jnp.where(reset[:, None, None], r[:, None, :], Rh)

    c = jnp.sqrt(jnp.sum(Rh * Rh, axis=-1))                 # (B, m)
    cinv = 1.0 / jnp.maximum(c, _TINY)
    Rn = Rh * cinv[..., None]
    M = jnp.einsum("...ad,...bd->...ab", Rn, Rn,
                   preferred_element_type=dtype)
    tr = jnp.trace(M, axis1=-2, axis2=-1)
    # Unit-normalized columns put diag(M) at 1.0, so a regularizer below
    # machine eps rounds away entirely (f32: 1.0 + 1e-8 == 1.0) and M is
    # solved unregularized exactly when the residual columns go collinear
    # near convergence.  Floor it at a few ulps of the unit diagonal.
    reg_eff = max(float(reg), 16 * float(jnp.finfo(dtype).eps))
    M = M + (reg_eff * tr / m
             + _TINY)[..., None, None] * jnp.eye(m, dtype=dtype)
    # M is SPD (regularized Gram): solve through the batch-major
    # Gauss-Jordan inverse instead of jnp.linalg.solve — a batched LU
    # custom call per iteration costs more than a small-n ADMM iteration
    # itself; the window m is far below the size where Gauss-Jordan
    # stops beating a library factorization (PERF.md, Findings).
    from lqp_py_tpu.ops.linalg import _gj_inverse_small
    Minv = _gj_inverse_small(M)
    y = jnp.einsum("...ab,...b->...a", Minv, cinv,
                   preferred_element_type=dtype)
    w = y * cinv
    w = w / jnp.sum(w, axis=-1, keepdims=True)
    v_aa = jnp.einsum("...m,...md->...d", w, Gh,
                      preferred_element_type=dtype)

    wn = jnp.sum(jnp.abs(w), axis=-1)
    accept = ((~reset) & (~hold) & (wn <= max_weight)
              & jnp.all(jnp.isfinite(v_aa), axis=-1))
    v_next = jnp.where(accept[:, None], v_aa, gv)
    return v_next, AAState(Gh=Gh, Rh=Rh, rn=rn_best)
