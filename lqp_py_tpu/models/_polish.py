"""Active-set penalty polish shared by the box solvers (OSQP 'polishing').

Given a guessed active set, re-solve the QP with the active bounds
enforced by a quadratic penalty (w = 1e4 f32 / 1e6 f64 — the same
penalty active-set scheme as the general IP's polish, models/optnet.py),
then iteratively refine through the factored operator.  The penalty form
keeps the per-element systems SPD and uniformly shaped, so one batched
``spd_inverse_fast`` factorization serves every batch element even though
their active sets differ — the batched alternative to OSQP's
per-problem reduced-KKT refactorization (osqp.org 'solution polishing';
no reference counterpart — /root/reference/lqp_py has no polish).

The returned active multipliers are UNCLIPPED stationarity reads
(lam_lo = w (lb - x), lam_hi = w (x - ub) on the active sets, 0 off
them): a negative value means the active-set guess was wrong for that
coordinate.  Callers use that — plus feasibility of the polished point —
in their acceptance test and keep their own iterate when polish fails,
so a bad guess can never make the returned solution worse.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from lqp_py_tpu.ops.linalg import spd_inverse, spd_inverse_fast


def _mv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v,
                      preferred_element_type=v.dtype)


def _mtv(M, v):
    return jnp.einsum("...ji,...j->...i", M, v,
                      preferred_element_type=v.dtype)


class PolishResult(NamedTuple):
    x: jnp.ndarray
    y: Optional[jnp.ndarray]   # equality dual (None when A is None)
    lam_lo: jnp.ndarray        # unclipped; negative => wrong active guess
    lam_hi: jnp.ndarray


def _penalty_weight(dtype):
    # With the augmented-Lagrangian updates the penalty no longer has to
    # be huge (the multiplier update kills the lam/w bias at ~(sigma/w)
    # per outer pass), and a LOWER w is strictly safer: the AL update's
    # rounding noise is w*eps*|constraint scale| — at 1e6 in f32 that is
    # ~0.12, which swamped a genuinely negative multiplier read (-0.0097)
    # and let a wrongly-pinned point through the sign test.  1e3/1e6 keep
    # the noise at ~1e-4 (f32) / 2e-10 (f64) while three outer passes
    # drive the pin bias to machine scale (AL contraction ratio is
    # ~sigma/w ~ 2e-3 per pass on equilibrated problems, so stiffness is
    # not needed from w itself).
    return jnp.asarray(1e3 if dtype == jnp.float32 else 1e6, dtype)


def al_lam_threshold(dtype):
    """Sign-test threshold for AL-ESTIMATED multipliers (gen_penalty_polish
    only — box_penalty_polish reads multipliers off the stationarity
    identity, which is exact to ~eps).

    The accumulation ``l += w (Gx - h)`` carries absolute rounding noise
    ~w * eps per outer pass, so testing ``lam >= -eps_abs`` rejects (or
    releases) on pure noise in f32 (measured: lam reads of -2e-3 at w=1e4
    on correctly-pinned rows).  A wrongly-pinned row whose TRUE multiplier
    is below this floor displaces x by only ~|lam| / sigma(Q), i.e. under
    ~1e-3 on equilibrated data — within the polish's accuracy target — so
    accepting such rows is safe."""
    w = 1e3 if dtype == jnp.float32 else 1e6
    return 4.0 * w * float(jnp.finfo(dtype).eps)


def box_penalty_polish(Q, p, A, b, lb, ub, act_lo, act_hi,
                       refine_steps: int = 3) -> PolishResult:
    """Penalty-pinned re-solve of ``min 1/2 x'Qx + p'x, Ax = b`` with the
    ``act_lo``/``act_hi`` coordinates pulled onto their bound.

    ``lb``/``ub`` may be infinite OFF the active sets (the inactive
    contribution is masked out before any multiply, so no 0 * inf NaNs).
    Refinement corrects through the FULL reduced KKT system (Hinv + the
    A-Schur pieces), so the polished point satisfies ``Ax = b`` to solve
    precision — an Hinv-only correction left an ~4e-5 equality drift in
    f32 that made acceptance tests reject otherwise-excellent points.
    """
    dtype = Q.dtype
    w = _penalty_weight(dtype)
    zero = jnp.zeros((), dtype)
    w_lo = jnp.where(act_lo, w, zero)
    w_hi = jnp.where(act_hi, w, zero)
    lb_act = jnp.where(act_lo, lb, zero)
    ub_act = jnp.where(act_hi, ub, zero)

    n = Q.shape[-1]
    eye = jnp.eye(n, dtype=dtype)
    Hinv = spd_inverse_fast(Q + eye * (w_lo + w_hi)[..., None, :])
    if A is not None:
        At = jnp.swapaxes(A, -1, -2)
        W = jnp.einsum("...ij,...jk->...ik", Hinv, At,
                       preferred_element_type=dtype)
        S = jnp.einsum("...ij,...jk->...ik", A, W,
                       preferred_element_type=dtype)
        Sinv = spd_inverse(S)

    # Augmented-Lagrangian outer loop: a pure penalty leaves the active
    # coordinates OFF their bound by lam/w (~1e-8 f64); each multiplier
    # update below contracts that bias by another factor ~1/w, so two
    # passes reach working precision.  The inner refinement pass corrects
    # the floating-point error of solving through Hinv at condition ~w.
    l_lo = jnp.zeros_like(p)
    l_hi = jnp.zeros_like(p)
    x = y = None
    for _ in range(max(refine_steps, 1)):
        rhs = -p + w_lo * lb_act + w_hi * ub_act + l_lo - l_hi
        if A is None:
            x, y = _mv(Hinv, rhs), None
        else:
            t = _mv(Hinv, rhs)
            y = _mv(Sinv, _mv(A, t) - b)
            x = t - _mv(W, y)
        # Two full-KKT refinement passes: the raw solve carries a residual
        # of ~cond(H)*eps*||rhs|| with ||rhs|| ~ w, i.e. O(1) absolute;
        # each pass contracts it by cond(H)*eps, so two reach ~eps
        # absolute — in BOTH the stationarity and the equality rows.
        for _ in range(2):
            resid_x = rhs - _mv(Q, x) - (w_lo + w_hi) * x
            if A is None:
                x = x + _mv(Hinv, resid_x)
            else:
                resid_x = resid_x - _mtv(A, y)
                resid_b = b - _mv(A, x)
                t = _mv(Hinv, resid_x)
                dy = _mv(Sinv, _mv(A, t) - resid_b)
                x = x + t - _mv(W, dy)
                y = y + dy
        l_lo = l_lo + w_lo * (lb_act - x)
        l_hi = l_hi + w_hi * (x - ub_act)

    # Return multipliers READ OFF the stationarity identity at the
    # polished point (lam_lo - lam_hi = Qx + p + A'y on the active set)
    # instead of the accumulated AL estimates: the accumulation carries a
    # w*eps absolute error (the w*(x - bound) update amplifies the
    # rounding of x - bound), ~2e-10 in f64; the direct read costs one GEMV
    # and makes stationarity exact by construction.  A coordinate active
    # on BOTH sides (lb == ub pin) legitimately takes either sign, split
    # by relu; a single-sided NEGATIVE read means the active-set guess
    # was wrong there — callers reject on it.
    s = _mv(Q, x) + p
    if A is not None:
        s = s + _mtv(A, y)
    both = act_lo & act_hi
    zv = jnp.zeros_like(p)
    lam_lo = jnp.where(act_lo, jnp.where(both, jnp.maximum(s, zv), s), zv)
    lam_hi = jnp.where(act_hi, jnp.where(both, jnp.maximum(-s, zv), -s), zv)
    return PolishResult(x=x, y=y, lam_lo=lam_lo, lam_hi=lam_hi)


class GenPolishResult(NamedTuple):
    x: jnp.ndarray
    y: Optional[jnp.ndarray]   # equality dual (None when A is None)
    lam: jnp.ndarray           # AL multipliers; negative => wrong guess


def gen_penalty_polish(Q, p, A, b, G, h, act,
                       refine_steps: int = 3) -> GenPolishResult:
    """General-inequality variant: pin the ``act`` rows of ``G x <= h`` as
    equalities by penalty (``H = Q + w G_act' G_act``) + AL updates.

    Unlike the box case the inequality multipliers cannot be read off the
    stationarity identity per row (G mixes coordinates; the read would be
    a per-element least-squares), so the returned ``lam`` is the
    accumulated AL estimate — accurate to ~w*eps absolutely, and negative
    on rows where the active-set guess was wrong.
    """
    dtype = Q.dtype
    w = _penalty_weight(dtype)
    zero = jnp.zeros((), dtype)
    wa = jnp.where(act, w, zero)                      # (B, m)
    h_act = jnp.where(act, h, zero)

    Gw = G * wa[..., :, None]                         # diag(wa) G
    H = Q + jnp.einsum("...mi,...mj->...ij", Gw, G,
                       preferred_element_type=dtype)
    Hinv = spd_inverse_fast(H)
    if A is not None:
        At = jnp.swapaxes(A, -1, -2)
        W = jnp.einsum("...ij,...jk->...ik", Hinv, At,
                       preferred_element_type=dtype)
        S = jnp.einsum("...ij,...jk->...ik", A, W,
                       preferred_element_type=dtype)
        Sinv = spd_inverse(S)

    l = jnp.zeros_like(h)
    x = y = None
    for _ in range(max(refine_steps, 1)):
        # Stationarity of the AL subproblem: Qx + p + A'y
        #   + G'[act * (l + w (Gx - h))] = 0.
        gl = _mtv(G, wa * h_act - jnp.where(act, l, zero))
        rhs = -p + gl
        if A is None:
            x, y = _mv(Hinv, rhs), None
        else:
            t = _mv(Hinv, rhs)
            y = _mv(Sinv, _mv(A, t) - b)
            x = t - _mv(W, y)
        # Full-KKT refinement (stationarity AND equality rows; see
        # box_penalty_polish — Hinv-only correction drifts off Ax = b).
        for _ in range(2):
            resid_x = rhs - _mv(Q, x) - _mtv(G, wa * _mv(G, x))
            if A is None:
                x = x + _mv(Hinv, resid_x)
            else:
                resid_x = resid_x - _mtv(A, y)
                resid_b = b - _mv(A, x)
                t = _mv(Hinv, resid_x)
                dy = _mv(Sinv, _mv(A, t) - resid_b)
                x = x + t - _mv(W, dy)
                y = y + dy
        l = l + wa * (_mv(G, x) - h_act)
    return GenPolishResult(x=x, y=y, lam=jnp.where(act, l, zero))
