"""Batched box-QP ADMM solver — forward pass.

Solves (batched over a leading axis, all shapes static):

    x* = argmin_x  0.5 x'Qx + p'x
         s.t.      A x = b          (optional equality constraints)
                   lb <= x <= ub    (box, entries may be +/-inf)

Functional parity with the reference forward solver
(``torch_solve_box_qp``, solve_box_qp_admm_torch.py:108-333): same ADMM
iteration, Jacobi scaling with quantile-blended beta, OSQP-style stopping
test on unscaled residuals, per-element adaptive rho with refactorization,
and dual extraction.  The *mechanics* are accelerator-first instead of a
port:

- The whole solve is one ``lax.while_loop`` compiled on device.  The
  reference's host-side Python loop, ``.item()`` convergence sync and
  refactorization branches (solve_box_qp_admm_torch.py:235-313) become traced
  control flow — zero host<->device round trips.
- The per-iteration KKT solve is a single batched GEMV against a
  precomputed reduced-KKT inverse (see ops/linalg.py) instead of an
  ``lu_solve``: dense, static, batched work.
- Adaptive-rho refactorization runs in an outer loop body that is only
  entered on the (rare) checks that actually update rho.
- Early exit is a global ``jnp.all`` in the while condition — the same
  lock-step semantics as the reference's batchwide stopping rule
  (solve_box_qp_admm_torch.py:309-312), without the host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lqp_py_tpu.config import BoxQPConfig
from lqp_py_tpu.ops import anderson
from lqp_py_tpu.ops import linalg as lin
from lqp_py_tpu.ops import scaling as sca
from lqp_py_tpu.ops.precision import solver_precision
from lqp_py_tpu.types import BoxQPSolution, as_vector
from lqp_py_tpu.utils import pytree

_ZERO_CLAMP = 1e-16


def _inf_norm(v):
    return jnp.max(jnp.abs(v), axis=-1)


class _LoopState(NamedTuple):
    it: jax.Array                  # () int32 — iterations executed
    x: jax.Array
    z: jax.Array
    u: jax.Array
    last_r: jax.Array              # rhs that produced the current x
    rho: jax.Array                 # (B,)
    factors: lin.KKTFactors
    q: jax.Array                   # constant term of the x-update GEMV
    primal_error: jax.Array        # (B,) unscaled
    dual_error: jax.Array          # (B,)
    tolp_norm: jax.Array           # (B,) relative-tolerance normalizers
    told_norm: jax.Array           # (B,)
    do_rho_update: jax.Array       # (B,) bool
    is_optimal: jax.Array          # (B,) bool
    u_chk: jax.Array               # (B, n) u at the previous check (unpadded)
    nu_chk: "Optional[jax.Array]"  # (B, m) nu at the previous check
    pinf: jax.Array                # (B,) bool — infeasibility certificate
    #: (B,) bool — elements whose rho must update now; makes the inner
    #: while exit so the refactorization runs in the outer loop body.
    rho_pending: jax.Array = None
    #: (K, 3) residual-trace ring buffer [it, max primal, max dual] and its
    #: write counter (None / () int32 when config.residual_trace == 0).
    trace: "Optional[jax.Array]" = None
    n_chk: "Optional[jax.Array]" = None
    #: Anderson-acceleration state over v = [z; u] (None when
    #: config.acceleration == 0) — see ops/anderson.py.
    aa: "Optional[anderson.AAState]" = None


def _prep(Q, p, A, b, lb, ub, config, pad: int = 0):
    """Canonicalize shapes, compute the unscaled p-norm, scale, pick rho.

    With ``pad > 0`` the returned ``sp.Q`` (and ``sp.A``'s columns) come
    back already padded — the scale and the pad fuse into one HBM
    pass (ops/scaling.py ``_scale_pad_q``), saving a full (B, n, n)
    round-trip vs scaling then padding."""
    # Q is semantically symmetric; symmetrize defensively (opt-out knob) so
    # the solver's output — and therefore every gradient (implicit and
    # unrolled) — is a well-defined function on the symmetric manifold.
    Q = jnp.asarray(Q)
    if config.symmetrize:
        Q = 0.5 * (Q + jnp.swapaxes(Q, -1, -2))
    dtype = Q.dtype
    p = as_vector(p, "p").astype(dtype)
    A = None if A is None else jnp.asarray(A, dtype)
    b = None if b is None else as_vector(b, "b").astype(dtype)
    B, n = p.shape
    if lb is None:
        lb = jnp.full((B, n), -jnp.inf, dtype)
    else:
        lb = as_vector(lb, "lb").astype(dtype)
    if ub is None:
        ub = jnp.full((B, n), jnp.inf, dtype)
    else:
        ub = as_vector(ub, "ub").astype(dtype)

    # p-norm for the dual tolerance is computed on the *unscaled* p
    # (reference computes it before scaling, solve_box_qp_admm_torch.py:127).
    p_norm = _inf_norm(p)

    if config.scale:
        sp = sca.scale_problem(Q, p, A, b, lb, ub, beta=config.beta,
                               pad=pad)
    else:
        sp = sca.identity_scaling(Q, p, A, b, lb, ub, pad=pad)

    # rho selection: ||Q'||_F / sqrt(n) per element, clamped
    # (solve_box_qp_admm_torch.py:200-203).  Forced to zero when there is no
    # finite bound anywhere in the batch — the box projection is then the
    # identity and ADMM converges in one iteration
    # (solve_box_qp_admm_torch.py:156-158).
    if config.rho is None:
        # The identity pad block contributes exactly ``pad`` to sum(Q^2).
        q_fro = jnp.sqrt(jnp.maximum(
            jnp.sum(sp.Q * sp.Q, axis=(-1, -2)) - pad, 0.0))
        rho = jnp.clip(config.rho_scale * q_fro
                       / jnp.sqrt(jnp.asarray(n, dtype)),
                       config.rho_min, config.rho_max)
    else:
        rho = jnp.full((B,), config.rho, dtype)
    any_ineq = jnp.logical_or(jnp.max(lb) > -jnp.inf, jnp.min(ub) < jnp.inf)
    rho = jnp.where(any_ineq, rho, jnp.zeros_like(rho))

    return sp, p_norm, rho, (B, n, dtype)


def _prep_h(Q, p, A, b, lb, ub, config, pad: int = 0):
    """Fused variant of ``_prep`` for the direct solve path: emits the
    padded factorization operand ``H = D Q D + rho I`` in a single
    build pass (ops/scaling.py ``scale_problem_h``) instead of
    materializing the scaled Q and shifting it later — two fewer
    (B, n, n) HBM round trips per solve.  The auto-rho uses the vector
    quadratic form ``||D Q D||_F = sqrt(d2'(Q∘Q)d2)``, numerically equal
    to the reference's Frobenius norm of the scaled operand
    (solve_box_qp_admm_torch.py:200-203)."""
    Q = jnp.asarray(Q)
    if config.symmetrize:
        Q = 0.5 * (Q + jnp.swapaxes(Q, -1, -2))
    dtype = Q.dtype
    p = as_vector(p, "p").astype(dtype)
    A = None if A is None else jnp.asarray(A, dtype)
    b = None if b is None else as_vector(b, "b").astype(dtype)
    B, n = p.shape
    if lb is None:
        lb = jnp.full((B, n), -jnp.inf, dtype)
    else:
        lb = as_vector(lb, "lb").astype(dtype)
    if ub is None:
        ub = jnp.full((B, n), jnp.inf, dtype)
    else:
        ub = as_vector(ub, "ub").astype(dtype)

    p_norm = _inf_norm(p)
    any_ineq = jnp.logical_or(jnp.max(lb) > -jnp.inf, jnp.min(ub) < jnp.inf)

    def rho_fn(D, q_fro):
        if config.rho is None:
            r = jnp.clip(config.rho_scale * q_fro
                         / jnp.sqrt(jnp.asarray(n, dtype)),
                         config.rho_min, config.rho_max)
        else:
            r = jnp.full((B,), config.rho, dtype)
        return jnp.where(any_ineq, r, jnp.zeros_like(r))

    sph, rho = sca.scale_problem_h(Q, p, A, b, lb, ub, rho_fn,
                                   beta=config.beta, pad=pad,
                                   scale=config.scale)
    return sph, p_norm, rho, (B, n, dtype)


@solver_precision
def solve_box_qp(Q, p, A=None, b=None, lb=None, ub=None,
                 config: BoxQPConfig = BoxQPConfig(),
                 warm_start=None) -> BoxQPSolution:
    """Forward box-QP solve.  Not differentiable by itself — use the layer
    API (``lqp_py_tpu.models.layers``) for implicit/unrolled gradients.

    Shapes: Q (B,n,n); p/lb/ub (B,n) or (B,n,1); A (B,m,n); b (B,m)/(B,m,1).

    ``warm_start``: optional previous ``BoxQPSolution`` (or any object with
    ``x``, ``z``, ``u`` in unscaled (B, n) layout) used to initialize the
    iterates — a solve/update/re-solve workflow the reference's BoxQPTH
    class hints at but never implements (it always cold-starts from zeros,
    solve_box_qp_admm_torch.py:221-223).
    """
    # Scale, pad AND rho-shift in one fused pass: _prep_h returns the
    # factorization operand H (and A's columns) already at the
    # aligned size _solve_scaled factorizes at.
    nv = as_vector(p, "p").shape[-1]
    sph, p_norm, rho0, (B, n, dtype) = _prep_h(Q, p, A, b, lb, ub, config,
                                               pad=_padded_n(nv) - nv)
    return _solve_scaled(config, sph.H, sph.p, sph.A, sph.b, sph.lb,
                         sph.ub, sph.D, sph.E, p_norm, rho0, None,
                         warm_start)


@pytree.dataclass
class BoxQPPrepared:
    """p-independent state of a box-QP family: scaled data + KKT factors.

    Produced by ``prepare_box_qp``; consumed by ``solve_box_qp_prepared``.
    In serving / MPC workloads where Q, A, b and the bounds are fixed and
    only p changes between solves, this skips the scaling + factorization
    (the dominant prep cost) on every call — combined with ``warm_start``
    the per-solve work collapses to the ADMM iterations themselves.

    ``H`` is the padded factorization operand ``D Q D + rho0 I``
    (the same fused-build object the direct solve path uses, so prepared
    and direct solves share one computation graph bit-for-bit); the
    scaled Q itself is not stored — consumers that need it (polish)
    reconstruct ``H[:, :n, :n] - rho0 I``.

    ``mode`` records the ``kkt_solver`` the factors were built for (static
    pytree metadata, so the object stays a valid jit argument); mixing it
    with a different solve-time config raises instead of dereferencing a
    None factor deep inside the loop.
    """
    H: jax.Array
    As: Optional[jax.Array]
    bs: Optional[jax.Array]
    lbs: jax.Array
    ubs: jax.Array
    D: jax.Array
    E: Optional[jax.Array]
    rho0: jax.Array
    factors: lin.KKTFactors
    mode: str = pytree.static_field(default="inverse")


def _mode(config) -> str:
    mode = config.kkt_solver
    if mode not in ("inverse", "cholesky"):
        raise ValueError(f"unknown kkt_solver {mode!r}")
    return mode


#: Alignment of the variable axis: the factorization's Schur recursion
#: works on multiples of 128 (ops/linalg.py _LEAF), so the solver pads
#: once, at build time, and every hot-loop operand keeps that size.
_ALIGN = 128


def _padded_n(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@solver_precision
def prepare_box_qp(Q, A=None, b=None, lb=None, ub=None,
                   config: BoxQPConfig = BoxQPConfig()) -> BoxQPPrepared:
    """Precompute everything that does not depend on ``p``: scaling,
    auto-rho, and the KKT factorization."""
    p0 = jnp.zeros(jnp.asarray(Q).shape[:-1], jnp.asarray(Q).dtype)
    mode = _mode(config)
    # Same fused scale+pad+rho-shift build as the direct solve path
    # (_prep_h), so a prepared solve reproduces a direct solve
    # bit-for-bit and the cached operand is consumed without any
    # per-solve pad copy.
    n = p0.shape[-1]
    sph, _p_norm, rho0, (_B, n, _dtype) = _prep_h(Q, p0, A, b, lb, ub,
                                                  config,
                                                  pad=_padded_n(n) - n)
    factors = lin.factorize_kkt(sph.H, None, sph.A, mode=mode,
                                equilibrate=not config.scale)
    return BoxQPPrepared(H=sph.H, As=sph.A, bs=sph.b, lbs=sph.lb,
                         ubs=sph.ub, D=sph.D, E=sph.E, rho0=rho0,
                         factors=factors, mode=mode)


@solver_precision
def solve_box_qp_prepared(prep: BoxQPPrepared, p,
                          config: BoxQPConfig = BoxQPConfig(),
                          warm_start=None) -> BoxQPSolution:
    """Solve for a new cost vector ``p`` against a cached preparation."""
    if prep.mode != _mode(config):
        raise ValueError(
            f"BoxQPPrepared was built with kkt_solver={prep.mode!r} but the "
            f"solve config requests {config.kkt_solver!r}; re-run "
            f"prepare_box_qp with the matching config")
    pv = as_vector(p, "p").astype(prep.H.dtype)
    p_norm = _inf_norm(pv)
    ps = prep.D * pv
    return _solve_scaled(config, prep.H, ps, prep.As, prep.bs,
                         prep.lbs, prep.ubs, prep.D, prep.E,
                         p_norm, prep.rho0, prep.factors, warm_start)


def _solve_scaled(config, H0, ps, As, bs, lbs, ubs, D, E,
                  p_norm, rho0, factors_in, warm_start) -> BoxQPSolution:
    """The ADMM loop on an already-scaled, already-factorized problem.

    ``H0``: the pre-built, padded factorization operand ``D Q D + rho0 I``
    from the fused prep path (``_prep_h``).  The scaled Q is reconstructed
    from it only where actually needed (the polish path), and adaptive-rho
    refactorization shifts H0's leading diagonal."""
    B, n = ps.shape
    dtype = ps.dtype
    cs = config.resolved_check_interval(n)
    adaptive_interval = config.resolved_adaptive_interval(n)
    max_iters = int(config.max_iters)

    mode = _mode(config)

    # The factorization runs at the padded size directly (identity-padded
    # Q, zero-padded A columns, both built padded by _prep_h), so no
    # pad/slice copies surround it — in particular the adaptive-rho
    # refactorization inside the loop produces already-padded factors.
    # Padded coordinates are inert: p = 0, bounds +/-inf, zero initial
    # state => r_pad = 0 and x, z, u stay exactly 0 there by induction.
    # Only the (B, n) vectors are padded here (cheap).
    n_pad = H0.shape[-1]
    pad = n_pad - n
    if pad:
        ps_p = jnp.pad(ps, ((0, 0), (0, pad)))
        lbs_p = jnp.pad(lbs, ((0, 0), (0, pad)),
                        constant_values=-jnp.inf)
        ubs_p = jnp.pad(ubs, ((0, 0), (0, pad)),
                        constant_values=jnp.inf)
    else:
        ps_p, lbs_p, ubs_p = ps, lbs, ubs
    As_u = As if (As is None or As.shape[-1] == n) else As[:, :, :n]

    def _q_of(f):
        """Constant GEMV offset q for (padded) factors."""
        op = lin.kkt_step_operator(f, bs)
        if op is not None:
            _, q = op
        else:
            q = jnp.zeros((B, n_pad), dtype)
        return q

    # Refactorization shifts H0's leading-n diagonal.  The pad block's
    # identity diagonal is deliberately excluded: a downward rho move
    # would otherwise push the decoupled pad pivots toward zero or
    # negative.
    idx_pad = jnp.arange(n_pad)
    eye_upd = ((idx_pad[:, None] == idx_pad[None, :])
               & (idx_pad[:, None] < n)).astype(dtype)

    def factorize(rho):
        # equilibrate=False when the solver scaling already ran: H0 is
        # Jacobi-equilibrated, so the extra diag-rescale passes in
        # spd_inverse_fast buy no accuracy.
        Hr = H0 + (rho - rho0)[:, None, None] * eye_upd
        f = lin.factorize_kkt(Hr, None, As, mode=mode,
                              equilibrate=not config.scale)
        return f, _q_of(f)

    if factors_in is None:
        # Initial factorization consumes H0 directly (no zero-shift
        # elementwise pass).
        factors0 = lin.factorize_kkt(H0, None, As, mode=mode,
                                     equilibrate=not config.scale)
    else:
        factors0 = factors_in            # cached by prepare_box_qp
    q0 = _q_of(factors0)

    # Over-relaxation: with no finite bounds anywhere, the projection is the
    # identity and rho is forced to 0 — the plain iteration converges in one
    # step (solve_box_qp_admm_torch.py:156-158) while a relaxed one would
    # only approach it geometrically, so alpha collapses to 1 there.
    has_alpha = float(config.alpha) != 1.0
    any_finite = (jnp.max(lbs) > -jnp.inf) | (jnp.min(ubs) < jnp.inf)
    alpha_t = (jnp.where(any_finite, jnp.asarray(config.alpha, dtype),
                         jnp.ones((), dtype))
               if has_alpha else jnp.ones((), dtype))

    def x_update(st_factors, q, r):
        if mode == "inverse":
            # Implicit P: one dense GEMV + two rank-n_eq corrections
            # (x = Hinv r - WS (W^T r) + q) — same HBM traffic as a
            # materialized P without ever building it.
            y = jnp.einsum("bij,bj->bi", st_factors.Hinv, r,
                           preferred_element_type=dtype)
            if st_factors.W is not None:
                wtr = jnp.einsum("bim,bi->bm", st_factors.W, r,
                                 preferred_element_type=dtype)
                y = y - jnp.einsum("bim,bm->bi", st_factors.WS, wtr,
                                   preferred_element_type=dtype)
            return y + q
        x, _ = lin.kkt_apply(st_factors, r, bs)
        return x

    m_aa = int(config.acceleration)

    zeros = jnp.zeros((B, n_pad), dtype)
    if warm_start is not None:
        # Map the previous (unscaled) iterates into the current scaling.
        def _w(v, scale_mul):
            v = as_vector(v, "warm_start").astype(dtype) * scale_mul
            return jnp.pad(v, ((0, 0), (0, pad))) if pad else v
        x_ws = _w(warm_start.x, 1.0 / D)
        z_ws = _w(warm_start.z, 1.0 / D)
        u_ws = _w(warm_start.u, D)
    else:
        x_ws = z_ws = u_ws = zeros
    init = _LoopState(
        it=jnp.zeros((), jnp.int32),
        x=x_ws, z=z_ws, u=u_ws, last_r=-ps_p,
        rho=rho0, factors=factors0, q=q0,
        primal_error=jnp.full((B,), jnp.inf, dtype),
        dual_error=jnp.full((B,), jnp.inf, dtype),
        tolp_norm=jnp.ones((B,), dtype),
        told_norm=jnp.ones((B,), dtype),
        do_rho_update=jnp.full((B,), bool(config.adaptive_rho)),
        is_optimal=jnp.zeros((B,), bool),
        u_chk=(u_ws[:, :n] if pad else u_ws),
        nu_chk=None if As is None else jnp.zeros((B, As.shape[-2]), dtype),
        # Crossed bounds (lb > ub) make the box itself empty — a direct
        # data check, not a dual certificate (OSQP rejects this as invalid
        # input; with traced arrays we flag it instead).
        pinf=(jnp.any(lbs > ubs, axis=-1)
              if config.detect_infeasibility else jnp.zeros((B,), bool)),
        rho_pending=jnp.zeros((B,), bool),
        trace=(jnp.full((int(config.residual_trace), 3), -1.0, dtype)
               if config.residual_trace else None),
        n_chk=(jnp.zeros((), jnp.int32)
               if config.residual_trace else None),
        aa=anderson.aa_init(B, m_aa, 2 * n_pad, dtype) if m_aa else None,
    )

    eps_abs = max(float(config.eps_abs), 1e-12)
    eps_rel = max(float(config.eps_rel), 1e-12)

    def _rho_ratio(st: _LoopState):
        """Reference adaptive-rho signal: sqrt(primal_ratio / dual_ratio)
        from the residuals stored at the last check
        (solve_box_qp_admm_torch.py:237-245)."""
        num = jnp.maximum(st.primal_error / st.tolp_norm, _ZERO_CLAMP)
        den = jnp.maximum(st.dual_error / st.told_norm, _ZERO_CLAMP)
        return jnp.sqrt(num / den)

    def check_block(st: _LoopState) -> _LoopState:
        # The first residual check happens after a single iteration (the
        # reference checks at i == 0); afterwards every ``cs`` iterations.
        n_inner = jnp.where(st.it == 0, 1, cs)
        n_inner = jnp.minimum(n_inner, max_iters - st.it)

        def inner(_, s):
            x, z, u, z_prev, _r = s
            r = -ps_p + st.rho[..., None] * (z - u)
            x = x_update(st.factors, st.q, r)
            z_prev = z
            xh = alpha_t * x + (1.0 - alpha_t) * z if has_alpha else x
            z = jnp.clip(xh + u, lbs_p, ubs_p)
            u = u + (xh - z)
            return (x, z, u, z_prev, r)

        def inner_aa(i, s):
            """ADMM iteration + safeguarded Anderson step on the
            fixed-point variable v = [z; u] (see ops/anderson.py).
            Padded coordinates stay exactly 0: every history column is 0
            there, so any combination is too."""
            x, z, u, z_prev, _r, aa = s
            r = -ps_p + st.rho[..., None] * (z - u)
            x = x_update(st.factors, st.q, r)
            xh = alpha_t * x + (1.0 - alpha_t) * z if has_alpha else x
            z_new = jnp.clip(xh + u, lbs_p, ubs_p)
            u_new = u + (xh - z_new)
            v = jnp.concatenate([z, u], axis=-1)
            gv = jnp.concatenate([z_new, u_new], axis=-1)
            v_next, aa = anderson.aa_step(
                aa, v, gv, ((st.it + i) % m_aa).astype(jnp.int32),
                hold=st.is_optimal,
                safeguard=float(config.aa_safeguard),
                reg=float(config.aa_reg),
                max_weight=float(config.aa_max_weight))
            return (x, v_next[:, :n_pad], v_next[:, n_pad:], z, r, aa)

        r0 = -ps_p + st.rho[..., None] * (st.z - st.u)
        if m_aa:
            x, z, u, z_prev, last_r, aa = jax.lax.fori_loop(
                0, n_inner, inner_aa,
                (st.x, st.z, st.u, st.z, r0, st.aa))
        else:
            x, z, u, z_prev, last_r = jax.lax.fori_loop(
                0, n_inner, inner, (st.x, st.z, st.u, st.z, r0))
            aa = st.aa
        if pad:
            xs_c, zs_c, us_c, zp_c = (v[:, :n] for v in (x, z, u, z_prev))
        else:
            xs_c, zs_c, us_c, zp_c = x, z, u, z_prev

        # The equality duals implied by the current factored solve —
        # needed by the Qx identity below and by the infeasibility
        # certificate (n_eq-sized ops; W's padded rows are zero).
        nu_s = None
        if As is not None:
            Wt_r = jnp.einsum("bim,bi->bm", st.factors.W, last_r,
                              preferred_element_type=dtype)
            nu_s = jnp.einsum("bmk,bk->bm", st.factors.Sinv, Wt_r - bs,
                              preferred_element_type=dtype)

        # --- OSQP-style stopping test on unscaled residuals
        # (solve_box_qp_admm_torch.py:285-311).
        s_dual = st.rho[..., None] * (zs_c - zp_c)
        primal_error = _inf_norm(D * (xs_c - zs_c))
        dual_error = _inf_norm(D * s_dual)
        x_norm = _inf_norm(D * xs_c)
        z_norm = _inf_norm(D * zs_c)
        y_norm = _inf_norm(st.rho[..., None] * D * us_c)
        # Qx via the KKT identity instead of a (B, n, n) GEMV: the solve
        # satisfies (Q + rho I) x + A^T nu = r, so
        # Qx = r - rho x - A^T nu to the factorization's accuracy (~1e-6
        # relative) — plenty for a tolerance NORMALIZER (Qx only enters
        # told_norm), and it saves a full HBM pass over Q per check.
        Qx = last_r[:, :n] - st.rho[..., None] * xs_c
        if As is not None:
            Qx = Qx - jnp.einsum("bmi,bm->bi", As_u, nu_s,
                                 preferred_element_type=dtype)
        Qx_norm = _inf_norm(Qx / D)

        tolp_norm = jnp.maximum(jnp.maximum(x_norm, z_norm), _ZERO_CLAMP)
        tol_primal = eps_abs + eps_rel * tolp_norm
        told_norm = jnp.maximum(
            jnp.maximum(jnp.maximum(y_norm, Qx_norm), p_norm), _ZERO_CLAMP)
        tol_dual = eps_abs + eps_rel * told_norm

        is_optimal = (primal_error < tol_primal) & (dual_error < tol_dual)

        # --- OSQP-style primal-infeasibility certificate (Banjac et al.
        # 2019): over a check interval, the successive dual differences
        # (d_nu, d_lambda) of an infeasible problem converge to a
        # separating functional:  A^T d_nu + d_lambda -> 0  with negative
        # support  b'd_nu + ub'[d_lambda]_+ + lb'[d_lambda]_- < 0.
        # All tests in UNSCALED units; the D factors cancel in the support
        # terms (ub_us * [dl_us]_+ = ubs * rho [du]_+ elementwise).
        pinf = st.pinf
        u_chk = us_c
        nu_chk = st.nu_chk
        if config.detect_infeasibility:
            eps_inf = jnp.asarray(config.eps_infeas, dtype)
            du = us_c - st.u_chk
            dlam_us = st.rho[..., None] * du / D
            if As is not None:
                dnu = nu_s - st.nu_chk
                cert = (jnp.einsum("bmi,bm->bi", As_u, dnu,
                                   preferred_element_type=dtype)
                        + st.rho[..., None] * du) / D
                dual_scale = jnp.maximum(_inf_norm(dlam_us),
                                         _inf_norm(dnu * E))
                support = jnp.sum(bs * dnu, axis=-1)
                nu_chk = nu_s
            else:
                cert = dlam_us
                dual_scale = _inf_norm(dlam_us)
                support = jnp.zeros((B,), dtype)
            dup = st.rho[..., None] * jnp.maximum(du, 0.0)
            dun = st.rho[..., None] * jnp.minimum(du, 0.0)
            # An infinite bound has zero-support only if the direction has
            # no mass there (0 * inf would be NaN, hence the wheres).
            sup_ub = jnp.where(jnp.isfinite(ubs), ubs * dup,
                               jnp.where(dup > 0, jnp.inf, 0.0))
            sup_lb = jnp.where(jnp.isfinite(lbs), lbs * dun,
                               jnp.where(dun < 0, jnp.inf, 0.0))
            support = support + jnp.sum(sup_ub + sup_lb, axis=-1)
            pinf_el = ((_inf_norm(cert) <= eps_inf * dual_scale)
                       & (support <= -eps_inf * dual_scale)
                       & (dual_scale > _ZERO_CLAMP))
            pinf = st.pinf | (pinf_el & ~is_optimal)

        thr = jnp.asarray(config.adaptive_rho_threshold, dtype)
        do_rho_update = ((primal_error > jnp.maximum(tol_primal, thr))
                         | (dual_error > jnp.maximum(tol_dual, thr)))

        it_new = st.it + n_inner
        trace, n_chk = st.trace, st.n_chk
        if config.residual_trace:
            K = int(config.residual_trace)
            row = jnp.stack([it_new.astype(dtype),
                             jnp.max(primal_error), jnp.max(dual_error)])
            trace = jax.lax.dynamic_update_slice(
                trace, row[None], (n_chk % K, jnp.zeros((), jnp.int32)))
            n_chk = n_chk + 1
        st = st._replace(
            it=it_new, x=x, z=z, u=u, last_r=last_r,
            primal_error=primal_error, dual_error=dual_error,
            tolp_norm=tolp_norm, told_norm=told_norm,
            do_rho_update=do_rho_update, is_optimal=is_optimal,
            u_chk=u_chk, nu_chk=nu_chk, pinf=pinf, aa=aa,
            trace=trace, n_chk=n_chk)

        if config.adaptive_rho:
            # Per-element update gate: an element only moves when ITS OWN
            # primal/dual ratio is outside the band.  The reference
            # rescales every non-converged element whenever any element
            # trips (solve_box_qp_admm_torch.py:247-250), which
            # destabilizes elements whose rho is already balanced —
            # measured 31 -> 1191 iterations on the hard dz=500 set with
            # frequent updates.  The pending mask makes the INNER while
            # exit so the refactorization runs unconditionally in the
            # outer loop body — a lax.cond here would copy the full
            # (B, n, n) factors through its no-update branch at every
            # check.
            ratio = _rho_ratio(st)
            tol_r = jnp.asarray(config.adaptive_rho_tol, dtype)
            el_outside = (ratio > tol_r) | (ratio < 1.0 / tol_r)
            window = ((it_new >= adaptive_interval)
                      & (it_new < config.adaptive_rho_max_iter)
                      & ((it_new % adaptive_interval) < cs))
            st = st._replace(
                rho_pending=window & do_rho_update & el_outside)

        if config.verbose:
            jax.debug.print(
                "iter={it}  primal={pe:.3e}  dual={de:.3e}",
                it=it_new,
                pe=jnp.max(primal_error), de=jnp.max(dual_error))
        return st

    def inner_cond(st: _LoopState):
        more = (st.it < max_iters) & ~jnp.all(st.is_optimal | st.pinf)
        if config.adaptive_rho:
            more = more & ~jnp.any(st.rho_pending)
        return more

    st = jax.lax.while_loop(inner_cond, check_block, init)

    if config.adaptive_rho:
        # Reference adaptive-rho rule (solve_box_qp_admm_torch.py:237-256):
        # rho *= sqrt(primal_ratio / dual_ratio), masked per element.  On
        # the reference's own TODO of a cheap diagonal-only update
        # (solve_box_qp_admm_torch.py:251): a rho change shifts the FULL
        # diagonal (rank-n perturbation), so no Woodbury/rank-k update of
        # the factors exists — each genuine update pays one sweep/Schur
        # refactorization.  Two-level loop: the inner
        # while exits when any element is pending, the outer body
        # refactorizes UNCONDITIONALLY (it only runs when inner exited
        # pending) and re-enters the inner loop — zero conditional-copy
        # overhead on checks that do not update (the create family
        # typically triggers none, the hard family a handful).
        def outer_cond(st: _LoopState):
            # True only when inner exited due to a pending rho update
            # (otherwise it/convergence also terminate this loop).
            return (st.it < max_iters) & ~jnp.all(st.is_optimal | st.pinf)

        def outer_body(st: _LoopState) -> _LoopState:
            pending = st.rho_pending
            ratio = _rho_ratio(st)
            rho_new = jnp.where(pending, st.rho * ratio, st.rho)
            rho_new = jnp.clip(rho_new, config.rho_min, config.rho_max)
            f, q = factorize(rho_new)
            st = st._replace(rho=rho_new, factors=f, q=q,
                             rho_pending=jnp.zeros((B,), bool))
            if st.aa is not None:
                # A rho update changes the fixed-point map: force a
                # history reset for the updated elements.
                st = st._replace(aa=anderson.aa_reset_where(st.aa, pending))
            return jax.lax.while_loop(inner_cond, check_block, st)

        st = jax.lax.while_loop(outer_cond, outer_body, st)

    # --- unscale and extract duals (solve_box_qp_admm_torch.py:316-327).
    nus = None
    if As is not None:
        # nu = Sinv (W^T r - b); computed directly from the small Schur
        # factors at the padded size (padded rows of W are zero).
        Wt_r = jnp.einsum("bim,bi->bm", st.factors.W, st.last_r,
                          preferred_element_type=dtype)
        nu_scaled = jnp.einsum("bmk,bk->bm", st.factors.Sinv, Wt_r - bs,
                               preferred_element_type=dtype)
        nus = nu_scaled * E
    if pad:
        st = st._replace(x=st.x[:, :n], z=st.z[:, :n], u=st.u[:, :n])
    zs = st.z
    if m_aa:
        # An accepted Anderson step returns z as an affine combination of
        # clipped iterates (weights sum to 1 but may be negative), so the
        # final z is not box-feasible by construction like the plain
        # path's clip.  Project it: z is the solution's feasible iterate.
        zs = jnp.clip(zs, lbs, ubs)

    xs = st.x
    lam_lo_s = jnp.maximum(-st.u * st.rho[..., None], 0.0)
    lam_hi_s = jnp.maximum(st.u * st.rho[..., None], 0.0)
    if config.polish:
        # OSQP-style active-set polish on the SCALED problem (equivalent —
        # the polished point unscales through the same D/E as the iterate).
        # For the plain path sign-of-u is an exact detector: the box
        # projection leaves u identically 0 on strictly-interior
        # coordinates.  An accepted Anderson step breaks that exactness
        # (u is an affine combination), so the AA path detects off the
        # clipped z instead.
        from lqp_py_tpu.models._polish import box_penalty_polish
        # Reconstruct the scaled Q only here (the one consumer that needs
        # it), one elementwise pass.
        Qs_u = (H0[:, :n, :n]
                - rho0[:, None, None] * jnp.eye(n, dtype=dtype))
        # Proximity at tolerance scale (the scaled problem is equilibrated,
        # so slacks are O(1)).
        prox = 10 * jnp.asarray(config.eps_abs + config.eps_rel, dtype)
        if m_aa:
            # AA's u is an affine combination of iterates (sign noise on
            # truly-inactive coordinates), and exact z == bound misses
            # coordinates whose combination landed just inside: detect by
            # proximity alone.
            act_lo = jnp.isfinite(lbs) & (zs - lbs <= prox)
            act_hi = jnp.isfinite(ubs) & (ubs - zs <= prox)
            # A NARROW (but not pinned) box with ub - lb <= ~2 prox fires
            # both sides; the helper's two-sided penalty would then pull
            # the coordinate to the box MIDPOINT (up to half-width error,
            # measured 5e-4 at width 1e-3) and the relu-split multiplier
            # read can never flag it.  Pin every double-fire AT the
            # iterate's z instead — a trusted value whose error is the
            # plain solve's own; exact lb == ub pins are unchanged by
            # this (z equals both bounds there).
            both = act_lo & act_hi
            lbs_pol = jnp.where(both, zs, lbs)
            ubs_pol = jnp.where(both, zs, ubs)
        else:
            # Sign-of-u alone over-detects: the over-relaxed (alpha != 1)
            # dual update is not a pure projection residual, so a
            # barely-inactive coordinate can carry small nonzero u at
            # tolerance (measured: 3-5 such coordinates per hard-set
            # batch).  Requiring z near the bound as well is exact on the
            # measured seeds.
            act_lo = (st.u < 0) & (zs - lbs <= prox)
            act_hi = (st.u > 0) & (ubs - zs <= prox)
            lbs_pol, ubs_pol = lbs, ubs
        pol = box_penalty_polish(Qs_u, ps, As_u, bs, lbs_pol, ubs_pol,
                                 act_lo, act_hi)
        thr = jnp.asarray(config.eps_abs, dtype)

        def _viol(xv):
            v_lo = jnp.where(jnp.isfinite(lbs), lbs - xv, -jnp.inf)
            v_hi = jnp.where(jnp.isfinite(ubs), xv - ubs, -jnp.inf)
            v = jnp.max(jnp.maximum(v_lo, v_hi), axis=-1)
            if As is not None:
                eq = jnp.einsum("bmi,bi->bm", As_u, xv,
                                preferred_element_type=dtype) - bs
                v = jnp.maximum(v, jnp.max(jnp.abs(eq), axis=-1))
            return v

        # Accept per element only if the polished point is no less
        # feasible than the iterate (with an eps_abs floor) and the
        # implied active multipliers are nonnegative — a negative one
        # means the active-set guess was wrong for that element.
        lam_min = jnp.min(jnp.minimum(pol.lam_lo, pol.lam_hi), axis=-1)
        ok = ((_viol(pol.x) <= jnp.maximum(_viol(st.x), thr))
              & (lam_min >= -thr) & ~st.pinf)
        okc = ok[..., None]
        xs = jnp.where(okc, pol.x, xs)
        zs = jnp.where(okc, jnp.clip(pol.x, lbs, ubs), zs)
        lam_lo_s = jnp.where(okc, jnp.maximum(pol.lam_lo, 0.0), lam_lo_s)
        lam_hi_s = jnp.where(okc, jnp.maximum(pol.lam_hi, 0.0), lam_hi_s)
        if As is not None:
            nus = jnp.where(okc[..., 0][..., None], pol.y * E, nus)

    x = D * xs
    z = D * zs
    # u stays the ADMM iterate's (the warm-start quantity); the reported
    # multipliers are the polished ones when polish accepted.
    u = st.u / D
    lams = jnp.concatenate([lam_lo_s / D, lam_hi_s / D], axis=-1)

    trace = None
    if config.residual_trace:
        # Un-rotate the ring so rows are chronological (oldest first); rows
        # never written stay at iteration -1 (short solves).
        K = int(config.residual_trace)
        shift = jnp.where(st.n_chk <= K, 0, st.n_chk % K)
        trace = jnp.roll(st.trace, -shift, axis=0)

    return BoxQPSolution(
        x=x, z=z, u=u, lams=lams, nus=nus, rho=st.rho,
        iterations=st.it,
        primal_residual=st.primal_error,
        dual_residual=st.dual_error,
        converged=st.is_optimal,
        primal_infeasible=st.pinf,
        residual_trace=trace,
    )


@solver_precision
def solve_box_qp_unrolled(Q, p, A=None, b=None, lb=None, ub=None,
                          config: BoxQPConfig = BoxQPConfig()):
    """Differentiable-by-unrolling box-QP solve (reference ``unroll=True``,
    solve_box_qp_admm_torch.py:13-17, 216-219, 264-266).

    JAX cannot reverse-differentiate a ``while_loop``, so the unrolled
    variant runs a static-length ``lax.scan`` of ``config.unroll_iters``
    iterations (default: min(max_iters, 500)).  Once every element has
    converged (checked each ``check_solved`` interval), further updates are
    frozen so iterates — and therefore gradients — match the early-exited
    solve.  Each in-loop KKT solve back-propagates through cached factors
    via ``kkt_solve_cached`` (the TorchLU equivalent, lu_layer.py:41-58).

    Divergence from the reference: adaptive rho is disabled in unrolled mode
    (a refactorization inside the differentiated scan would store the factor
    stack for backward — O(iters * B * n^2) memory).

    Returns ``x`` only (matching the reference, which returns the bare
    tensor in unroll mode, solve_box_qp_admm_torch.py:328-330).
    """
    if config.acceleration:
        # __post_init__ only rejects the acceleration+unroll FLAG combo;
        # this entry point can be called directly with unroll=False and
        # would otherwise silently run unaccelerated.
        raise ValueError(
            "acceleration is not implemented for the unrolled solver; "
            "use solve_box_qp (the while_loop path) or acceleration=0")
    if config.polish:
        # Same direct-call hazard as acceleration above.
        raise ValueError(
            "polish is not implemented for the unrolled solver; "
            "use solve_box_qp (the while_loop path) or polish=False")
    sp, p_norm, rho0, (B, n, dtype) = _prep(Q, p, A, b, lb, ub, config)
    Qs, ps, As, bs, lbs, ubs, D, E = sp

    has_alpha = float(config.alpha) != 1.0
    any_finite = (jnp.max(lbs) > -jnp.inf) | (jnp.min(ubs) < jnp.inf)
    alpha_t = jnp.where(any_finite, jnp.asarray(config.alpha, dtype),
                        jnp.ones((), dtype))
    cs = config.resolved_check_interval(n)
    n_iters = config.unroll_iters
    if n_iters is None:
        n_iters = min(int(config.max_iters), 500)
    n_outer = max(-(-n_iters // cs), 1)

    eps_abs = max(float(config.eps_abs), 1e-12)
    eps_rel = max(float(config.eps_rel), 1e-12)

    # rho is treated as a constant throughout the unrolled graph: the ADMM
    # fixed point does not depend on rho, and tracking it in the rhs but not
    # in the cached factor (which kkt_solve_cached attributes wholly to Q)
    # would leave a spurious non-cancelling gradient through rho(Q).
    rho_sg = jax.lax.stop_gradient(rho0)
    # stop_gradient BEFORE factorizing: the cached factors receive zero
    # cotangent by design (kkt_solve_cached), and tangents must never enter
    # the factorization itself — its Pallas sweep kernel has no JVP rule.
    factors = lin.factorize_kkt(
        jax.lax.stop_gradient(Qs), rho_sg,
        None if As is None else jax.lax.stop_gradient(As),
        mode=config.kkt_solver)
    rho_col = rho_sg[..., None]

    zeros = jnp.zeros((B, n), dtype)

    @jax.checkpoint
    def body(carry, _):
        x, z, u, done = carry

        def one_iter(x, z, u):
            r = -ps + rho_col * (z - u)
            x_new, _ = lin.kkt_solve_cached(factors, Qs, As, r, bs)
            if has_alpha:
                xh = alpha_t * x_new + (1.0 - alpha_t) * z
            else:
                xh = x_new
            z_new = jnp.clip(xh + u, lbs, ubs)
            u_new = u + (xh - z_new)
            return x_new, z_new, u_new

        # Inner block as a differentiable lax.scan (NOT a python loop: at
        # n=1000 an inlined 10-iteration body makes the serialized HLO
        # large enough to matter for compile time).
        def inner(carry, _):
            x, z, u, z_last = carry
            xn, zn, un = one_iter(x, z, u)
            z_last = jnp.where(done, z_last, z)
            x = jnp.where(done, x, xn)
            z = jnp.where(done, z, zn)
            u = jnp.where(done, u, un)
            return (x, z, u, z_last), None

        (x, z, u, z_last), _ = jax.lax.scan(
            inner, (x, z, u, z), None, length=cs)

        # Convergence bookkeeping (non-differentiable): full OSQP-style
        # primal+dual test, matching the while-loop solver.
        xs, zs, us, zps = (jax.lax.stop_gradient(v)
                           for v in (x, z, u, z_last))
        primal_error = _inf_norm(D * (xs - zs))
        dual_error = _inf_norm(D * (rho_sg[..., None] * (zs - zps)))
        x_norm = _inf_norm(D * xs)
        z_norm = _inf_norm(D * zs)
        y_norm = _inf_norm(rho_sg[..., None] * D * us)
        Qx = jnp.einsum("bij,bj->bi", jax.lax.stop_gradient(Qs), xs,
                        preferred_element_type=dtype)
        Qx_norm = _inf_norm(Qx / D)
        tolp = eps_abs + eps_rel * jnp.maximum(
            jnp.maximum(x_norm, z_norm), _ZERO_CLAMP)
        told = eps_abs + eps_rel * jnp.maximum(
            jnp.maximum(jnp.maximum(y_norm, Qx_norm),
                        jax.lax.stop_gradient(p_norm)), _ZERO_CLAMP)
        done = done | jnp.all((primal_error < tolp) & (dual_error < told))
        return (x, z, u, done), None

    (x, z, u, _done), _ = jax.lax.scan(
        body, (zeros, zeros, zeros, jnp.zeros((), bool)), None, length=n_outer)

    return D * x
