"""Batched general-inequality QP solver (operator splitting).

Solves (batched):

    x* = argmin_x 0.5 x'Qx + p'x   s.t.  Ax = b,  Gx <= h

This is the batched replacement for the reference's SCS baseline
(scs_qp.py:52-118), which loops over the batch in Python and calls the SCS C
solver one problem at a time — the exact anti-pattern a batched accelerator
design avoids (SURVEY.md §2).  Here the whole batch is solved lock-step by an
ADMM/operator-splitting method with slack consensus:

    x-step:  (Q + rho G'G) x = -p + rho G'(h - w + u)   s.t. Ax = b
    s     =  h - Gx
    w     =  max(s + u, 0);     u += s - w

The x-step KKT system is factored once per rho via the Schur-reduced
Cholesky of ops/linalg.py; in 'inverse' mode each iteration is one batched
GEMV plus two G matvecs.  Duals: lambda = rho*u >= 0, nu from the KKT solve.

Backward modes (config.backward):
- 'kkt'   — active-set implicit differentiation (same math as the
            reference's ADMM KKT backward generalized to arbitrary G).
- 'conic' — SCS-style implicit differentiation of the homogeneous
            self-dual projection fixed point (torch_solve_qp_scs_grads,
            scs_qp.py:121-189).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lqp_py_tpu.config import GenQPConfig
from lqp_py_tpu.models import box_qp_grad as bgrads
from lqp_py_tpu.models._stateful import StatefulQP
from lqp_py_tpu.models.conic_grad import conic_qp_grads
from lqp_py_tpu.ops import anderson
from lqp_py_tpu.ops import linalg as lin
from lqp_py_tpu.ops.precision import solver_precision
from lqp_py_tpu.types import QPSolution, as_vector, like_layout
from lqp_py_tpu.utils import pytree

_ZERO_CLAMP = 1e-16


def _mv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v, preferred_element_type=v.dtype)


def _mtv(M, v):
    return jnp.einsum("...ij,...i->...j", M, v, preferred_element_type=v.dtype)


def _inf_norm(v):
    return jnp.max(jnp.abs(v), axis=-1)


def _row_equilibrate(M, rhs):
    norms = jnp.max(jnp.abs(M), axis=-1)
    fill = jnp.maximum(jnp.mean(norms, axis=-1, keepdims=True), 1e-6)
    norms = jnp.where(norms <= 0, jnp.broadcast_to(fill, norms.shape), norms)
    E = 1.0 / norms
    return E[..., :, None] * M, E * rhs, E


class _GenState(NamedTuple):
    it: jax.Array
    x: jax.Array
    w: jax.Array
    u: jax.Array
    nu: Optional[jax.Array]
    rho: jax.Array
    factors: lin.KKTFactors
    primal_error: jax.Array
    dual_error: jax.Array
    tolp_norm: jax.Array
    told_norm: jax.Array
    do_rho_update: jax.Array
    is_optimal: jax.Array
    u_chk: jax.Array
    nu_chk: Optional[jax.Array]
    pinf: jax.Array
    #: Anderson-acceleration state over v = [w; u] (None when
    #: config.acceleration == 0) — see ops/anderson.py.
    aa: Optional["anderson.AAState"] = None


def _gen_prep_key(config: GenQPConfig):
    """The config fields baked into a preparation (scaling + auto-rho +
    factorization).  A solve against cached factors must agree on these —
    the in-loop adaptive refactorization would otherwise silently mix two
    different x-step operators in one solve."""
    return (float(config.sigma), bool(config.scale),
            None if config.rho is None else float(config.rho),
            float(config.rho_scale), float(config.rho_min),
            float(config.rho_max))


@pytree.dataclass
class GenQPPrepared:
    """p-independent state of a general-inequality QP family: scaled data,
    auto-rho and the x-step KKT factorization.

    Produced by ``prepare_qp_gen``; consumed by ``solve_qp_gen_prepared``.
    Same serving/MPC capability as ``prepare_box_qp`` (fixed Q/A/G/h,
    drifting p): skips the scaling + factorization on every call and
    composes with ``warm_start``.  Carries ``GtG`` so the in-loop adaptive
    refactorization still works against the cached scaling.
    """
    Qs: jax.Array
    As: Optional[jax.Array]
    bs: Optional[jax.Array]
    Gs: jax.Array
    hs: jax.Array
    D: jax.Array
    EG: jax.Array
    EA: Optional[jax.Array]
    rho0: jax.Array
    GtG: jax.Array
    factors: lin.KKTFactors
    #: static metadata: the prepare-config fields the factors depend on
    #: (see _gen_prep_key); solve_qp_gen_prepared raises on a mismatch.
    key: tuple = pytree.static_field(default=())


def _gen_prepare(Q, A, b, G, h, config) -> GenQPPrepared:
    """Everything in the forward solve that does not depend on ``p``."""
    if G is None:
        raise ValueError("solve_qp_gen requires G/h; use solve_qp_eqcon")
    Q = jnp.asarray(Q)
    if config.symmetrize:
        Q = 0.5 * (Q + jnp.swapaxes(Q, -1, -2))  # symmetric-manifold input
    dtype = Q.dtype
    G = jnp.asarray(G, dtype)
    h = as_vector(h, "h").astype(dtype)
    A = None if A is None else jnp.asarray(A, dtype)
    b = None if b is None else as_vector(b, "b").astype(dtype)
    B, n = Q.shape[0], Q.shape[-1]
    k = G.shape[-2]

    # --- scaling: Jacobi D from Q columns, row equilibration of A and G.
    if config.scale:
        Q_norm = jnp.max(jnp.abs(Q), axis=-2)
        fill = jnp.maximum(jnp.mean(Q_norm, axis=-1, keepdims=True), 1e-6)
        Q_norm = jnp.where(Q_norm <= 0,
                           jnp.broadcast_to(fill, Q_norm.shape), Q_norm)
        D = jnp.sqrt(1.0 / Q_norm)
        Qs = D[..., :, None] * Q * D[..., None, :]
        Gs, hs, EG = _row_equilibrate(G * D[..., None, :], h)
        if A is not None:
            As, bs, EA = _row_equilibrate(A * D[..., None, :], b)
        else:
            As, bs, EA = None, None, None
    else:
        D = jnp.ones((B, n), dtype)
        EG = jnp.ones((B, k), dtype)
        EA = None if A is None else jnp.ones_like(b)
        Qs, Gs, hs, As, bs = Q, G, h, A, b

    # --- rho selection.
    if config.rho is None:
        q_fro = jnp.sqrt(jnp.sum(Qs * Qs, axis=(-1, -2)))
        rho0 = jnp.clip(config.rho_scale * q_fro
                        / jnp.sqrt(jnp.asarray(n, dtype)),
                        config.rho_min, config.rho_max)
    else:
        rho0 = jnp.full((B,), config.rho, dtype)

    GtG = jnp.einsum("...ki,...kj->...ij", Gs, Gs,
                     preferred_element_type=dtype)
    sigma = jnp.asarray(config.sigma, dtype)
    H = Qs + rho0[..., None, None] * GtG + sigma * jnp.eye(n, dtype=dtype)
    factors0 = lin.factorize_kkt(H, 0.0, As, mode="inverse")
    return GenQPPrepared(Qs=Qs, As=As, bs=bs, Gs=Gs, hs=hs, D=D, EG=EG,
                         EA=EA, rho0=rho0, GtG=GtG, factors=factors0,
                         key=_gen_prep_key(config))


@solver_precision
def prepare_qp_gen(Q, A=None, b=None, G=None, h=None,
                   config: GenQPConfig = GenQPConfig()) -> GenQPPrepared:
    """Precompute the p-independent state (scaling, auto-rho, x-step KKT
    factorization) of a general-inequality QP family for serving."""
    return _gen_prepare(Q, A, b, G, h, config)


@solver_precision
def solve_qp_gen_prepared(prep: GenQPPrepared, p,
                          config: GenQPConfig = GenQPConfig(),
                          warm_start=None) -> QPSolution:
    """Solve for a new cost vector ``p`` against a cached preparation."""
    if prep.key and prep.key != _gen_prep_key(config):
        raise ValueError(
            f"GenQPPrepared was built with "
            f"(sigma, scale, rho, rho_scale, rho_min, rho_max)={prep.key} "
            f"but the solve config has {_gen_prep_key(config)}; re-run "
            f"prepare_qp_gen with the matching config (the cached factors "
            f"and in-loop refactorization must use the same operator)")
    pv = as_vector(p, "p").astype(prep.Qs.dtype)
    return _solve_gen_scaled(config, prep, prep.D * pv, _inf_norm(pv),
                             warm_start)


@solver_precision
def solve_qp_gen(Q, p, A=None, b=None, G=None, h=None,
                 config: GenQPConfig = GenQPConfig(),
                 warm_start=None) -> QPSolution:
    """Forward solve.  G/h required (use the eqcon/uncon solvers otherwise).

    Shapes: Q (B,n,n); p (B,n[,1]); A (B,m,n); b (B,m[,1]); G (B,k,n);
    h (B,k[,1]).

    ``warm_start``: optional previous ``QPSolution`` (x, lams, slacks in
    unscaled layout) to initialize the iterates from — the same
    solve/update/re-solve capability the box solver has.
    """
    prep = _gen_prepare(Q, A, b, G, h, config)
    pv = as_vector(p, "p").astype(prep.Qs.dtype)
    return _solve_gen_scaled(config, prep, prep.D * pv, _inf_norm(pv),
                             warm_start)


def _solve_gen_scaled(config, prep: GenQPPrepared, ps, p_norm,
                      warm_start) -> QPSolution:
    """The splitting loop on an already-scaled, already-factorized family."""
    Qs, As, bs, Gs, hs = prep.Qs, prep.As, prep.bs, prep.Gs, prep.hs
    D, EG, EA, rho0, factors0 = prep.D, prep.EG, prep.EA, prep.rho0, \
        prep.factors
    dtype = ps.dtype
    B, n = ps.shape
    k = Gs.shape[-2]
    sigma = jnp.asarray(config.sigma, dtype)
    eye = jnp.eye(n, dtype=dtype)

    def factorize(rho):
        H = Qs + rho[..., None, None] * prep.GtG + sigma * eye
        return lin.factorize_kkt(H, 0.0, As, mode="inverse")

    eps_abs = max(float(config.eps_abs), 1e-12)
    eps_rel = max(float(config.eps_rel), 1e-12)
    cs = max(int(config.check_solved), 1)
    adaptive_interval = max(round(config.adaptive_rho_iter / cs) * cs, 1)
    max_iters = int(config.max_iters)

    m_aa = int(config.acceleration)

    zeros_k = jnp.zeros((B, k), dtype)
    if warm_start is not None:
        # Map unscaled (x, slacks, lams) into scaled iterates: x_s = x / D,
        # w_s = slacks * EG, and u_s = -lams / (rho EG) (lambda = -rho u EG
        # at the fixed point, see the unscale block below).
        x0 = as_vector(warm_start.x, "warm_start.x").astype(dtype) / D
        w0 = as_vector(warm_start.slacks, "warm_start.slacks").astype(
            dtype) * EG
        u0 = -(as_vector(warm_start.lams, "warm_start.lams").astype(dtype)
               / (rho0[..., None] * EG))
    else:
        x0, w0, u0 = jnp.zeros((B, n), dtype), zeros_k, zeros_k
    init = _GenState(
        it=jnp.zeros((), jnp.int32),
        x=x0, w=w0, u=u0,
        nu=None if As is None else jnp.zeros((B, As.shape[-2]), dtype),
        rho=rho0, factors=factors0,
        primal_error=jnp.full((B,), jnp.inf, dtype),
        dual_error=jnp.full((B,), jnp.inf, dtype),
        tolp_norm=jnp.ones((B,), dtype),
        told_norm=jnp.ones((B,), dtype),
        do_rho_update=jnp.full((B,), bool(config.adaptive_rho)),
        is_optimal=jnp.zeros((B,), bool),
        u_chk=zeros_k,
        nu_chk=None if As is None else jnp.zeros((B, As.shape[-2]), dtype),
        pinf=jnp.zeros((B,), bool),
        aa=anderson.aa_init(B, m_aa, 2 * k, dtype) if m_aa else None,
    )

    def maybe_update_rho(st: _GenState) -> _GenState:
        num = jnp.maximum(st.primal_error / st.tolp_norm, _ZERO_CLAMP)
        den = jnp.maximum(st.dual_error / st.told_norm, _ZERO_CLAMP)
        ratio = jnp.sqrt(num / den)
        tol = jnp.asarray(config.adaptive_rho_tol, dtype)
        # Per-element update gate (same as the box solver,
        # models/box_qp.py): an element only moves when ITS OWN
        # primal/dual ratio is outside the band AND it is not already
        # converged-enough.  Rescaling every element whenever any one trips
        # destabilizes elements whose rho is already balanced (measured
        # 31 -> 1191 iterations on the hard box set).
        el_outside = (ratio > tol) | (ratio < 1.0 / tol)
        if config.adaptive_rho_per_element:
            upd_mask = st.do_rho_update & el_outside
        else:
            # Reference rescale-all behavior: any element outside the band
            # triggers a batch-wide rescale, but the assignment is still
            # masked by do_rho_update — converged-enough elements keep
            # their rho (solve_box_qp_admm_torch.py:247-250, where the
            # update indexes through the do_rho_update mask).
            upd_mask = st.do_rho_update & jnp.broadcast_to(
                jnp.any(el_outside), el_outside.shape)
        window = ((st.it >= adaptive_interval)
                  & (st.it < config.adaptive_rho_max_iter)
                  & ((st.it % adaptive_interval) < cs))
        pred = window & jnp.any(upd_mask)

        def upd(_):
            rho_new = jnp.where(
                upd_mask,
                jnp.clip(st.rho * ratio, config.rho_min, config.rho_max),
                st.rho)
            # rho changes rescale the dual estimate u = lambda / rho
            # (identity for non-updated elements, whose rho is unchanged).
            u_new = st.u * (st.rho / rho_new)[..., None]
            return rho_new, factorize(rho_new), u_new

        def noop(_):
            return st.rho, st.factors, st.u

        rho, f, u = jax.lax.cond(pred, upd, noop, None)
        st = st._replace(rho=rho, factors=f, u=u)
        if st.aa is not None:
            # A rho update changes the fixed-point map (and rescales u):
            # force a history reset for the updated elements.
            st = st._replace(aa=anderson.aa_reset_where(
                st.aa, pred & upd_mask))
        return st

    def body(st: _GenState) -> _GenState:
        if config.adaptive_rho:
            st = maybe_update_rho(st)
        n_inner = jnp.minimum(jnp.where(st.it == 0, 1, cs),
                              max_iters - st.it)

        alpha = float(config.alpha)

        def plain_step(w, u):
            """One splitting iteration: (w, u) -> (x, nu, w', u')."""
            rhs = -ps + _mtv(Gs, st.rho[..., None] * (hs - w + u))
            x, nu = lin.kkt_apply(st.factors, rhs, bs)
            s = hs - _mv(Gs, x)
            # Over-relaxation on the splitting variable (OSQP-style); the
            # fixed point (s = w) is unchanged.
            sh = alpha * s + (1.0 - alpha) * w if alpha != 1.0 else s
            w_new = jnp.maximum(sh + u, 0.0)
            u_new = u + (sh - w_new)
            return x, nu, w_new, u_new

        def inner(_, s_):
            x, w, u, nu, w_prev = s_
            x, nu, w_new, u_new = plain_step(w, u)
            return (x, w_new, u_new, nu, w)

        def inner_aa(i, s_):
            """Splitting iteration + safeguarded type-II Anderson step on
            the fixed-point variable v = [w; u] (the SCS
            acceleration_lookback capability — see ops/anderson.py).
            Converged elements are held on the plain map (they sit at the
            fixed point; extrapolation can only perturb them)."""
            x, w, u, nu, w_prev, aa = s_
            x, nu, w_new, u_new = plain_step(w, u)
            v = jnp.concatenate([w, u], axis=-1)
            gv = jnp.concatenate([w_new, u_new], axis=-1)
            v_next, aa = anderson.aa_step(
                aa, v, gv, ((st.it + i) % m_aa).astype(jnp.int32),
                hold=st.is_optimal,
                safeguard=float(config.aa_safeguard),
                reg=float(config.aa_reg),
                max_weight=float(config.aa_max_weight))
            return (x, v_next[:, :k], v_next[:, k:], nu, w, aa)

        if m_aa:
            x, w, u, nu, w_prev, aa = jax.lax.fori_loop(
                0, n_inner, inner_aa,
                (st.x, st.w, st.u, st.nu, st.w, st.aa))
        else:
            x, w, u, nu, w_prev = jax.lax.fori_loop(
                0, n_inner, inner, (st.x, st.w, st.u, st.nu, st.w))
            aa = st.aa

        s = hs - _mv(Gs, x)
        # Residuals in unscaled units: constraint-space via EG, x-space
        # dual via D.
        primal_error = _inf_norm((s - w) / EG)
        dual_vec = st.rho[..., None] * _mtv(Gs, w - w_prev)
        dual_error = _inf_norm(dual_vec * D)

        s_norm = _inf_norm(s / EG)
        w_norm = _inf_norm(w / EG)
        tolp_norm = jnp.maximum(jnp.maximum(s_norm, w_norm), _ZERO_CLAMP)
        Qx = _mv(Qs, x)
        lam_vec = st.rho[..., None] * u
        told_norm = jnp.maximum(
            jnp.maximum(jnp.maximum(_inf_norm(_mtv(Gs, lam_vec) * D),
                                    _inf_norm(Qx * D)), p_norm),
            _ZERO_CLAMP)
        tol_primal = eps_abs + eps_rel * tolp_norm
        tol_dual = eps_abs + eps_rel * told_norm
        is_optimal = (primal_error < tol_primal) & (dual_error < tol_dual)

        # --- Farkas-style primal-infeasibility certificate (the SCS
        # eps_infeas capability; OSQP mechanics, Banjac et al. 2019): a
        # nonnegative dl with  G' dl + A' dnu -> 0  and
        # h' dl + b' dnu < 0  proves Gx <= h, Ax = b infeasible —
        # validity is checked by the test itself, so projecting the
        # successive dual difference onto the cone is safe.  Unscaled
        # units: dl_us = EG * dl_s; (G' dl)_us = (G_s' dl_s) / D; the E/D
        # factors cancel in h' dl.
        pinf = st.pinf
        u_chk = u
        nu_chk = st.nu_chk
        if config.detect_infeasibility:
            eps_inf = jnp.asarray(config.eps_infeas, dtype)
            # lambda = -rho u  =>  dl_s = -rho (u - u_chk), projected >= 0.
            dl = jnp.maximum(-st.rho[..., None] * (u - st.u_chk), 0.0)
            cert = _mtv(Gs, dl) / D
            dual_scale = _inf_norm(dl * EG)
            support = jnp.sum(hs * dl, axis=-1)
            if As is not None:
                dnu = nu - st.nu_chk
                cert = cert + _mtv(As, dnu) / D
                dual_scale = jnp.maximum(dual_scale, _inf_norm(dnu * EA))
                support = support + jnp.sum(bs * dnu, axis=-1)
                nu_chk = nu
            pinf_el = ((_inf_norm(cert) <= eps_inf * dual_scale)
                       & (support <= -eps_inf * dual_scale)
                       & (dual_scale > _ZERO_CLAMP))
            pinf = st.pinf | (pinf_el & ~is_optimal)

        thr = jnp.asarray(config.adaptive_rho_threshold, dtype)
        do_rho_update = ((primal_error > jnp.maximum(tol_primal, thr))
                         | (dual_error > jnp.maximum(tol_dual, thr)))

        if config.verbose:
            jax.debug.print("genqp iter={it} primal={pe:.3e} dual={de:.3e}",
                            it=st.it + n_inner, pe=jnp.max(primal_error),
                            de=jnp.max(dual_error))

        return st._replace(it=st.it + n_inner, x=x, w=w, u=u, nu=nu,
                           primal_error=primal_error, dual_error=dual_error,
                           tolp_norm=tolp_norm, told_norm=told_norm,
                           do_rho_update=do_rho_update,
                           is_optimal=is_optimal,
                           u_chk=u_chk, nu_chk=nu_chk, pinf=pinf, aa=aa)

    def cond(st: _GenState):
        return (st.it < max_iters) & ~jnp.all(st.is_optimal | st.pinf)

    st = jax.lax.while_loop(cond, body, init)

    # --- unscale.  At the fixed point the x-step stationarity reads
    # Qx + p + A'nu + G'[rho(w - s - u)] = 0 with s -> w, so the inequality
    # multiplier is lambda = -rho u  (u <= 0 on active rows).
    xs = st.x
    lam_hat = jnp.maximum(-st.rho[..., None] * st.u, 0.0)
    slack_hat = jnp.maximum(st.w, 0.0)
    nu_hat = st.nu
    if config.polish:
        # OSQP-style active-set polish on the SCALED problem (see the box
        # solver / models/_polish.py).  Plain path: the slack projection
        # leaves u identically 0 on inactive rows, so sign-of-u is exact;
        # the AA path's u is an affine combination, detect by slack
        # proximity at tolerance scale instead.
        from lqp_py_tpu.models._polish import gen_penalty_polish
        prox = 10 * jnp.asarray(eps_abs + eps_rel, dtype)
        if m_aa:
            act = st.w <= prox
        else:
            # sign-of-u alone over-detects: a barely-inactive row can sit
            # at small negative u at tolerance; requiring the projected
            # slack to be near zero as well is exact on the measured
            # seeds (wrongly-pinned rows made the polish diverge before
            # the acceptance test rejected it).
            act = (st.u < 0) & (st.w <= prox)
        pol = gen_penalty_polish(Qs, ps, As, bs, Gs, hs, act)
        thr = jnp.asarray(eps_abs, dtype)

        def _viol(xv):
            gv = jnp.einsum("bki,bi->bk", Gs, xv,
                            preferred_element_type=dtype) - hs
            v = jnp.max(jnp.maximum(gv, 0.0), axis=-1)
            if As is not None:
                eq = jnp.einsum("bmi,bi->bm", As, xv,
                                preferred_element_type=dtype) - bs
                v = jnp.maximum(v, jnp.max(jnp.abs(eq), axis=-1))
            return v

        # A negative AL multiplier on an active row means the guess was
        # wrong for that element; inactive rows are exactly 0 in pol.lam.
        # The sign test floors at the AL accumulation's w*eps noise
        # (models/_polish.py al_lam_threshold) — meaningless below it.
        from lqp_py_tpu.models._polish import al_lam_threshold
        thr_lam = jnp.maximum(thr, jnp.asarray(al_lam_threshold(dtype),
                                               dtype))
        ok = ((_viol(pol.x) <= jnp.maximum(_viol(st.x), thr))
              & (jnp.min(pol.lam, axis=-1) >= -thr_lam) & ~st.pinf)
        okc = ok[..., None]
        xs = jnp.where(okc, pol.x, xs)
        lam_hat = jnp.where(okc, jnp.maximum(pol.lam, 0.0), lam_hat)
        gx = jnp.einsum("bki,bi->bk", Gs, pol.x,
                        preferred_element_type=dtype)
        slack_hat = jnp.where(okc, jnp.maximum(hs - gx, 0.0), slack_hat)
        if As is not None:
            nu_hat = jnp.where(okc[..., 0][..., None], pol.y, nu_hat)

    x = D * xs
    lams = lam_hat * EG
    slacks = slack_hat / EG
    nus = None if nu_hat is None else nu_hat * EA

    return QPSolution(
        x=x, lams=lams, slacks=slacks, nus=nus,
        iterations=st.it,
        primal_residual=st.primal_error, dual_residual=st.dual_error,
        converged=st.is_optimal, primal_infeasible=st.pinf)


def gen_qp_grad_kkt(dl_dz, x, lams, slacks, nus, Q, A, G):
    """Active-set KKT implicit VJP for general G (clamped multipliers and
    slacks, as the reference's KKT backward does for the box case,
    solve_box_qp_admm_torch.py:435-469).

    The reference materializes and LU-solves the full (n+k+m)^2 Jacobian
    (torch_qp_make_sol_mat); at (B=128, n=1000, k=2000) that is a ~4.6 GB
    operand.  Here the dlam rows are eliminated analytically —
    ``dlam = (G dx)/s`` from the complementarity row — leaving the n x n
    SPD-condensed system

        [(Q + G^T diag(lam/s) G), A^T; A, 0] [dx; dnu] = [-dl_dz; 0]

    solved through the same sweep/Schur fast path as the box backward."""
    lams_c = jnp.clip(lams, 1e-8, None)
    slacks_c = jnp.clip(slacks, 1e-8, 1e12)
    dtype = x.dtype
    w = lams_c / slacks_c                                # (B, k)
    H = Q + jnp.einsum("...ki,...k,...kj->...ij", G, w, G,
                       preferred_element_type=dtype)
    dx, dnu = bgrads.reduced_kkt_solve(H, A, -dl_dz, reg=1e-8)
    dlam = jnp.einsum("...ki,...i->...k", G, dx,
                      preferred_element_type=dtype) / slacks_c
    return bgrads.qp_int_grads(x, lams_c, nus, dx, dlam, dnu)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _genqp_implicit(config, Q, p, A, b, G, h):
    return solve_qp_gen(Q, p, A, b, G, h, config).x


def _genqp_fwd(config, Q, p, A, b, G, h):
    sol = solve_qp_gen(Q, p, A, b, G, h, config)
    return sol.x, (sol.x, sol.lams, sol.slacks, sol.nus, Q, A, G)


@solver_precision
def _genqp_bwd(config, res, dl_dz):
    x, lams, slacks, nus, Q, A, G = res
    backward = config.backward
    if backward == "conic":
        from lqp_py_tpu.models.conic_grad import (CONIC_BACKWARD_MAX_BYTES,
                                                  conic_backward_bytes)
        need = conic_backward_bytes(
            Q.shape[0], Q.shape[-1], 0 if A is None else A.shape[-2],
            G.shape[-2], jnp.dtype(Q.dtype).itemsize)
        if need > CONIC_BACKWARD_MAX_BYTES:
            import warnings
            warnings.warn(
                f"backward='conic' would materialize a dense "
                f"{need / 2**30:.1f} GiB self-dual system at this shape "
                f"(budget {CONIC_BACKWARD_MAX_BYTES / 2**30:.1f} GiB); "
                f"falling back to the condensed 'kkt' rule — equivalent "
                f"gradients for a converged solution, n x n memory",
                stacklevel=2)
            backward = "kkt"
    if backward == "conic":
        dQ, dp, dA, db, dG, dh = conic_qp_grads(
            dl_dz, x=x, lams=lams, slacks=slacks, Q=Q, A=A, G=G)
    elif backward == "kkt":
        dQ, dp, dA, db, dG, dh = gen_qp_grad_kkt(
            dl_dz, x=x, lams=lams, slacks=slacks, nus=nus, Q=Q, A=A, G=G)
    else:
        raise ValueError(f"unknown backward mode {backward!r}")
    if A is None:
        dA, db = None, None
    return dQ, dp, dA, db, dG, dh


_genqp_implicit.defvjp(_genqp_fwd, _genqp_bwd)


def qp_gen(Q, p, A=None, b=None, G=None, h=None,
           config: GenQPConfig = GenQPConfig()):
    """Differentiable general-QP layer (``SolveScsQP`` capability,
    scs_qp.py:10-49, batched).  Returns x in caller layout."""
    pv = as_vector(p, "p")
    bv = None if b is None else as_vector(b, "b")
    hv = as_vector(h, "h")
    x = _genqp_implicit(config, Q, pv, A, bv, G, hv)
    return like_layout(x, p)


class GenQPLayer:
    """Callable layer holding a GenQPConfig."""

    def __init__(self, config: GenQPConfig = GenQPConfig()):
        self.config = config

    def __call__(self, Q, p, A=None, b=None, G=None, h=None):
        return qp_gen(Q, p, A, b, G, h, config=self.config)


class GenQP(StatefulQP):
    """Stateful solve/update wrapper for the general-inequality solver —
    the ``BoxQP`` workflow (solve/update/re-solve with cached preparation
    and optional warm starting) extended to ``Gx <= h`` problems.

    The reference has no stateful SCS wrapper (its ``SolveScsQP`` module
    re-enters the sequential C solver cold every call, scs_qp.py:10-17);
    here p-only updates keep the cached scaling + factorization and
    ``warm_start=True`` reuses the previous solution as the starting
    iterate."""

    _extra_fields = ("G", "h")

    def __init__(self, Q, p, A=None, b=None, G=None, h=None,
                 control: GenQPConfig = GenQPConfig(),
                 warm_start: bool = False):
        self._init(Q, p, A, b, G, h, control, warm_start)

    def _prepare(self):
        return prepare_qp_gen(self.Q, self.A, self.b, self.G, self.h,
                              config=self.control)

    def _solve_prepared(self, prep, p, warm_start):
        return solve_qp_gen_prepared(prep, p, config=self.control,
                                     warm_start=warm_start)

    def update(self, Q=None, p=None, A=None, b=None, G=None, h=None,
               control=None):
        self._update(Q, p, A, b, G, h, control)
