"""Robustness tests for numerics added on top of reference parity:
Jacobi equilibration of the fast SPD inverse, config validation, and
graceful degradation of the f32 interior point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lqp_py_tpu import BoxQPConfig, OptNetConfig
from lqp_py_tpu.models.optnet import solve_qp_optnet
from lqp_py_tpu.ops import linalg as lin
from lqp_py_tpu.utils.generators import create_qp_data


def test_alpha_out_of_range_rejected():
    with pytest.raises(ValueError, match="alpha"):
        BoxQPConfig(alpha=2.5)
    with pytest.raises(ValueError, match="alpha"):
        BoxQPConfig(alpha=0.0)
    BoxQPConfig(alpha=1.0)  # boundary-interior values fine
    BoxQPConfig(alpha=1.95)


def test_schur_inverse_extreme_diagonal_scaling():
    """The sweep path must survive diagonals spanning ~1e8 (the IP Schur
    complement regime).  Exercised through the recursion with interpreter
    leaves; equilibration happens in spd_inverse_fast, replicated here."""
    import functools
    key = jax.random.PRNGKey(0)
    n = 256
    a = jax.random.normal(key, (2, n, n), jnp.float32) * 0.05
    H = jnp.einsum("bki,bkj->bij", a, a) + jnp.eye(n, dtype=jnp.float32)
    # scale rows/cols to create a 1e8 dynamic range on the diagonal
    s = jnp.logspace(0, 4, n, dtype=jnp.float32)
    H = H * s[None, :, None] * s[None, None, :]

    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    d = jax.lax.rsqrt(diag)
    Hs = H * d[..., :, None] * d[..., None, :]

    from lqp_py_tpu.ops.pallas.spd_inverse import sweep_spd_inverse
    leaf = functools.partial(sweep_spd_inverse, interpret=True)
    ee = functools.partial(jnp.einsum, precision="highest")
    Hi = lin._schur_inverse(Hs, ee, leaf) * d[..., :, None] * d[..., None, :]
    resid = jnp.einsum("bij,bjk->bik", H.astype(jnp.float64),
                       Hi.astype(jnp.float64)) - jnp.eye(n)
    assert float(jnp.max(jnp.abs(resid))) < 1e-3


def test_ip_f32_beyond_tolerance_no_nan():
    """An f32 interior point asked for tol below the f32 floor must return
    a finite iterate with converged=False — not NaN (both this framework's
    original triangular path and the reference's torch implementation
    produce NaN there)."""
    data = create_qp_data(40, 4, seed=4, dtype=jnp.float32)
    G, h = data.with_G_h()
    sol = solve_qp_optnet(
        data.Q.astype(jnp.float32), data.p.astype(jnp.float32),
        data.A.astype(jnp.float32), data.b.astype(jnp.float32),
        G.astype(jnp.float32), h.astype(jnp.float32),
        config=OptNetConfig(tol=1e-9, max_iters=25))
    x = np.asarray(sol.x)
    assert np.isfinite(x).all()
    # the f32 iterate should still be a decent solution
    sol5 = solve_qp_optnet(
        data.Q.astype(jnp.float32), data.p.astype(jnp.float32),
        data.A.astype(jnp.float32), data.b.astype(jnp.float32),
        G.astype(jnp.float32), h.astype(jnp.float32),
        config=OptNetConfig(tol=1e-5, max_iters=25))
    np.testing.assert_allclose(x, np.asarray(sol5.x), rtol=2e-2, atol=5e-3)


def test_native_mt_matches_sequential():
    from lqp_py_tpu.cpu import native
    if not native.available():
        pytest.skip("native library unavailable")
    data = create_qp_data(30, 8, seed=1, dtype=jnp.float64)
    args = tuple(np.asarray(v, np.float64) for v in data)
    s1 = native.solve_box_qp_native(*args, eps_abs=1e-8, eps_rel=1e-8,
                                    n_threads=1)
    s2 = native.solve_box_qp_native(*args, eps_abs=1e-8, eps_rel=1e-8,
                                    n_threads=0)
    np.testing.assert_array_equal(s1["x"], s2["x"])
    assert s1["status"] == s2["status"] == 0


def test_condensed_kkt_backward_matches_full_jacobian():
    """The condensed (n x n) KKT backward must agree with the reference's
    full (3n+m)^2 Jacobian formulation (kept as building blocks in
    box_qp_grad.make_kkt_jacobian / solve_kkt_backwards)."""
    from lqp_py_tpu.models import box_qp_grad as bg
    from lqp_py_tpu import BoxQPConfig, solve_box_qp

    data = create_qp_data(20, 3, seed=7, dtype=jnp.float64)
    sol = solve_box_qp(*data, config=BoxQPConfig(eps_abs=1e-10,
                                                 eps_rel=1e-10))
    key = jax.random.PRNGKey(0)
    dl = jax.random.normal(key, sol.x.shape, jnp.float64)

    out_c = bg.box_qp_grad_kkt(dl, sol.x, sol.lams, sol.nus,
                               data.Q, data.A, data.lb, data.ub)

    # full-Jacobian path
    B, n = sol.x.shape
    eye = jnp.eye(n, dtype=jnp.float64)
    G = jnp.broadcast_to(jnp.concatenate([-eye, eye], 0), (B, 2 * n, n))
    slacks = jnp.clip(jnp.concatenate([sol.x - data.lb, data.ub - sol.x],
                                      -1), 1e-8, 1e12)
    lams_c = jnp.clip(sol.lams, 1e-8, None)
    sol_mat = bg.make_kkt_jacobian(data.Q, G, data.A, lams_c, slacks)
    dx, dlam, dnu = bg.solve_kkt_backwards(dl, sol_mat, data.A.shape[-2],
                                           2 * n)
    out_f = bg.qp_int_grads(sol.x, lams_c, sol.nus, dx, dlam, dnu)

    for c, f in zip(out_c[:4], out_f[:4]):
        np.testing.assert_allclose(np.asarray(c), np.asarray(f),
                                   rtol=1e-6, atol=1e-9)


def test_fuzz_random_shapes_and_bound_patterns():
    """Property-style sweep: random (n, B, seed, bound pattern, equality
    on/off, easy/hard generator), solved to 1e-9 and cross-checked against
    the independent numpy ADMM on element 0."""
    from lqp_py_tpu import solve_box_qp
    from lqp_py_tpu.cpu.boxqp_numpy import solve_box_qp_np
    from lqp_py_tpu.utils.generators import generate_hard_qp

    rng = np.random.default_rng(0)
    for _ in range(12):
        n = int(rng.integers(2, 50))
        B = int(rng.integers(1, 5))
        seed = int(rng.integers(0, 10000))
        hard = bool(rng.integers(0, 2)) and n >= 10
        gen = generate_hard_qp if hard else create_qp_data
        d = gen(n, B, seed=seed, dtype=jnp.float64)
        Q, p, A, b, lb, ub = [jnp.asarray(v) for v in d[:6]]
        mode = rng.integers(0, 4)
        if mode == 1:
            lb = jnp.full_like(lb, -jnp.inf)
        elif mode == 2:
            ub = jnp.full_like(ub, jnp.inf)
        elif mode == 3:
            lb, ub = (jnp.full_like(lb, -jnp.inf),
                      jnp.full_like(ub, jnp.inf))
        use_eq = bool(rng.integers(0, 2))
        Aa, ba = (A, b) if use_eq else (None, None)
        # Half the draws run Anderson-accelerated — the accelerated path
        # must satisfy the same tight-tolerance oracle as the plain one.
        accel = int(rng.integers(0, 2)) * 8
        from lqp_py_tpu import BoxQPConfig
        sol = solve_box_qp(Q, p, Aa, ba, lb, ub,
                           config=BoxQPConfig(eps_abs=1e-9, eps_rel=1e-9,
                                              acceleration=accel))
        assert bool(jnp.all(sol.converged)), (n, B, seed, hard, mode, accel)
        ref = solve_box_qp_np(
            np.asarray(Q[0]), np.asarray(p[0]),
            None if Aa is None else np.asarray(A[0]),
            None if ba is None else np.asarray(b[0]),
            np.asarray(lb[0]), np.asarray(ub[0]),
            eps_abs=1e-10, eps_rel=1e-10)
        dx = float(np.max(np.abs(np.asarray(sol.x[0]) - ref["x"])))
        assert dx < 1e-5, (n, B, seed, hard, mode, dx)


def test_pinned_variables_lb_equals_ub():
    """Degenerate box: lb == ub pins coordinates (equality via bounds).
    The projection collapses those coordinates to the pin; the solve must
    still converge and agree with the independent numpy oracle, and a
    CROSSED pin (lb > ub) must raise the per-element data-infeasibility
    certificate, not poison the rest of the batch."""
    from lqp_py_tpu import box_qp_control, solve_box_qp
    from lqp_py_tpu.cpu.boxqp_numpy import solve_box_qp_np

    Q, p, A, b, lb, ub = [jnp.asarray(v) for v in
                          create_qp_data(12, 3, seed=7,
                                         dtype=jnp.float64)[:6]]
    pin = 0.5 * (lb[:, :4] + ub[:, :4])
    lb = lb.at[:, :4].set(pin)
    ub = ub.at[:, :4].set(pin)
    cfg = box_qp_control(eps_abs=1e-9, eps_rel=1e-9)
    sol = solve_box_qp(Q, p, A, b, lb, ub, cfg)
    assert bool(sol.converged.all())
    assert float(jnp.max(jnp.abs(sol.x[:, :4] - pin))) < 1e-7
    ref = solve_box_qp_np(np.asarray(Q[0]), np.asarray(p[0]),
                          np.asarray(A[0]), np.asarray(b[0]),
                          np.asarray(lb[0]), np.asarray(ub[0]),
                          eps_abs=1e-10, eps_rel=1e-10)
    assert float(np.max(np.abs(np.asarray(sol.x[0]) - ref["x"].ravel()))) \
        < 1e-7

    lb2 = lb.at[1, 5].set(2.0)
    ub2 = ub.at[1, 5].set(1.0)
    sol2 = solve_box_qp(Q, p, A, b, lb2, ub2, cfg)
    assert bool(sol2.primal_infeasible[1])
    assert not bool(sol2.primal_infeasible[0])
    assert not bool(sol2.primal_infeasible[2])


def test_tiny_problem_n1():
    """n_x = 1 (scalar QP per element) — below every tile size; exercises
    the pad/slice machinery at its extreme."""
    from lqp_py_tpu import box_qp_control, solve_box_qp

    B = 3
    rng = np.random.default_rng(3)
    Q = jnp.asarray(rng.uniform(0.5, 2.0, (B, 1, 1)))
    p = jnp.asarray(rng.normal(size=(B, 1)))
    lb, ub = -jnp.ones((B, 1)), jnp.ones((B, 1))
    sol = solve_box_qp(Q, p, None, None, lb, ub,
                       box_qp_control(eps_abs=1e-10, eps_rel=1e-10))
    assert bool(sol.converged.all())
    expect = jnp.clip(-p[:, 0] / Q[:, 0, 0], -1.0, 1.0)
    assert float(jnp.max(jnp.abs(sol.x[:, 0] - expect))) < 1e-8
