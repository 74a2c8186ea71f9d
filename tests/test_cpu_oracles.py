"""Cross-solver agreement: the batched JAX solver vs the independent C++ and NumPy
CPU implementations (the reference validates against SCS/cvxpy this way,
demo/demo_solve_box_qp.py:62-73)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lqp_py_tpu import BoxQPConfig, solve_box_qp
from lqp_py_tpu.cpu import native
from lqp_py_tpu.cpu.boxqp_numpy import BoxQPNumpy, solve_box_qp_np
from lqp_py_tpu.utils.generators import create_qp_data

CFG = BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8, max_iters=200000)


def test_numpy_oracle_agrees():
    data = create_qp_data(24, n_batch=4, seed=0, dtype=jnp.float64)
    sol = solve_box_qp(*data, config=CFG)
    for i in range(4):
        ref = solve_box_qp_np(
            np.asarray(data.Q)[i], np.asarray(data.p)[i],
            np.asarray(data.A)[i], np.asarray(data.b)[i],
            np.asarray(data.lb)[i], np.asarray(data.ub)[i],
            eps_abs=1e-10, eps_rel=1e-10)
        assert ref["converged"]
        np.testing.assert_allclose(np.asarray(sol.x)[i], ref["x"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(sol.nus)[i], ref["nus"],
                                   rtol=1e-3, atol=1e-5)


def test_native_oracle_agrees():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    data = create_qp_data(32, n_batch=8, seed=1, dtype=jnp.float64)
    sol = solve_box_qp(*data, config=CFG)
    out = native.solve_box_qp_native(
        data.Q, data.p, data.A, data.b, data.lb, data.ub,
        eps_abs=1e-10, eps_rel=1e-10)
    np.testing.assert_allclose(np.asarray(sol.x), out["x"],
                               rtol=1e-5, atol=1e-7)


def test_native_matches_numpy():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    data = create_qp_data(16, n_batch=3, seed=2, dtype=jnp.float64)
    out = native.solve_box_qp_native(data.Q, data.p, data.A, data.b,
                                     data.lb, data.ub,
                                     eps_abs=1e-10, eps_rel=1e-10)
    for i in range(3):
        ref = solve_box_qp_np(
            np.asarray(data.Q)[i], np.asarray(data.p)[i],
            np.asarray(data.A)[i], np.asarray(data.b)[i],
            np.asarray(data.lb)[i], np.asarray(data.ub)[i],
            eps_abs=1e-10, eps_rel=1e-10)
        np.testing.assert_allclose(out["x"][i], ref["x"],
                                   rtol=1e-6, atol=1e-8)


def test_numpy_stateful_wrapper():
    data = create_qp_data(10, n_batch=1, seed=3, dtype=jnp.float64)
    qp = BoxQPNumpy(np.asarray(data.Q)[0], np.asarray(data.p)[0],
                    np.asarray(data.A)[0], np.asarray(data.b)[0],
                    np.asarray(data.lb)[0], np.asarray(data.ub)[0])
    x1 = qp.solve()
    # update bounds and re-solve (the reference's update() had a bug that
    # nulled lb/ub instead of setting them, solve_box_qp_admm.py:36-39).
    qp.update(lb=np.asarray(data.lb)[0] * 0.5, ub=np.asarray(data.ub)[0] * 0.5)
    x2 = qp.solve()
    assert qp.lb is not None and qp.ub is not None
    assert not np.allclose(x1, x2)


def test_numpy_scaling_and_adaptive_rho_ill_conditioned():
    """The oracle's scaled + adaptive-rho path (solve_box_qp_admm.py:125-234
    parity) on a badly conditioned problem: without scaling the plain
    iteration needs far more iterations; both must agree with the JAX
    solver's solution."""
    from lqp_py_tpu import BoxQPConfig, solve_box_qp

    rng = np.random.RandomState(7)
    n = 24
    L = rng.randn(2 * n, n)
    s = np.logspace(0, 2, n)
    Q = (L.T @ L / (2 * n)) * np.outer(s, s) + 1e-3 * np.eye(n)
    p = rng.randn(n) * s
    lb, ub = -np.abs(rng.randn(n)) * 2, np.abs(rng.randn(n)) * 2

    scaled = solve_box_qp_np(Q, p, None, None, lb, ub,
                             eps_abs=1e-9, eps_rel=1e-9)
    plain = solve_box_qp_np(Q, p, None, None, lb, ub,
                            eps_abs=1e-9, eps_rel=1e-9, max_iters=20000,
                            scale=False, adaptive_rho=False)
    assert scaled["converged"]
    # The tuned path must actually help on this conditioning: the plain
    # iteration stalls (does not converge in 20k iterations).
    assert not plain["converged"] or scaled["iter"] < plain["iter"], (
        scaled["iter"], plain["iter"])

    jx = solve_box_qp(jnp.asarray(Q)[None], jnp.asarray(p)[None],
                       None, None, jnp.asarray(lb)[None],
                       jnp.asarray(ub)[None],
                       config=BoxQPConfig(eps_abs=1e-9, eps_rel=1e-9,
                                          max_iters=200000))
    # eps is relative to the dual norm (~|Qx| ~ 1e4 here), so absolute
    # x agreement is ~1e-5.
    np.testing.assert_allclose(np.asarray(jx.x)[0], scaled["x"],
                               rtol=1e-4, atol=5e-5)
