"""Forward-solver correctness: KKT-residual oracle + special paths.

Test strategy per SURVEY.md §4: the reference has no test suite; the natural
oracles are (a) KKT residuals of the returned solution, (b) agreement with an
independent trusted solver, (c) special-path behavior (no bounds, no equality
constraints).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lqp_py_tpu import BoxQPConfig, solve_box_qp
from lqp_py_tpu.utils.generators import (create_qp_data, generate_hard_qp,
                                         kkt_residuals)

TOL = 1e-6


def _cfg(**kw):
    kw.setdefault("eps_abs", TOL)
    kw.setdefault("eps_rel", TOL)
    return BoxQPConfig(**kw)


def _check_kkt(data, sol, tol):
    res = kkt_residuals(data.Q, data.p, data.A, data.b, data.lb, data.ub,
                        sol.x, sol.lams, sol.nus)
    assert bool(jnp.all(sol.converged)), (
        f"not converged: iters={sol.iterations}, "
        f"primal={sol.primal_residual.max()}, dual={sol.dual_residual.max()}")
    # ADMM at eps stops on primal/dual residuals; KKT residuals land within
    # a modest constant factor of eps for these scalings.
    scale = 1.0 + float(jnp.max(jnp.abs(sol.x)))
    for name, v in res.items():
        assert float(jnp.max(v)) < 200 * tol * scale, (name, float(jnp.max(v)))


@pytest.mark.parametrize("n_x", [10, 50, 120])
def test_create_qp_data_kkt(n_x):
    data = create_qp_data(n_x, n_batch=8, seed=0, dtype=jnp.float64)
    sol = solve_box_qp(*data, config=_cfg())
    _check_kkt(data, sol, TOL)


@pytest.mark.parametrize("kkt_solver", ["inverse", "cholesky"])
def test_kkt_solver_modes_agree(kkt_solver):
    data = create_qp_data(40, n_batch=4, seed=1, dtype=jnp.float64)
    sol = solve_box_qp(*data, config=_cfg(kkt_solver=kkt_solver))
    _check_kkt(data, sol, TOL)


def test_hard_qp_set():
    data = generate_hard_qp(64, n_batch=4, prob=0.15, seed=3)
    sol = solve_box_qp(*data, config=_cfg(max_iters=20000))
    _check_kkt(data, sol, TOL)


def test_no_scaling_no_adaptive():
    data = create_qp_data(30, n_batch=4, seed=2, dtype=jnp.float64)
    sol = solve_box_qp(
        *data, config=_cfg(scale=False, adaptive_rho=False))
    _check_kkt(data, sol, TOL)


def test_no_equality_constraints():
    data = create_qp_data(25, n_batch=4, seed=4, dtype=jnp.float64)
    sol = solve_box_qp(data.Q, data.p, None, None, data.lb, data.ub,
                       config=_cfg())
    res = kkt_residuals(data.Q, data.p, None, None, data.lb, data.ub,
                        sol.x, sol.lams, None)
    assert bool(jnp.all(sol.converged))
    assert float(jnp.max(res["stationarity"])) < 1e-3
    assert sol.nus is None


def test_no_bounds_single_shot():
    """No finite bounds -> rho forced to 0, converges immediately to the
    equality-constrained solution (solve_box_qp_admm_torch.py:156-158)."""
    data = create_qp_data(20, n_batch=4, seed=5, dtype=jnp.float64)
    sol = solve_box_qp(data.Q, data.p, data.A, data.b, None, None,
                       config=_cfg())
    from lqp_py_tpu import solve_qp_eqcon
    ref = solve_qp_eqcon(data.Q, data.p, data.A, data.b)
    np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x),
                               rtol=1e-6, atol=1e-8)
    assert int(sol.iterations) <= 2


def test_partial_infinite_bounds():
    data = create_qp_data(24, n_batch=4, seed=6, dtype=jnp.float64)
    lb = data.lb.at[:, ::2].set(-jnp.inf)
    ub = data.ub.at[:, 1::3].set(jnp.inf)
    d2 = data._replace(lb=lb, ub=ub)
    sol = solve_box_qp(*d2, config=_cfg())
    _check_kkt(d2, sol, TOL)


def test_layout_compat_bn1():
    """Reference layout (B, n, 1) in -> same out."""
    data = create_qp_data(15, n_batch=3, seed=7, dtype=jnp.float64)
    sol2 = solve_box_qp(data.Q, data.p, data.A, data.b, data.lb, data.ub,
                        config=_cfg())
    from lqp_py_tpu import boxqp
    x3 = boxqp(data.Q, data.p[..., None], data.A, data.b[..., None],
               data.lb[..., None], data.ub[..., None], config=_cfg())
    assert x3.shape == (3, 15, 1)
    np.testing.assert_allclose(np.asarray(x3[..., 0]), np.asarray(sol2.x),
                               rtol=1e-10)


def test_fixed_rho():
    data = create_qp_data(20, n_batch=2, seed=8, dtype=jnp.float64)
    sol = solve_box_qp(*data, config=_cfg(rho=1.0, adaptive_rho=False))
    _check_kkt(data, sol, TOL)


def test_jit_and_vmap_compat():
    data = create_qp_data(16, n_batch=4, seed=9, dtype=jnp.float64)
    cfg = _cfg()
    f = jax.jit(lambda *a: solve_box_qp(*a, config=cfg).x)
    x_jit = f(*data)
    x_eager = solve_box_qp(*data, config=cfg).x
    np.testing.assert_allclose(np.asarray(x_jit), np.asarray(x_eager),
                               rtol=1e-12)


def test_box_anderson_acceleration_hard_set():
    """Safeguarded AA on the box ADMM fixed point: fewer iterations on the
    ill-conditioned hard set, same solution (tolerance scale), f32-safe,
    neutral on an easy problem."""
    from lqp_py_tpu import box_qp_control
    from lqp_py_tpu.utils.generators import generate_hard_qp

    n, B = 50, 8
    Q, p, A, b, lb, ub = [jnp.asarray(v) for v in
                          generate_hard_qp(n, B, seed=0,
                                           dtype=jnp.float64)[:6]]
    for dtype in (jnp.float64, jnp.float32):
        args = [v.astype(dtype) for v in (Q, p, A, b, lb, ub)]
        plain = solve_box_qp(*args, box_qp_control(eps_abs=1e-5,
                                                   eps_rel=1e-5))
        accel = solve_box_qp(*args, box_qp_control(eps_abs=1e-5,
                                                   eps_rel=1e-5,
                                                   acceleration=10))
        assert bool(plain.converged.all()) and bool(accel.converged.all())
        assert int(accel.iterations) < int(plain.iterations), dtype
        assert float(jnp.max(jnp.abs(accel.x - plain.x))) < 1e-2, dtype
        # z is the solution's feasible iterate: the Anderson combination
        # can leave the box (negative weights) by O(tolerance), so
        # extraction must project it back.  Exactness is up to the
        # unscaling rounding (z = D * clip(z_s, lb/D, ub/D) — a couple of
        # ulps, same as the plain path), not the AA error.
        z = jnp.asarray(accel.z)
        tiny = 8 * jnp.finfo(dtype).eps
        viol = jnp.maximum(jnp.maximum(args[4] - z, z - args[5]), 0.0)
        assert float(jnp.max(viol)) <= tiny, dtype


def test_acceleration_unroll_rejected():
    import pytest as _pytest

    from lqp_py_tpu import box_qp_control

    with _pytest.raises(ValueError, match="unroll"):
        box_qp_control(acceleration=10, unroll=True)


def test_symmetrize_knob_equivalence():
    """symmetrize=False on an exactly symmetric Q must match the default
    path bit-for-bit-ish (same fused prep, one fewer HBM pass), and the
    defensive default must map an asymmetric Q onto its symmetric part."""
    import jax.numpy as jnp
    import numpy as np
    import jax

    from lqp_py_tpu import BoxQPConfig, solve_box_qp
    from lqp_py_tpu.utils.generators import create_qp_data

    Q, p, A, b, lb, ub = create_qp_data(30, 4, seed=3, dtype=jnp.float64)
    cfg = BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8)
    ref = solve_box_qp(Q, p, A, b, lb, ub, cfg)
    fast = solve_box_qp(Q, p, A, b, lb, ub,
                        BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8,
                                    symmetrize=False))
    np.testing.assert_allclose(np.asarray(fast.x), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)

    # Asymmetric perturbation: default == solving the symmetric part.
    N = jax.random.normal(jax.random.PRNGKey(0), Q.shape, Q.dtype) * 1e-3
    skew = N - jnp.swapaxes(N, -1, -2)      # purely antisymmetric
    got = solve_box_qp(Q + skew, p, A, b, lb, ub, cfg)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)
