"""Warm starting, stateful wrapper, flax modules, profiling utilities."""

import jax
import jax.numpy as jnp
import numpy as np

from lqp_py_tpu import BoxQPConfig, solve_box_qp
from lqp_py_tpu.models.layers import BoxQP
from lqp_py_tpu.utils.generators import create_qp_data
from lqp_py_tpu.utils.profiling import solve_stats, timed

CFG = BoxQPConfig(eps_abs=1e-7, eps_rel=1e-7)


def test_warm_start_reduces_iterations():
    data = create_qp_data(40, 4, seed=0, dtype=jnp.float64)
    cold = solve_box_qp(*data, config=CFG)
    # Perturb p slightly and re-solve warm vs cold.
    p2 = data.p * 1.01
    cold2 = solve_box_qp(data.Q, p2, data.A, data.b, data.lb, data.ub,
                         config=CFG)
    warm2 = solve_box_qp(data.Q, p2, data.A, data.b, data.lb, data.ub,
                         config=CFG, warm_start=cold)
    assert bool(jnp.all(warm2.converged))
    np.testing.assert_allclose(np.asarray(warm2.x), np.asarray(cold2.x),
                               rtol=1e-4, atol=1e-6)
    assert int(warm2.iterations) < int(cold2.iterations)


def test_stateful_wrapper_warm_start():
    data = create_qp_data(30, 2, seed=1, dtype=jnp.float64)
    qp = BoxQP(*data, control=CFG, warm_start=True)
    x1 = qp.solve()
    it1 = int(qp.sol.iterations)
    qp.update(p=data.p * 1.001)
    x2 = qp.solve()
    it2 = int(qp.sol.iterations)
    assert it2 < it1
    assert not np.allclose(np.asarray(x1), np.asarray(x2))


def test_flax_modules():
    import flax.linen as nn  # noqa: F401
    from lqp_py_tpu.nn import BoxQPModule, LinearBoxQP

    data = create_qp_data(12, 3, seed=2, dtype=jnp.float64)
    mod = BoxQPModule(config=CFG)
    x = mod.apply({}, *data)
    ref = solve_box_qp(*data, config=CFG)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), rtol=1e-10)

    lin = LinearBoxQP(n_x=12, config=CFG)
    feats = jax.random.normal(jax.random.PRNGKey(0), (3, 5), jnp.float64)
    params = lin.init(jax.random.PRNGKey(1), feats, data.Q, data.A, data.b,
                      data.lb, data.ub)

    def loss(params):
        out = lin.apply(params, feats, data.Q, data.A, data.b,
                        data.lb, data.ub)
        return jnp.sum(out ** 2)

    g = jax.grad(loss)(params)
    flat = jax.tree_util.tree_leaves(g)
    assert all(bool(jnp.all(jnp.isfinite(v))) for v in flat)
    assert any(float(jnp.max(jnp.abs(v))) > 0 for v in flat)


def test_profiling_utils():
    data = create_qp_data(10, 2, seed=3, dtype=jnp.float64)
    sol = solve_box_qp(*data, config=CFG)
    stats = solve_stats(sol)
    assert stats["converged_frac"] == 1.0
    f = jax.jit(lambda p: solve_box_qp(data.Q, p, data.A, data.b,
                                       data.lb, data.ub, CFG).x)
    t = timed(f, data.p, n=2)
    assert t["median_s"] > 0


def test_prepared_solve_matches_direct():
    """prepare_box_qp + solve_box_qp_prepared must reproduce solve_box_qp
    exactly (same scaled problem, same factors, same loop)."""
    import jax.numpy as jnp
    import numpy as np
    from lqp_py_tpu import (BoxQPConfig, prepare_box_qp, solve_box_qp,
                            solve_box_qp_prepared)
    from lqp_py_tpu.utils.generators import create_qp_data

    data = create_qp_data(35, 4, seed=9, dtype=jnp.float64)
    cfg = BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8)
    direct = solve_box_qp(*data, config=cfg)
    prep = prepare_box_qp(data.Q, data.A, data.b, data.lb, data.ub,
                          config=cfg)
    prepared = solve_box_qp_prepared(prep, data.p, config=cfg)
    np.testing.assert_array_equal(np.asarray(direct.x),
                                  np.asarray(prepared.x))
    assert int(direct.iterations) == int(prepared.iterations)
    # a second solve with a different p against the same preparation
    p2 = data.p * 0.7 + 0.1
    s2 = solve_box_qp_prepared(prep, p2, config=cfg, warm_start=prepared)
    ref2 = solve_box_qp(data.Q, p2, data.A, data.b, data.lb, data.ub,
                        config=cfg)
    np.testing.assert_allclose(np.asarray(s2.x), np.asarray(ref2.x),
                               rtol=1e-6, atol=1e-8)


def test_stateful_boxqp_prep_cache_invalidation():
    """p-only updates keep the cached factorization; touching anything
    else invalidates it (serving semantics)."""
    import jax.numpy as jnp
    import numpy as np
    from lqp_py_tpu import BoxQP, BoxQPConfig
    from lqp_py_tpu.utils.generators import create_qp_data

    data = create_qp_data(20, 3, seed=12, dtype=jnp.float64)
    cfg = BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8)
    qp = BoxQP(*data, control=cfg, warm_start=True)
    qp.solve()
    prep1 = qp._prep
    assert prep1 is not None
    qp.update(p=data.p * 0.5)
    qp.solve()
    assert qp._prep is prep1          # p-only: cache kept
    qp.update(lb=data.lb - 0.1)
    assert qp._prep is None           # bounds changed: cache dropped
    x = qp.solve()
    # result matches a fresh direct solve
    from lqp_py_tpu import solve_box_qp
    ref = solve_box_qp(data.Q, data.p * 0.5, data.A, data.b,
                       data.lb - 0.1, data.ub, config=cfg)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x),
                               rtol=1e-5, atol=1e-6)


def test_scs_control_mapping():
    """Reference scs_control knob names map onto GenQPConfig
    (control.py:39-77); unsupported knobs raise unless ignored."""
    import pytest
    from lqp_py_tpu import GenQPConfig, scs_control

    cfg = scs_control(normalize=False, scale=0.2, adaptive_scale=False,
                      rho_x=1e-5, alpha=1.4, eps_abs=1e-6, eps_rel=1e-6,
                      max_iters=123, verbose=False)
    assert isinstance(cfg, GenQPConfig)
    assert cfg.scale is False and cfg.rho == 0.2
    assert cfg.adaptive_rho is False and cfg.sigma == 1e-5
    assert cfg.alpha == 1.4 and cfg.max_iters == 123

    with pytest.raises(ValueError, match="no batched counterpart"):
        scs_control(use_indirect=True)
    cfg2 = scs_control(use_indirect=True, mkl=True,
                       ignore_unsupported=True)
    assert isinstance(cfg2, GenQPConfig)

    # eps_infeas maps onto the Farkas certificate (it is a supported
    # capability, not a rejected knob): detection turned on, tol threaded.
    cfg3 = scs_control(eps_infeas=1e-7)
    assert cfg3.detect_infeasibility is True and cfg3.eps_infeas == 1e-7
    # explicit detect_infeasibility wins over the implied default
    cfg4 = scs_control(eps_infeas=1e-7, detect_infeasibility=False)
    assert cfg4.detect_infeasibility is False and cfg4.eps_infeas == 1e-7


def test_fused_train_scan_matches_per_step_loop():
    """make_train_scan (whole horizon in one lax.scan dispatch) must
    reproduce the per-step make_train_step loop exactly: same minibatch
    index matrix, same update order (exp2's fused path, verdict #2)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lqp_py_tpu import BoxQPConfig
    from lqp_py_tpu.models.train import (init_params, make_train_scan,
                                         make_train_step)
    from lqp_py_tpu.utils.generators import create_qp_data

    n_x, n_feat, B, mb, epochs = 24, 3, 16, 8, 5
    data = create_qp_data(n_x, B, seed=3, dtype=jnp.float64)
    key = jax.random.PRNGKey(1)
    kf, kb, kp = jax.random.split(key, 3)
    features = jax.random.normal(kf, (B, n_feat), jnp.float64)
    beta = jax.random.normal(kb, (n_feat, n_x), jnp.float64)
    p_true = features @ beta
    full = (features, data.Q, p_true, data.A, data.b, data.lb, data.ub)

    rng = np.random.RandomState(4)
    sel = jnp.asarray(np.stack([
        rng.choice(B, mb, replace=False) for _ in range(epochs)
    ]).astype(np.int32))

    cfg = BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8)
    params0 = init_params(kp, n_feat, n_x, jnp.float64)

    step = jax.jit(make_train_step(cfg, lr=1e-3))
    params_loop = params0
    losses_loop = []
    for e in range(epochs):
        mb_data = tuple(v[sel[e]] for v in full)
        params_loop, loss = step(params_loop, *mb_data)
        losses_loop.append(float(loss))

    run = jax.jit(make_train_scan(cfg, lr=1e-3))
    params_fused, losses_fused = run(params0, sel, *full)

    np.testing.assert_allclose(np.asarray(losses_fused), losses_loop,
                               rtol=1e-12, atol=1e-12)
    for a, b_ in zip(params_fused, params_loop):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=1e-12, atol=1e-12)


def test_genqp_prepare_solve_prepared_matches_direct():
    """Serving split for the general-inequality solver: prepare_qp_gen +
    solve_qp_gen_prepared must match solve_qp_gen exactly (same scaling,
    rho, factors) and compose with warm_start (box-parity capability)."""
    import jax.numpy as jnp
    import numpy as np
    from lqp_py_tpu import (GenQPConfig, prepare_qp_gen, solve_qp_gen,
                            solve_qp_gen_prepared)
    from lqp_py_tpu.utils.generators import create_qp_data

    data = create_qp_data(24, 4, seed=9, dtype=jnp.float64)
    G, h = data.with_G_h()
    cfg = GenQPConfig(eps_abs=1e-8, eps_rel=1e-8)

    direct = solve_qp_gen(data.Q, data.p, data.A, data.b, G, h, config=cfg)
    prep = prepare_qp_gen(data.Q, data.A, data.b, G, h, config=cfg)
    served = solve_qp_gen_prepared(prep, data.p, config=cfg)
    np.testing.assert_allclose(np.asarray(served.x), np.asarray(direct.x),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(served.lams),
                               np.asarray(direct.lams),
                               rtol=1e-10, atol=1e-12)
    assert int(served.iterations) == int(direct.iterations)

    # Warm re-solve from the previous solution: near-immediate convergence.
    warm = solve_qp_gen_prepared(prep, data.p, config=cfg, warm_start=served)
    assert bool(jnp.all(warm.converged))
    assert int(warm.iterations) < int(direct.iterations) // 4

    # Drifting p (the serving pattern): still converges and matches a
    # direct solve on the new p.
    p2 = data.p + 0.05
    served2 = solve_qp_gen_prepared(prep, p2, config=cfg, warm_start=served)
    direct2 = solve_qp_gen(data.Q, p2, data.A, data.b, G, h, config=cfg)
    assert bool(jnp.all(served2.converged))
    np.testing.assert_allclose(np.asarray(served2.x),
                               np.asarray(direct2.x), rtol=1e-6, atol=1e-8)


def test_genqp_prepared_config_mismatch_raises():
    """Cached genqp factors depend on sigma/scale/rho*; a solve config
    that disagrees must raise (the in-loop adaptive refactorization would
    silently mix two different x-step operators otherwise)."""
    import jax.numpy as jnp
    import pytest
    from lqp_py_tpu import GenQPConfig, prepare_qp_gen, solve_qp_gen_prepared
    from lqp_py_tpu.utils.generators import create_qp_data

    data = create_qp_data(16, 2, seed=13, dtype=jnp.float64)
    G, h = data.with_G_h()
    prep = prepare_qp_gen(data.Q, data.A, data.b, G, h,
                          config=GenQPConfig())
    with pytest.raises(ValueError, match="matching config"):
        solve_qp_gen_prepared(prep, data.p, config=GenQPConfig(sigma=1e-3))
    with pytest.raises(ValueError, match="matching config"):
        solve_qp_gen_prepared(prep, data.p, config=GenQPConfig(scale=False))


def test_stateful_genqp_solve_update_resolve():
    """GenQP (stateful wrapper): p-only update keeps the cached prep and
    warm-starts; touching G invalidates it; results always match direct
    solves."""
    import jax.numpy as jnp
    import numpy as np
    from lqp_py_tpu import GenQP, GenQPConfig, solve_qp_gen
    from lqp_py_tpu.utils.generators import create_qp_data

    data = create_qp_data(20, 3, seed=17, dtype=jnp.float64)
    G, h = data.with_G_h()
    cfg = GenQPConfig(eps_abs=1e-8, eps_rel=1e-8)
    m = GenQP(data.Q, data.p, data.A, data.b, G, h, control=cfg,
              warm_start=True)
    x1 = m.solve()
    ref1 = solve_qp_gen(data.Q, data.p, data.A, data.b, G, h, config=cfg)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(ref1.x),
                               rtol=1e-10, atol=1e-12)

    prep_before = m._prep
    p2 = data.p + 0.1
    m.update(p=p2)
    assert m._prep is prep_before  # p-only: cache kept
    x2 = m.solve()
    ref2 = solve_qp_gen(data.Q, p2, data.A, data.b, G, h, config=cfg)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(ref2.x),
                               rtol=1e-6, atol=1e-8)
    assert int(m.sol.iterations) < int(ref2.iterations)  # warm started

    h2 = h + 0.5
    m.update(h=h2)
    assert m._prep is None  # constraint change invalidates the cache
    x3 = m.solve()
    ref3 = solve_qp_gen(data.Q, p2, data.A, data.b, G, h2, config=cfg)
    # Warm and cold starts converge to the same point only up to the
    # stopping tolerance; measured deviation ~9e-8 at eps 1e-8.
    np.testing.assert_allclose(np.asarray(x3), np.asarray(ref3.x),
                               rtol=1e-5, atol=1e-6)


def test_fused_train_scan_box_only():
    """make_train_scan must accept A=None/b=None (equality-free box QP),
    like make_train_step does — the scan's minibatch gather has to skip
    None operands instead of calling jnp.take on them."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lqp_py_tpu import BoxQPConfig
    from lqp_py_tpu.models.train import (init_params, make_train_scan,
                                         make_train_step)
    from lqp_py_tpu.utils.generators import create_qp_data

    n_x, n_feat, B, mb, epochs = 16, 3, 12, 6, 3
    data = create_qp_data(n_x, B, seed=9, dtype=jnp.float64)
    key = jax.random.PRNGKey(7)
    kf, kb, kp = jax.random.split(key, 3)
    features = jax.random.normal(kf, (B, n_feat), jnp.float64)
    p_true = features @ jax.random.normal(kb, (n_feat, n_x), jnp.float64)
    full = (features, data.Q, p_true, None, None, data.lb, data.ub)

    rng = np.random.RandomState(2)
    sel = jnp.asarray(np.stack([
        rng.choice(B, mb, replace=False) for _ in range(epochs)
    ]).astype(np.int32))
    cfg = BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8)
    params0 = init_params(kp, n_feat, n_x, jnp.float64)

    step = jax.jit(make_train_step(cfg, lr=1e-3))
    params_loop = params0
    losses_loop = []
    for e in range(epochs):
        mbd = tuple(None if v is None else v[sel[e]] for v in full)
        params_loop, loss = step(params_loop, *mbd)
        losses_loop.append(float(loss))

    run = jax.jit(make_train_scan(cfg, lr=1e-3))
    params_fused, losses_fused = run(params0, sel, *full)
    np.testing.assert_allclose(np.asarray(losses_fused), losses_loop,
                               rtol=1e-12, atol=1e-12)


def test_unrolled_rejects_acceleration():
    """solve_box_qp_unrolled called directly (unroll flag unset) must
    refuse acceleration rather than silently running unaccelerated."""
    import jax.numpy as jnp
    import pytest
    from lqp_py_tpu import BoxQPConfig
    from lqp_py_tpu.models.box_qp import solve_box_qp_unrolled
    from lqp_py_tpu.utils.generators import create_qp_data

    data = create_qp_data(8, 2, seed=0, dtype=jnp.float64)
    with pytest.raises(ValueError, match="unrolled"):
        solve_box_qp_unrolled(*data, config=BoxQPConfig(acceleration=5))


def test_negative_acceleration_rejected_at_construction():
    """SCS's negative acceleration_lookback (type-I AA) must fail with a
    clear ValueError at config construction, not a shape error mid-trace."""
    import pytest
    from lqp_py_tpu import BoxQPConfig, GenQPConfig

    for ctor in (BoxQPConfig, GenQPConfig):
        with pytest.raises(ValueError, match="type-I"):
            ctor(acceleration=-5)


def test_residual_trace_ring_buffer():
    """config.residual_trace=K carries a (K, 3) [iter, max primal, max dual]
    ring buffer through the while loop — mid-solve observability without host callbacks
    (round-3 verdict #9); rows are chronological after un-rotation and the
    last row matches the solution's final residual maxima."""
    import jax

    from lqp_py_tpu import BoxQPConfig
    from lqp_py_tpu.models.box_qp import solve_box_qp
    from lqp_py_tpu.utils.generators import create_qp_data

    data = create_qp_data(24, 4, seed=11, dtype=jnp.float64)
    cfg = BoxQPConfig(eps_abs=1e-7, eps_rel=1e-7, residual_trace=8)
    sol = jax.jit(lambda *a: solve_box_qp(*a, config=cfg))(
        data.Q, data.p, data.A, data.b, data.lb, data.ub)
    tr = np.asarray(sol.residual_trace)
    assert tr.shape == (8, 3)
    valid = tr[tr[:, 0] >= 0]
    assert len(valid) >= 2, "expected at least two residual checks"
    assert (np.diff(valid[:, 0]) > 0).all(), "rows must be chronological"
    last = valid[-1]
    np.testing.assert_allclose(last[1], float(jnp.max(sol.primal_residual)),
                               rtol=1e-6)
    np.testing.assert_allclose(last[2], float(jnp.max(sol.dual_residual)),
                               rtol=1e-6)
    assert float(last[0]) == float(sol.iterations)
    # Residuals decrease over the trace (monotone on this easy family).
    assert valid[-1][1] <= valid[0][1]

    # Ring wrap: a tiny buffer keeps the LAST checks.
    cfg2 = BoxQPConfig(eps_abs=1e-7, eps_rel=1e-7, residual_trace=2)
    sol2 = solve_box_qp(data.Q, data.p, data.A, data.b, data.lb, data.ub,
                        config=cfg2)
    tr2 = np.asarray(sol2.residual_trace)
    assert tr2.shape == (2, 3)
    assert float(tr2[-1][0]) == float(sol2.iterations)
    assert (np.diff(tr2[:, 0]) > 0).all()
