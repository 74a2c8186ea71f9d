"""Demo: single-problem numpy ADMM solver + cross-check vs the JAX solver.

Mirror of the reference numpy demo (demo/demo_solve_box_qp.py, which solves
one QP with the scipy-based ADMM and eyeballs it against cvxpy,
demo/demo_solve_box_qp.py:62-73).  cvxpy is not in this environment, so the
trusted cross-checks are (a) the batched JAX solver and (b) the native
C++ CPU oracle when built.

Run:  python demo/demo_solve_box_qp_numpy.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, solve_box_qp
from lqp_py_tpu.cpu.boxqp_numpy import BoxQPNumpy
from lqp_py_tpu.utils.generators import create_qp_data


def main():
    n_x = 60
    data = create_qp_data(n_x, 1, seed=0, dtype=jnp.float64)
    Q = np.asarray(data.Q[0])
    p = np.asarray(data.p[0])
    A = np.asarray(data.A[0])
    b = np.asarray(data.b[0])
    lb = np.asarray(data.lb[0])
    ub = np.asarray(data.ub[0])

    # --- numpy single-problem solver (solve / update / re-solve workflow)
    prob = BoxQPNumpy(Q, p, A, b, lb, ub, eps_abs=1e-8, eps_rel=1e-8)
    x_np = prob.solve()
    sol = prob.sol
    print(f"numpy ADMM: iters={sol['iter']}  "
          f"primal={sol['primal_error']:.2e}  dual={sol['dual_error']:.2e}")

    # --- cross-check vs the batched JAX solver
    jsol = solve_box_qp(*data, config=BoxQPConfig(eps_abs=1e-8, eps_rel=1e-8))
    dx = float(np.max(np.abs(x_np - np.asarray(jsol.x[0]))))
    print(f"max |x_numpy - x_jax| = {dx:.2e}")
    assert dx < 1e-5, "numpy and JAX solvers disagree"

    # --- cross-check vs the native C++ oracle if built
    from lqp_py_tpu.cpu import native
    if native.available():
        nsol = native.solve_box_qp_native(
            np.asarray(data.Q, np.float64), np.asarray(data.p, np.float64),
            np.asarray(data.A, np.float64), np.asarray(data.b, np.float64),
            np.asarray(data.lb, np.float64), np.asarray(data.ub, np.float64),
            eps_abs=1e-8, eps_rel=1e-8)
        dn = float(np.max(np.abs(nsol["x"][0] - x_np)))
        print(f"max |x_native - x_numpy| = {dn:.2e}")
    else:
        print("native oracle not built (run `make -C native`); skipped")

    # --- update p and re-solve (warm workflow the reference hints at)
    prob.update(p=p * 0.5)
    prob.solve()
    print(f"re-solve after update: iters={prob.sol['iter']}")
    print("demo OK")


if __name__ == "__main__":
    main()
