"""Demo: per-element solver status — convergence, residuals, and
primal-infeasibility certificates.

The reference returns the current iterate silently after max_iters
(solve_box_qp_admm_torch.py:331) with no status of any kind.  Here every
solution pytree carries per-element `converged`, `primal_residual`,
`dual_residual`, `iterations`, and the box/genqp solvers detect primal
infeasibility (OSQP-style certificate, Banjac et al. 2019) instead of
burning the full iteration budget.

Run:  python demo/demo_status_reporting.py
"""

import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, solve_box_qp


def main():
    n = 6
    key = jax.random.PRNGKey(0)
    L = jax.random.normal(key, (3, 2 * n, n))
    Q = jnp.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.5 * jnp.eye(n)
    p = jax.random.normal(jax.random.PRNGKey(1), (3, n))
    A = jnp.ones((3, 1, n))
    # Element 0: feasible (sum x = 2 within the box).
    # Element 1: INFEASIBLE (sum x = 30 but x <= 1 and n = 6 -> sum <= 6).
    # Element 2: feasible.
    b = jnp.asarray([[2.0], [30.0], [-1.0]])
    lb = jnp.full((3, n), -1.0)
    ub = jnp.full((3, n), 1.0)

    sol = solve_box_qp(Q, p, A, b, lb, ub,
                       config=BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6,
                                          max_iters=20000))

    print(f"iterations run (lock-step batch): {int(sol.iterations)}")
    for i in range(3):
        status = ("PRIMAL INFEASIBLE (certificate found)"
                  if bool(sol.primal_infeasible[i])
                  else ("converged" if bool(sol.converged[i])
                        else "max-iters"))
        print(f"  element {i}: {status:38s} "
              f"primal={float(sol.primal_residual[i]):.2e} "
              f"dual={float(sol.dual_residual[i]):.2e}")

    assert bool(sol.primal_infeasible[1]) and bool(sol.converged[0])
    print("ok: infeasibility certified without burning max_iters "
          f"({int(sol.iterations)} << 20000)")

    # Mid-solve residual trajectory WITHOUT host callbacks: the reference
    # prints residuals from inside the loop (solve_box_qp_admm_torch.py:
    # 289-294), which needs the host; config.residual_trace carries a ring
    # buffer through the while loop instead and returns it with the
    # solution.
    sol_t = solve_box_qp(Q, p, A, b, lb, ub,
                         config=BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6,
                                            max_iters=20000,
                                            residual_trace=16))
    print("\nresidual trajectory (last 16 checks, on-device ring buffer):")
    import numpy as np
    tr = np.asarray(sol_t.residual_trace)
    for it, pe, de in tr[tr[:, 0] >= 0]:
        print(f"  iter {int(it):5d}  max primal={pe:.3e}  max dual={de:.3e}")


if __name__ == "__main__":
    main()
