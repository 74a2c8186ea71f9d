"""Demo: raw functional forward + manual backward on a batch of box QPs.

Mirror of the reference demo (demo/demo_solve_box_qp_torch.py): dz=500,
batch=128, tol 1e-6, with residual printing and a cross-check against the
native C++ CPU oracle.

Run:  python demo/demo_solve_box_qp.py [--n-x 500 --n-batch 128]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, solve_box_qp
from lqp_py_tpu.models.box_qp_grad import box_qp_grad_fixed_point
from lqp_py_tpu.utils.generators import create_qp_data, kkt_residuals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-6)
    args = ap.parse_args()

    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol, verbose=False)
    data = create_qp_data(args.n_x, args.n_batch, seed=0, dtype=jnp.float32)

    solve = jax.jit(lambda *a: solve_box_qp(*a, config=cfg))
    t0 = time.perf_counter()
    jax.block_until_ready(solve(*data))
    print(f"compile+solve: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve(*data))
    print(f"forward: {time.perf_counter() - t0:.3f}s  "
          f"iters={int(sol.iterations)} "
          f"converged={bool(jnp.all(sol.converged))}")

    res = kkt_residuals(*data, sol.x, sol.lams, sol.nus)
    for k, v in res.items():
        print(f"  max {k}: {float(jnp.max(v)):.3e}")

    # Manual backward call (the layer API does this via custom_vjp).
    dl_dz = jnp.ones_like(sol.x)
    bwd = jax.jit(lambda *a: box_qp_grad_fixed_point(*a))
    jax.block_until_ready(bwd(dl_dz, sol.x, sol.u, sol.lams, sol.nus,
                              data.Q, data.A, data.lb, data.ub, sol.rho))
    t0 = time.perf_counter()
    grads = bwd(dl_dz, sol.x, sol.u, sol.lams, sol.nus,
                data.Q, data.A, data.lb, data.ub, sol.rho)
    jax.block_until_ready(grads[0])
    print(f"backward: {time.perf_counter() - t0:.3f}s  "
          f"|dQ|={float(jnp.max(jnp.abs(grads[0]))):.3e} "
          f"|dp|={float(jnp.max(jnp.abs(grads[1]))):.3e}")

    # Cross-check a few elements against the native CPU oracle.
    from lqp_py_tpu.cpu import native
    if native.available():
        import numpy as np
        k = min(4, args.n_batch)
        out = native.solve_box_qp_native(
            np.asarray(data.Q)[:k], np.asarray(data.p)[:k],
            np.asarray(data.A)[:k], np.asarray(data.b)[:k],
            np.asarray(data.lb)[:k], np.asarray(data.ub)[:k],
            eps_abs=1e-9, eps_rel=1e-9)
        err = np.max(np.abs(np.asarray(sol.x)[:k] - out["x"]))
        print(f"max |x_jax - x_native_cpu| over {k} elements: {err:.3e}")


if __name__ == "__main__":
    main()
