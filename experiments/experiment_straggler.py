"""Straggler-skewed serving batch: what lock-step batching costs.

The batched solver runs every element until the slowest converges: a few
ill-conditioned stragglers keep the lock-step loop alive long after the
bulk of the batch has converged (e.g. one hard MPC instance among many
easy ones).  This records that workload's time and iterations, the
baseline for a per-element early exit on the card.

Batch: all ``n_batch`` problems come from the hard generator (so the
equality blocks share one shape); all but ``n_hard`` of them get a ridge
``mean(diag Q) * I`` added, which collapses their condition number and
makes them converge in a few dozen iterations while the un-ridged
stragglers need hundreds — so for most of the solve the skip fraction is
~(1 - n_hard/n_batch).  (A first attempt mixed box-only easy/hard
batches: WITHOUT the equality constraints the "hard" set converges in
~25 iterations and no skew materializes — the difficulty lives in the
sparse equality rows + conditioning, not the box.)

Writes exp_straggler_results.json (in the working directory).

Run:  python experiments/experiment_straggler.py [--n-x 500 --n-hard 8]
"""

import argparse
import json
import statistics
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, solve_box_qp
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.generators import generate_hard_qp
from lqp_py_tpu.utils.profiling import force as _force


def mixed_batch(n_x, n_batch, n_hard, seed=0):
    hard = generate_hard_qp(n_x, n_batch, seed=seed, dtype=jnp.float32)
    # Ridge the leading (n_batch - n_hard) elements into easy problems;
    # the bounds stay feasible (they are anchored to a point of Ax=b,
    # which does not involve Q).
    ridge = jnp.mean(jnp.diagonal(hard.Q, axis1=-2, axis2=-1),
                     axis=-1)                                # (B,)
    is_easy = (jnp.arange(n_batch) < n_batch - n_hard)
    Q = hard.Q + jnp.where(is_easy, ridge, 0.0)[:, None, None] \
        * jnp.eye(n_x, dtype=hard.Q.dtype)
    return Q, hard.p, hard.A, hard.b, hard.lb, hard.ub


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--n-hard", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--n-reps", type=int, default=7)
    ap.add_argument("--max-iters", type=int, default=4000)
    args = ap.parse_args()
    enable_compile_cache()

    Q, p, A, b, lb, ub = mixed_batch(args.n_x, args.n_batch, args.n_hard)

    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol, symmetrize=False,
                      max_iters=args.max_iters)

    @jax.jit
    def solve(Q, p, A, b, lb, ub):
        return solve_box_qp(Q, p, A, b, lb, ub, cfg)

    s = _force(solve(Q, p, A, b, lb, ub))
    ts = []
    for _ in range(args.n_reps):
        t0 = time.perf_counter()
        _force(solve(Q, p, A, b, lb, ub))
        ts.append(time.perf_counter() - t0)
    out = {"n_x": args.n_x, "n_batch": args.n_batch, "n_hard": args.n_hard,
           "tol": args.tol, "device": str(jax.devices()[0]),
           "median_s": statistics.median(ts), "times": ts,
           "iterations": int(s.iterations),
           "n_converged": int(jnp.sum(s.converged)),
           "n_problems": int(s.converged.shape[0])}
    print(f"{out['median_s']*1e3:7.1f} ms  iters={out['iterations']}  "
          f"converged={out['n_converged']}/{out['n_problems']}",
          file=sys.stderr)
    with open("exp_straggler_results.json", "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({"ms": round(out["median_s"] * 1e3, 3),
                      "iterations": out["iterations"]}))


if __name__ == "__main__":
    main()
