"""Serving / MPC-style benchmark: repeated solves under slowly drifting
problem data, cold-start vs warm-start.

The reference's ``BoxQPTH`` class hints at a solve/update/re-solve workflow
but always cold-starts from zeros (solve_box_qp_admm_torch.py:221-223).
This framework's ``warm_start`` path re-uses the previous (x, z, u), which
for a drifting cost vector collapses the iteration count to near the check
interval — the regime that matters for deployment (control loops, rolling
re-optimization, RL policy layers).

Run:  python experiments/experiment_serving.py [--n-x 500 --steps 20]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, solve_box_qp
from lqp_py_tpu.models.box_qp import prepare_box_qp, solve_box_qp_prepared
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.generators import create_qp_data


from lqp_py_tpu.utils.profiling import force as _force  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--drift", type=float, default=0.02)
    ap.add_argument("--tol", type=float, default=1e-5)
    args = ap.parse_args()
    enable_compile_cache()

    data = create_qp_data(args.n_x, args.n_batch, seed=0, dtype=jnp.float32)
    Q, p0, A, b, lb, ub = data
    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol)

    # All problem arrays (and the prepared state, a pytree) are jit
    # ARGUMENTS, not closure captures: closing over the B x n x n factors
    # would bake them into the HLO as constants (gigabytes at larger
    # sizes).
    @jax.jit
    def cold(Q, p, A, b, lb, ub):
        s = solve_box_qp(Q, p, A, b, lb, ub, cfg)
        return s, jnp.sum(s.x)

    # Prepared path: scaling + factorization cached across solves (Q, A,
    # bounds fixed; only p drifts) + warm-started iterates.
    prep = prepare_box_qp(Q, A, b, lb, ub, config=cfg)

    @jax.jit
    def warm(prep, p, prev):
        s = solve_box_qp_prepared(prep, p, config=cfg, warm_start=prev)
        return s, jnp.sum(s.x)

    key = jax.random.PRNGKey(1)
    drifts = jax.random.normal(key, (args.steps,) + p0.shape, jnp.float32)

    # compile
    sol, c = cold(Q, p0, A, b, lb, ub)
    _force(c)
    _force(warm(prep, p0, sol)[1])

    results = {"cold": [], "warm": [], "cold_iters": [], "warm_iters": []}
    prev = sol
    p = p0
    for t in range(args.steps):
        p = p + args.drift * drifts[t]

        t0 = time.perf_counter()
        s_c, c = cold(Q, p, A, b, lb, ub)
        _force(c)
        results["cold"].append(time.perf_counter() - t0)
        results["cold_iters"].append(int(s_c.iterations))

        t0 = time.perf_counter()
        s_w, c = warm(prep, p, prev)
        _force(c)
        results["warm"].append(time.perf_counter() - t0)
        results["warm_iters"].append(int(s_w.iterations))
        prev = s_w

    # --- fused rollout: ALL steps inside one jit (lax.scan over drifting
    # p with warm starts).  This is the batched serving shape — one
    # dispatch for the whole control horizon — which an eager per-solve
    # design cannot express.
    @jax.jit
    def rollout(prep, p0, drifts, sol0):
        def step(carry, dp):
            p, prev = carry
            p = p + args.drift * dp
            s = solve_box_qp_prepared(prep, p, config=cfg, warm_start=prev)
            return (p, s), (jnp.sum(s.x), s.iterations)
        (_, _), (sums, iters) = jax.lax.scan(step, (p0, sol0), drifts)
        return sums, iters

    sums, f_iters = rollout(prep, p0, drifts, sol)
    _force(sums)
    t0 = time.perf_counter()
    sums, f_iters = rollout(prep, p0, drifts, sol)
    _force(sums)
    t_fused = (time.perf_counter() - t0) / args.steps
    results["fused_per_solve"] = t_fused
    results["fused_iters"] = [int(i) for i in f_iters]

    # --- same serving shape for the general-inequality solver (round-3
    # capability: prepare_qp_gen + solve_qp_gen_prepared + warm_start).
    from lqp_py_tpu import GenQPConfig, prepare_qp_gen, solve_qp_gen_prepared
    G, h = data.with_G_h()
    gcfg = GenQPConfig(eps_abs=args.tol, eps_rel=args.tol)
    gprep = prepare_qp_gen(Q, A, b, G, h, config=gcfg)

    @jax.jit
    def gen_first(gprep, p):
        s = solve_qp_gen_prepared(gprep, p, config=gcfg)
        return s, jnp.sum(s.x)

    @jax.jit
    def rollout_gen(gprep, p0, drifts, sol0):
        def step(carry, dp):
            p, prev = carry
            p = p + args.drift * dp
            s = solve_qp_gen_prepared(gprep, p, config=gcfg,
                                      warm_start=prev)
            return (p, s), (jnp.sum(s.x), s.iterations)
        (_, _), (sums, iters) = jax.lax.scan(step, (p0, sol0), drifts)
        return sums, iters

    sol_g, c = gen_first(gprep, p0)
    _force(c)
    sums_g, g_iters = rollout_gen(gprep, p0, drifts, sol_g)
    _force(sums_g)
    t0 = time.perf_counter()
    sums_g, g_iters = rollout_gen(gprep, p0, drifts, sol_g)
    _force(sums_g)
    results["genqp_fused_per_solve"] = (time.perf_counter() - t0) / args.steps
    results["genqp_fused_iters"] = [int(i) for i in g_iters]

    import statistics
    med_c = statistics.median(results["cold"])
    med_w = statistics.median(results["warm"])
    print(f"n_x={args.n_x} batch={args.n_batch} drift={args.drift} "
          f"tol={args.tol}")
    print(f"cold: median {med_c*1e3:.1f} ms/solve, "
          f"iters {statistics.median(results['cold_iters'])}")
    print(f"warm: median {med_w*1e3:.1f} ms/solve, "
          f"iters {statistics.median(results['warm_iters'])}  "
          f"({med_c/med_w:.2f}x faster)")
    print(f"fused rollout (one jit for all {args.steps} steps): "
          f"{t_fused*1e3:.1f} ms/solve, "
          f"iters {statistics.median(results['fused_iters'])}  "
          f"({med_c/t_fused:.2f}x faster than cold)")
    print(f"genqp fused rollout: "
          f"{results['genqp_fused_per_solve']*1e3:.1f} ms/solve, "
          f"iters {statistics.median(results['genqp_fused_iters'])}")

    with open("exp_serving_results.json", "w") as f:
        json.dump({"device": str(jax.devices()[0]), "n_x": args.n_x,
                   "n_batch": args.n_batch, "drift": args.drift,
                   "tol": args.tol, **results}, f, indent=2)
    print("wrote exp_serving_results.json")


if __name__ == "__main__":
    main()
