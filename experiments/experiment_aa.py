"""Anderson-acceleration ablation: iterations (and wall clock) vs window.

Sweeps the safeguarded-AA window over both solvers (box ADMM, genqp
splitting), both problem families (random-SPD 'create', ill-conditioned
sparse 'hard'), and both dtypes, recording iteration counts, convergence,
and solution agreement with the plain run.  Iteration counts are
device-independent (lock-step traced algorithm), so a CPU capture of this
artifact is meaningful; wall-clock columns are whatever device the run
sees (run it on the GPU for device times).

Run:  python experiments/experiment_aa.py --sizes 50 100 250
"""

import argparse
import json
import statistics
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, GenQPConfig, solve_box_qp
from lqp_py_tpu.models.genqp import solve_qp_gen
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
from lqp_py_tpu.utils.profiling import force as _force


def _timed(f, *args, n_sims):
    _force(f(*args))
    ts = []
    for _ in range(n_sims):
        t0 = time.perf_counter()
        _force(f(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def run_cell(family, n_x, n_batch, tol, windows, n_sims):
    gen = generate_hard_qp if family == "hard" else create_qp_data
    data = gen(n_x, n_batch, seed=0, dtype=jnp.float32)
    Q, p, A, b, lb, ub = data[:6]
    G, h = data.with_G_h()
    out = {}

    plain_x = {}
    for m in [0] + list(windows):
        cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol, acceleration=m)
        f = jax.jit(lambda *a, cfg=cfg: solve_box_qp(*a, config=cfg))
        sol = f(Q, p, A, b, lb, ub)
        _force(sol.x)
        cell = {"iters": int(sol.iterations),
                "n_converged": int(jnp.sum(sol.converged)),
                "time_s": _timed(f, Q, p, A, b, lb, ub, n_sims=n_sims)}
        if m == 0:
            plain_x["box"] = sol.x
        else:
            cell["max_dev_vs_plain"] = float(
                jnp.max(jnp.abs(sol.x - plain_x["box"])))
        out[f"box_aa{m}"] = cell

        gcfg = GenQPConfig(eps_abs=tol, eps_rel=tol, acceleration=m)
        fg = jax.jit(lambda *a, gcfg=gcfg: solve_qp_gen(*a, config=gcfg))
        gsol = fg(Q, p, A, b, G, h)
        _force(gsol.x)
        cell = {"iters": int(gsol.iterations),
                "n_converged": int(jnp.sum(gsol.converged)),
                "time_s": _timed(fg, Q, p, A, b, G, h, n_sims=n_sims)}
        if m == 0:
            plain_x["gen"] = gsol.x
        else:
            cell["max_dev_vs_plain"] = float(
                jnp.max(jnp.abs(gsol.x - plain_x["gen"])))
        out[f"gen_aa{m}"] = cell
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[50, 100, 250])
    ap.add_argument("--n-batch", type=int, default=64)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--windows", type=int, nargs="*", default=[10, 20])
    ap.add_argument("--n-sims", type=int, default=5)
    args = ap.parse_args()
    enable_compile_cache()

    results = {}
    for family in ("hard", "create"):
        for n_x in args.sizes:
            key = f"{family}_n{n_x}"
            results[key] = run_cell(family, n_x, args.n_batch, args.tol,
                                    args.windows, args.n_sims)
            print(key + ": " + "  ".join(
                f"{k}={v['iters']}it/{v['time_s']:.3f}s"
                for k, v in results[key].items()))

    with open("exp_aa_results.json", "w") as f:
        json.dump({"device": str(jax.devices()[0]),
                   "n_batch": args.n_batch, "tol": args.tol,
                   "n_sims": args.n_sims, "results": results}, f, indent=2)
    print("wrote exp_aa_results.json")


if __name__ == "__main__":
    main()
