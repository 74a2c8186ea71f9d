"""IP accuracy/time tradeoff: refine_steps x polish sweep (verdict #6).

PARITY.md #6 records an ~6e-3 x-accuracy floor for the f32 interior point
at dz=1000/tol=1e-5; `refine_steps` and `polish` are documented to recover
digits but the claim was never published as a measured curve.  This sweep
runs both IPs (general OptNet and the box-structured variant) over
refine_steps in {0, 1, 2} x polish in {off, on}, recording

  - max |x - x_f64| on the first ``--n-oracle`` problems of sim 0, where
    x_f64 is the INDEPENDENT numpy/scipy f64 scalar ADMM
    (cpu/boxqp_numpy.py) at eps 1e-9 — resolvable to ~1e-8, unlike the
    earlier f32 tight-ADMM comparator which saturated at its own ~4e-3
    precision floor and could not measure whether refinement helped
    (round-3 advisor finding).  Reference accuracy comparator:
    /root/reference/lqp_py/optnet.py:116-125.
  - max |x - x_tight_f32| over the FULL batch (secondary, floor ~4e-3)
  - median per-call fwd wall-clock (post-compile)

into ip_accuracy_results.json, from which the default is chosen.

Run:  python experiments/experiment_ip_accuracy.py --sizes 500 1000
"""

import argparse
import json
import statistics
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, OptNetConfig
from lqp_py_tpu.models.box_ip import solve_box_qp_ip
from lqp_py_tpu.models.box_qp import solve_box_qp
from lqp_py_tpu.models.optnet import solve_qp_optnet
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.generators import create_qp_data


from lqp_py_tpu.utils.profiling import force as _force  # noqa: E402


def f64_oracle(data, n_oracle):
    """Independent f64 comparator: the numpy/scipy scalar ADMM
    (component #8) at eps 1e-9 on the first ``n_oracle`` batch elements.
    Runs on the host in float64 regardless of the accelerator dtype."""
    import numpy as np

    from lqp_py_tpu.cpu.boxqp_numpy import solve_box_qp_np

    xs = []
    for i in range(n_oracle):
        sol = solve_box_qp_np(
            np.asarray(data.Q[i], np.float64),
            np.asarray(data.p[i], np.float64),
            np.asarray(data.A[i], np.float64),
            np.asarray(data.b[i], np.float64),
            np.asarray(data.lb[i], np.float64),
            np.asarray(data.ub[i], np.float64),
            eps_abs=1e-9, eps_rel=1e-9, max_iters=100000)
        assert sol["converged"], f"f64 oracle failed on element {i}"
        xs.append(sol["x"])
    return np.stack(xs)


def sweep_size(n_x, n_batch, tol, n_reps, n_oracle):
    import numpy as np

    n_oracle = min(n_oracle, n_batch)
    data = create_qp_data(n_x, n_batch, seed=0, dtype=jnp.float32)
    G, h = data.with_G_h()

    tight = BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6, max_iters=2000)
    x_tight = jax.jit(lambda *a: solve_box_qp(*a, tight).x)(*data)
    _force(x_tight)

    print(f"n={n_x}: solving {n_oracle} problems with the f64 numpy "
          f"oracle (eps 1e-9)...", flush=True)
    x64 = f64_oracle(data, n_oracle)
    dev_tight64 = float(np.max(np.abs(
        np.asarray(x_tight[:n_oracle], np.float64) - x64)))
    print(f"n={n_x}: f32 tight-ADMM comparator itself deviates "
          f"{dev_tight64:.2e} from f64 — the old comparator's floor",
          flush=True)

    def devs(x):
        return {
            "max_dev_x_vs_f64": float(np.max(np.abs(
                np.asarray(x[:n_oracle], np.float64) - x64))),
            "max_dev_x_vs_tight": float(jnp.max(jnp.abs(x - x_tight))),
        }

    cells = []
    for refine in (0, 1, 2):
        for polish in (False, True):
            cfg = OptNetConfig(tol=tol, max_iters=30,
                               refine_steps=refine, polish=polish)

            for label, fn, args in (
                ("OptNet_IP",
                 jax.jit(lambda *a: solve_qp_optnet(*a, config=cfg).x),
                 (data.Q, data.p, data.A, data.b, G, h)),
                ("BoxIP",
                 jax.jit(lambda *a: solve_box_qp_ip(*a, config=cfg).x),
                 tuple(data)),
            ):
                x = fn(*args)
                _force(x)   # compile
                d = devs(x)
                ts = []
                for _ in range(n_reps):
                    t0 = time.perf_counter()
                    _force(fn(*args))
                    ts.append(time.perf_counter() - t0)
                cell = {"solver": label, "n_x": n_x,
                        "refine_steps": refine, "polish": polish,
                        **d, "fwd_s": statistics.median(ts)}
                cells.append(cell)
                print(f"n={n_x} {label} refine={refine} polish={polish}: "
                      f"dev_f64={d['max_dev_x_vs_f64']:.2e} "
                      f"fwd={cell['fwd_s']:.4f}s", flush=True)

    # ADMM at the same working tolerance, with and without the OSQP-style
    # polish — the accuracy comparator for the IP cells above and the
    # measured cost of the polish's extra factorization.
    for polish in (False, True):
        cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol, polish=polish)
        fn = jax.jit(lambda *a, cfg=cfg: solve_box_qp(*a, cfg).x)
        x = fn(*data)
        _force(x)
        d = devs(x)
        ts = []
        for _ in range(n_reps):
            t0 = time.perf_counter()
            _force(fn(*data))
            ts.append(time.perf_counter() - t0)
        cell = {"solver": "ADMM", "n_x": n_x, "refine_steps": 0,
                "polish": polish, **d,
                "fwd_s": statistics.median(ts)}
        cells.append(cell)
        print(f"n={n_x} ADMM polish={polish}: "
              f"dev_f64={d['max_dev_x_vs_f64']:.2e} "
              f"fwd={cell['fwd_s']:.4f}s", flush=True)
    return cells


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[500, 1000])
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--n-reps", type=int, default=5)
    ap.add_argument("--n-oracle", type=int, default=8,
                    help="batch elements solved by the f64 numpy oracle")
    args = ap.parse_args()
    enable_compile_cache()

    cells = []
    for n_x in args.sizes:
        cells.extend(sweep_size(n_x, args.n_batch, args.tol, args.n_reps,
                                args.n_oracle))

    with open("ip_accuracy_results.json", "w") as f:
        json.dump({"device": str(jax.devices()[0]),
                   "n_batch": args.n_batch, "tol": args.tol,
                   "n_oracle": args.n_oracle,
                   "comparator": ("numpy/scipy f64 scalar ADMM eps=1e-9 on "
                                  "the first n_oracle elements of sim 0 "
                                  "(max_dev_x_vs_f64); f32 tight ADMM over "
                                  "the full batch kept as the secondary "
                                  "max_dev_x_vs_tight column"),
                   "cells": cells}, f, indent=2)
    print("wrote ip_accuracy_results.json")


if __name__ == "__main__":
    main()
