"""Benchmark: reference Experiment-1 protocol on the flagship solver.

Protocol (BASELINE.md): batch=128, dz=1000, eps_abs=eps_rel=1e-5, median
forward+backward wall-clock; data = create_qp_data random SPD box QPs.
The reference's published number on its CPU baseline is ~2.6 s total at
dz=1000 (images/exp_1_n_1000.png) — that is ``vs_baseline``'s denominator.

Needs a GPU; stops without one.  Prints the device (kind, count, card name
and power limit), per-size lines to stderr, and ONE JSON line to stdout:
  {"metric": "exp1_dz1000_total_s", "value": <median s>, "unit": "s",
   "vs_baseline": <ref_time / our_time>, "device": "<device_kind>"}
Detail (per-size sweep, iterations, convergence, device) also goes to
chiprun_out/bench_detail.json.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, boxqp, solve_box_qp
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.device import describe, require_gpu
from lqp_py_tpu.utils.generators import create_qp_data

# Reference ADMM-FP totals (s) read off the published charts (BASELINE.md).
REF_TOTAL_S = {10: 0.025, 50: 0.027, 100: 0.068, 250: 0.26, 500: 0.75,
               1000: 2.6}


def bench_one(n_x, n_batch=128, tol=1e-5, n_sims=10, dtype=jnp.float32,
              seed=0):
    # symmetrize=False is protocol-fair: the generators emit exactly
    # symmetric Q and the reference solver performs no symmetrization
    # pass either (solve_box_qp_admm_torch.py:161-215) — the defensive
    # default pays a full (B, n, n) HBM round trip the reference never
    # does.
    cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False)
    data = create_qp_data(n_x, n_batch, seed=seed, dtype=dtype)
    Q, p, A, b, lb, ub = data

    # Sweep-path accuracy, asserted on the device each round (the CPU
    # tests run the Pallas kernel interpreted only, so a compiled-kernel
    # regression could otherwise hide behind a still-converging solver).
    from lqp_py_tpu.ops.linalg import spd_inverse_fast

    @jax.jit
    def sweep_residual(Q):
        eye = jnp.eye(Q.shape[-1], dtype=Q.dtype)
        H = Q + eye
        Hi = spd_inverse_fast(H)
        R = jnp.einsum("bij,bjk->bik", H, Hi, precision="highest",
                       preferred_element_type=Q.dtype) - eye
        return jnp.max(jnp.abs(R))

    sweep_res = float(sweep_residual(Q))
    print(f"[bench] dz={n_x} sweep residual {sweep_res:.3e}",
          file=sys.stderr)
    assert 0.0 < sweep_res < 1e-2, (
        f"sweep-path inverse residual {sweep_res:.3e} at n={n_x} — "
        f"kernel regression")

    @jax.jit
    def fwd(Q, p):
        return solve_box_qp(Q, p, A, b, lb, ub, cfg)

    @jax.jit
    def fwd_bwd(Q, p):
        def loss(Q, p):
            x = boxqp(Q, p, A, b, lb, ub, config=cfg)
            return jnp.sum(x)
        return jax.value_and_grad(loss, argnums=(0, 1))(Q, p)

    # Compile (excluded — steady-state serving numbers; the reference's
    # torch eager path has no compile step to amortize).
    t0 = time.perf_counter()
    sol = jax.block_until_ready(fwd(Q, p))
    compile_fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fwd_bwd(Q, p))
    compile_total_s = time.perf_counter() - t0

    conv = bool(jnp.all(sol.converged))
    iters = int(sol.iterations)

    fwd_times, tot_times = [], []
    for _ in range(n_sims):
        t0 = time.perf_counter()
        jax.block_until_ready(fwd(Q, p))
        fwd_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(fwd_bwd(Q, p))
        tot_times.append(time.perf_counter() - t0)

    return {
        "n_x": n_x, "n_batch": n_batch, "tol": tol,
        "dtype": jnp.dtype(dtype).name,
        "sweep_residual_inf": sweep_res,
        "fwd_s": statistics.median(fwd_times),
        "total_s": statistics.median(tot_times),
        "bwd_s": max(statistics.median(tot_times)
                     - statistics.median(fwd_times), 0.0),
        "iterations": iters, "converged": conv,
        "compile_fwd_s": compile_fwd_s, "compile_total_s": compile_total_s,
        "ref_total_s": REF_TOTAL_S.get(n_x),
        "speedup_vs_ref": (REF_TOTAL_S[n_x] / statistics.median(tot_times)
                           if n_x in REF_TOTAL_S else None),
        "max_primal_residual": float(jnp.max(sol.primal_residual)),
        "max_dual_residual": float(jnp.max(sol.dual_residual)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[1000])
    ap.add_argument("--n-sims", type=int, default=10)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    device = require_gpu()
    enable_compile_cache()
    print(describe(device), file=sys.stderr)
    detail = {"device": describe(device), "results": []}
    for n_x in args.sizes:
        r = bench_one(n_x, n_batch=args.n_batch, tol=args.tol,
                      n_sims=args.n_sims, dtype=dtype)
        detail["results"].append(r)
        print(f"[bench] dz={n_x}: fwd={r['fwd_s']:.4f}s "
              f"total={r['total_s']:.4f}s iters={r['iterations']} "
              f"converged={r['converged']} "
              f"speedup={r['speedup_vs_ref']}", file=sys.stderr)

    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_detail.json").write_text(json.dumps(detail, indent=2))

    # Headline metric: the largest size of this run.
    r = max(detail["results"], key=lambda r: r["n_x"])
    ref = r["ref_total_s"] or r["total_s"]
    print(json.dumps({
        "metric": f"exp1_dz{r['n_x']}_total_s",
        "value": round(r["total_s"], 6),
        "unit": "s",
        "vs_baseline": round(ref / r["total_s"], 3),
        "device": device.device_kind,
    }))


if __name__ == "__main__":
    main()
