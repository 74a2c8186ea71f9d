"""Experiment 1 (paper variant): runtime vs TOLERANCE at a fixed size.

Counterpart of the reference's ``experiments/experiment_1_paper.py``:
dz=500, batch=128, every solver family timed at eps in {1e-1, 1e-3, 1e-5}
(the reference's 15-column "ADMM FP 1 / 3 / 5 ..." chart, its paper's
Figure 3 protocol).  The reference renders PDFs into ``images_paper/``;
this writes ``exp1_paper_results.json`` + ``exp1_paper_times.(png|pdf)``.

Run:  python experiments/experiment_1_paper.py [--n-x 500] [--n-sims 10]
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, GenQPConfig, OptNetConfig, boxqp
from lqp_py_tpu.models.genqp import qp_gen
from lqp_py_tpu.models.optnet import qp_optnet
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.generators import create_qp_data
from lqp_py_tpu.utils.profiling import force as _force

from experiments.experiment_1 import (  # noqa: E402
    grad_fn, quality_gate, time_split)

TOLS = (1e-1, 1e-3, 1e-5)


def run_tol_sweep(n_x, n_batch, n_sims):
    out = {}

    def box_data(seed):
        return tuple(create_qp_data(n_x, n_batch, seed=seed,
                                    dtype=jnp.float32))

    def gh_data(seed):
        data = create_qp_data(n_x, n_batch, seed=seed, dtype=jnp.float32)
        G, h = data.with_G_h()
        return (data.Q, data.p, data.A, data.b, G, h)

    from lqp_py_tpu import solve_box_qp
    tight_cfg = BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6, max_iters=2000)
    args0_box = box_data(0)
    args0_gh = gh_data(0)
    x_tight = jax.jit(lambda *a: solve_box_qp(*a, tight_cfg).x)(*args0_box)
    _force(x_tight)

    for tol in TOLS:
        digit = f"{-round(__import__('math').log10(tol))}"
        modes = {
            f"ADMM_FP_{digit}": BoxQPConfig(
                eps_abs=tol, eps_rel=tol, symmetrize=False),
            f"ADMM_KKT_{digit}": BoxQPConfig(
                eps_abs=tol, eps_rel=tol, symmetrize=False, backward="kkt"),
            f"ADMM_Unroll_{digit}": BoxQPConfig(
                eps_abs=tol, eps_rel=tol, symmetrize=False, unroll=True,
                unroll_iters=60, adaptive_rho=False),
        }
        for name, cfg in modes.items():
            call = lambda Q, p, A, b, lb, ub, cfg=cfg: boxqp(
                Q, p, A, b, lb, ub, config=cfg)
            fwd = jax.jit(lambda *a, call=call: jnp.sum(call(*a)))
            out[name] = time_split(fwd, grad_fn(call), box_data, n_sims)
            out[name]["tol"] = tol
        sol0 = jax.jit(lambda *a: solve_box_qp(
            *a, modes[f"ADMM_FP_{digit}"]))(*args0_box)
        dev = float(jnp.max(jnp.abs(sol0.x - x_tight)))
        rec = {"max_dev_x_vs_tight": dev,
               "n_converged": int(jnp.sum(sol0.converged)),
               "n_problems": int(sol0.converged.shape[0]),
               "iterations": int(sol0.iterations)}
        # Only the tight column must match the tight reference closely;
        # loose tolerances legitimately deviate ~O(tol).
        if tol <= 1e-5:
            quality_gate(f"ADMM_FP_{digit}", sol0.x, x_tight,
                         sol0.converged, sol0.iterations)
        out[f"ADMM_FP_{digit}"].update(rec)
        out[f"ADMM_KKT_{digit}"].update(rec)

        # Interior point (the reference times qpth/OptNet here).
        ip_cfg = OptNetConfig(tol=tol, symmetrize=False)
        ip_call = lambda Q, p, A, b, G, h, c=ip_cfg: qp_optnet(
            Q, p, A, b, G, h, config=c)
        fwd = jax.jit(lambda *a, call=ip_call: jnp.sum(call(*a)))
        out[f"OptNet_{digit}"] = time_split(fwd, grad_fn(ip_call), gh_data,
                                            n_sims)
        out[f"OptNet_{digit}"]["tol"] = tol

        # Operator splitting (the reference times SCS here).
        gen_cfg = GenQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False)
        gen_call = lambda Q, p, A, b, G, h, c=gen_cfg: qp_gen(
            Q, p, A, b, G, h, config=c)
        fwd = jax.jit(lambda *a, call=gen_call: jnp.sum(call(*a)))
        out[f"GenQP_{digit}"] = time_split(fwd, grad_fn(gen_call), gh_data,
                                           n_sims)
        out[f"GenQP_{digit}"]["tol"] = tol
        print(f"[exp1_paper] tol={tol:g} done", file=sys.stderr)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--n-sims", type=int, default=10)
    args = ap.parse_args()
    enable_compile_cache()

    res = run_tol_sweep(args.n_x, args.n_batch, args.n_sims)
    payload = {
        "protocol": {
            "n_x": args.n_x, "n_batch": args.n_batch,
            "n_sims": args.n_sims, "tols": list(TOLS),
            "device": str(jax.devices()[0]),
            "reference": "experiments/experiment_1_paper.py (dz=500, "
                         "tol sweep 1e-1/1e-3/1e-5, median of 10 sims)",
        },
        "results": res,
    }
    with open("exp1_paper_results.json", "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps({k: round(v["total"], 4) for k, v in res.items()}))

    try:
        from experiments.plotting import plot_profile_bars
        # One bar group per tolerance digit.
        grouped = {}
        for name, rec in res.items():
            base, digit = name.rsplit("_", 1)
            grouped.setdefault(int(digit), {})[base] = rec["total"]
        for ext in ("png", "pdf"):
            plot_profile_bars(
                grouped, f"exp1_paper_times.{ext}",
                title=f"fwd+bwd vs tolerance (dz={args.n_x}, B="
                      f"{args.n_batch}); x = -log10(eps)")
    except Exception as e:   # chart is best-effort
        print(f"[exp1_paper] plot skipped: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
