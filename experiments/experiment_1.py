"""Experiment 1: forward+backward runtime sweep across problem sizes.

Replicates the reference benchmark protocol (experiments/experiment_1.py:
batch=128, tol 1e-5, median over n_sims of fwd+bwd wall-clock) across the
framework's solver family:

- ADMM fixed-point / KKT / unrolled backward (the three reference modes)
- OptNet-style interior point (general inequalities)
- GenQP operator splitting (the SCS-capability solver)
- native C++ CPU ADMM (the sequential baseline, like the reference's SCS)

Writes exp1_results.json (+ a bar chart if matplotlib is importable).

Run:  python experiments/experiment_1.py --sizes 10 50 100 250 500 1000
"""

import argparse
import json
import statistics
import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig, GenQPConfig, OptNetConfig, boxqp
from lqp_py_tpu.models.genqp import qp_gen
from lqp_py_tpu.models.optnet import qp_optnet
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.generators import create_qp_data


from lqp_py_tpu.utils.profiling import force as _force  # noqa: E402


# Per-mode deviation gate vs the tight-tolerance ADMM reference on sim 0
# (f32; the IP x-accuracy floor at dz=1000 is ~6e-3 — PARITY.md #6 — so
# 2e-2 catches a mis-tuned unroll_iters / max_iters drift without
# flagging the known float32 floor).
DEV_GATE = 2e-2


def quality_gate(name, x_mode, x_tight, converged=None, iterations=None):
    """Convergence/accuracy stats for a timed mode (sim 0): nothing in the
    timed path asserts the solves are good, so a config/generator drift
    could silently benchmark non-converged solves.  Returns the record and
    raises if the mode regressed."""
    dev = float(jnp.max(jnp.abs(jnp.asarray(x_mode) - jnp.asarray(x_tight))))
    rec = {"max_dev_x_vs_tight": dev}
    if converged is not None:
        rec["n_converged"] = int(jnp.sum(converged))
        rec["n_problems"] = int(converged.shape[0])
        assert rec["n_converged"] == rec["n_problems"], (
            f"{name}: only {rec['n_converged']}/{rec['n_problems']} "
            f"problems converged in the timed configuration")
    if iterations is not None:
        rec["iterations"] = int(iterations)
    assert dev < DEV_GATE, (
        f"{name}: max |x - x_tight| = {dev:.3e} exceeds the {DEV_GATE} "
        f"gate — the timed configuration is returning inaccurate solves")
    return rec


def time_split(fwd_fn, tot_fn, data_for_seed, n_sims):
    """Reference protocol (/root/reference/experiments/experiment_1.py:55-101):
    fresh problem data per sim (seed=i), forward and forward+backward timed
    separately, median over sims with ~95% error bars (1.96 std/sqrt(n)).
    Backward = total - forward (JAX residual-reuse makes an isolated
    backward timing impossible without re-running the forward)."""
    args0 = data_for_seed(0)
    _force(fwd_fn(*args0))   # compile
    _force(tot_fn(*args0))
    fwd_ts, tot_ts = [], []
    for i in range(n_sims):
        args = data_for_seed(i)
        jax.block_until_ready(args)   # exclude generation/transfer
        t0 = time.perf_counter()
        _force(fwd_fn(*args))
        fwd_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _force(tot_fn(*args))
        tot_ts.append(time.perf_counter() - t0)

    def med(ts):
        return statistics.median(ts)

    def ci(ts):
        return 1.96 * statistics.pstdev(ts) / len(ts) ** 0.5

    # bwd is a DERIVED quantity (total - fwd medians): when the true
    # backward cost is below the per-call dispatch noise the difference
    # can come out negative, which is meaningless as a duration — clamp
    # at 0 (round-3 advisor finding); `total` remains the measured number.
    return {"fwd": med(fwd_ts), "bwd": max(med(tot_ts) - med(fwd_ts), 0.0),
            "total": med(tot_ts),
            "fwd_ci": ci(fwd_ts), "total_ci": ci(tot_ts)}


def grad_fn(layer_call):
    """jit'd fwd+bwd where ALL problem arrays are jit arguments — closing
    over G (B, 2n, n) would bake a ~1 GB constant into the HLO at
    dz=1000."""
    def loss(Q, p, *rest):
        return jnp.sum(layer_call(Q, p, *rest))
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))


def run_size(n_x, n_batch, tol, n_sims, include_ip):
    out = {}

    def box_data(seed):
        return tuple(create_qp_data(n_x, n_batch, seed=seed,
                                    dtype=jnp.float32))

    def gh_data(seed):
        data = create_qp_data(n_x, n_batch, seed=seed, dtype=jnp.float32)
        G, h = data.with_G_h()
        return (data.Q, data.p, data.A, data.b, G, h)

    args0_box = box_data(0)
    args0_gh = gh_data(0)

    # Tight-tolerance ADMM reference on sim 0: the accuracy comparator for
    # every timed mode (gh_data(0) is the same QP with the box written as
    # G = [-I; I], so one reference serves all modes).
    from lqp_py_tpu import solve_box_qp
    tight_cfg = BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6, max_iters=2000)
    x_tight = jax.jit(lambda *a: solve_box_qp(*a, tight_cfg).x)(*args0_box)
    _force(x_tight)

    # symmetrize=False is protocol-fair for the timed columns: the
    # generators emit exactly symmetric Q and the reference performs no
    # symmetrization pass (solve_box_qp_admm_torch.py:161-215).
    modes = {
        "ADMM_FP": BoxQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False,
                               backward="fixed_point"),
        "ADMM_KKT": BoxQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False,
                                backward="kkt"),
        # The tuned solver converges in ~21-31 iterations on this family;
        # 60 static unrolled iterations is a ~2x margin over observed
        # convergence (the reference's dynamic unroll runs ~61 iterations
        # at ITS rho defaults — same relative margin).
        "ADMM_Unroll": BoxQPConfig(eps_abs=tol, eps_rel=tol, unroll=True,
                                   symmetrize=False,
                                   unroll_iters=60, adaptive_rho=False),
    }
    for name, cfg in modes.items():
        call = lambda Q, p, A, b, lb, ub, cfg=cfg: boxqp(
            Q, p, A, b, lb, ub, config=cfg)
        fwd = jax.jit(lambda *a, call=call: jnp.sum(call(*a)))
        out[name] = time_split(fwd, grad_fn(call), box_data, n_sims)

    # Convergence/accuracy gate for the while-loop ADMM (FP and KKT share
    # the forward solve; only the backward formulation differs).
    sol0 = jax.jit(lambda *a: solve_box_qp(*a, modes["ADMM_FP"]))(*args0_box)
    q = quality_gate("ADMM", sol0.x, x_tight, sol0.converged,
                     sol0.iterations)
    out["ADMM_FP"].update(q)
    out["ADMM_KKT"].update(q)

    # The unrolled scan has no converged flag (fixed iteration count, x
    # only) — the deviation gate is what catches an undersized
    # unroll_iters.
    from lqp_py_tpu.models.box_qp import solve_box_qp_unrolled
    x_u = jax.jit(
        lambda *a: solve_box_qp_unrolled(*a, modes["ADMM_Unroll"]))(
            *args0_box)
    out["ADMM_Unroll"].update(quality_gate("ADMM_Unroll", x_u, x_tight))

    gen_cfg = GenQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False)
    gen_call = lambda Q, p, A, b, G, h: qp_gen(Q, p, A, b, G, h,
                                               config=gen_cfg)
    fwd = jax.jit(lambda *a: jnp.sum(gen_call(*a)))
    out["GenQP"] = time_split(fwd, grad_fn(gen_call), gh_data, n_sims)
    from lqp_py_tpu.models.genqp import solve_qp_gen
    sol_g = jax.jit(lambda *a: solve_qp_gen(*a, config=gen_cfg))(*args0_gh)
    out["GenQP"].update(quality_gate("GenQP", sol_g.x, x_tight,
                                     sol_g.converged, sol_g.iterations))

    if include_ip:
        ip_cfg = OptNetConfig(tol=tol, max_iters=30, symmetrize=False)
        ip_call = lambda Q, p, A, b, G, h: qp_optnet(Q, p, A, b, G, h,
                                                     config=ip_cfg)
        fwd = jax.jit(lambda *a: jnp.sum(ip_call(*a)))
        out["OptNet_IP"] = time_split(fwd, grad_fn(ip_call), gh_data, n_sims)
        from lqp_py_tpu.models.optnet import solve_qp_optnet
        sol_i = jax.jit(
            lambda *a: solve_qp_optnet(*a, config=ip_cfg))(*args0_gh)
        out["OptNet_IP"].update(quality_gate(
            "OptNet_IP", sol_i.x, x_tight, sol_i.converged,
            sol_i.iterations))

        # Box-structured IP on the same problems (G = [-I; I] exploited
        # analytically; same reference comparator as OptNet_IP).
        from lqp_py_tpu.models.box_ip import boxqp_ip, solve_box_qp_ip
        bip_call = lambda Q, p, A, b, lb, ub: boxqp_ip(Q, p, A, b, lb, ub,
                                                       config=ip_cfg)
        fwd = jax.jit(lambda *a: jnp.sum(bip_call(*a)))
        out["BoxIP"] = time_split(fwd, grad_fn(bip_call), box_data, n_sims)
        sol_bi = jax.jit(
            lambda *a: solve_box_qp_ip(*a, config=ip_cfg))(*args0_box)
        out["BoxIP"].update(quality_gate(
            "BoxIP", sol_bi.x, x_tight, sol_bi.converged,
            sol_bi.iterations))

    # Native CPU baseline (forward only; sequential like the reference SCS).
    from lqp_py_tpu.cpu import native
    if native.available():
        data = box_data(0)
        Qn, pn, An, bn, lbn, ubn = (np.asarray(v, np.float64) for v in data)
        t0 = time.perf_counter()
        native.solve_box_qp_native(Qn, pn, An, bn, lbn, ubn,
                                   eps_abs=tol, eps_rel=tol)
        out["Native_CPU_fwd"] = {"fwd": time.perf_counter() - t0}

    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[10, 50, 100, 250, 500])
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--n-sims", type=int, default=5)
    ap.add_argument("--max-ip-size", type=int, default=10_000,
                    help="skip the interior-point solver above this size "
                         "(the condensed n x n factorization completes at "
                         "every reference size; cap kept as an escape hatch)")
    args = ap.parse_args()
    enable_compile_cache()

    results = {}
    for n_x in args.sizes:
        r = run_size(n_x, args.n_batch, args.tol, args.n_sims,
                     include_ip=n_x <= args.max_ip_size)
        results[n_x] = r
        print(f"n_x={n_x}: " + "  ".join(
            f"{k}={v.get('total', v['fwd']):.4f}s"
            f"(f{v['fwd']:.4f}/b{v.get('bwd', 0):.4f})"
            for k, v in r.items()))

    # Merge with any existing results file (same device/protocol) so the
    # sweep can be (re)run size-by-size without losing other sizes.
    merged = dict(results)
    try:
        with open("exp1_results.json") as f:
            old = json.load(f)
        if (old.get("device") == str(jax.devices()[0])
                and old.get("tol") == args.tol
                and old.get("n_batch") == args.n_batch):
            for k, v in old.get("results", {}).items():
                merged.setdefault(int(k), v)
    except (FileNotFoundError, json.JSONDecodeError, ValueError):
        pass
    results = {int(k): v for k, v in merged.items()}
    with open("exp1_results.json", "w") as f:
        json.dump({"device": str(jax.devices()[0]),
                   "n_batch": args.n_batch, "tol": args.tol,
                   "n_sims": args.n_sims,
                   "results": results}, f, indent=2)
    print("wrote exp1_results.json")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        sizes = sorted(results)
        names = sorted({k for r in results.values() for k in r})
        fig, ax = plt.subplots(figsize=(8, 4))
        width = 0.8 / len(names)
        for i, name in enumerate(names):
            cells = [results[s].get(name) for s in sizes]
            ys = [c.get("total", c["fwd"]) if c else float("nan")
                  for c in cells]
            errs = [c.get("total_ci", 0.0) if c else 0.0 for c in cells]
            ax.bar([j + i * width for j in range(len(sizes))], ys,
                   width, yerr=errs, label=name)
        ax.set_yscale("log")
        ax.set_xticks([j + 0.4 for j in range(len(sizes))])
        ax.set_xticklabels([str(s) for s in sizes])
        ax.set_xlabel("n_x")
        ax.set_ylabel("median fwd+bwd time (s)")
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig("exp1_times.png", dpi=120)
        print("wrote exp1_times.png")
    except Exception as e:  # plotting is best-effort
        print(f"(no chart: {e})")


if __name__ == "__main__":
    main()
