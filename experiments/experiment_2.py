"""Experiment 2: end-to-end learning through the QP layer.

Replicates the reference learning benchmark (experiments/experiment_2.py:
dz=500, minibatch 32 of batch 128, 100 epochs, tol 1e-5, SGD lr=5e-4):
a linear model predicts the QP's cost vector p, the differentiable layer
solves the box QP, and the loss is the true QP objective at the layer
output.  Reports cumulative training wall-clock and the loss trajectory.

Run:  python experiments/experiment_2.py [--n-x 500 --epochs 100]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp

from lqp_py_tpu import BoxQPConfig
from lqp_py_tpu.models.train import (init_params, make_train_scan,
                                     make_train_step)
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.generators import create_qp_data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-features", type=int, default=5)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--mini-batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--tol", type=float, default=1e-5)
    args = ap.parse_args()
    enable_compile_cache()

    dtype = jnp.float32
    data = create_qp_data(args.n_x, args.n_batch, seed=0, dtype=dtype)
    key = jax.random.PRNGKey(0)
    kf, kb, kp = jax.random.split(key, 3)
    features = jax.random.normal(kf, (args.n_batch, args.n_features), dtype)
    beta_true = jax.random.normal(kb, (args.n_features, args.n_x), dtype)
    p_true = features @ beta_true  # ground-truth linear cost

    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol)
    step = jax.jit(make_train_step(cfg, lr=args.lr))
    params = init_params(kp, args.n_features, args.n_x, dtype)

    # Compile once on a minibatch shape.
    idx = jnp.arange(args.mini_batch)
    mb = tuple(v[idx] for v in (features, data.Q, p_true, data.A, data.b,
                                data.lb, data.ub))
    params, l0 = step(params, *mb)
    _ = float(l0)  # force compile+run

    # Precompute every epoch's minibatch indices so the per-step and fused
    # paths train on identical data in identical order.
    rng = np.random.RandomState(0)
    sel_all = jnp.asarray(np.stack([
        rng.choice(args.n_batch, args.mini_batch, replace=False)
        for _ in range(args.epochs)]).astype(np.int32))

    # Path 1: per-step Python loop (the reference's shape — one dispatch
    # and one host read per epoch).
    params_loop = params
    losses = []
    t_total = 0.0
    for epoch in range(args.epochs):
        mb = tuple(v[sel_all[epoch]] for v in (features, data.Q, p_true,
                                               data.A, data.b, data.lb,
                                               data.ub))
        t0 = time.perf_counter()
        params_loop, loss = step(params_loop, *mb)
        losses.append(float(loss))  # host read forces completion
        t_total += time.perf_counter() - t0
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d}  loss {losses[-1]:.5f}  "
                  f"cum time {t_total:.2f}s")

    # Path 2: whole horizon fused into one lax.scan dispatch (same
    # workload, one dispatch).
    run = jax.jit(make_train_scan(cfg, lr=args.lr))
    full = (features, data.Q, p_true, data.A, data.b, data.lb, data.ub)
    t0 = time.perf_counter()
    params_fused, losses_fused = run(params, sel_all, *full)
    losses_fused = np.asarray(losses_fused)  # forces completion
    fused_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, lf2 = run(params, sel_all, *full)
    lf2 = np.asarray(lf2)
    fused_total_s = time.perf_counter() - t0

    # Same data, same update order -> the trajectories must agree (modulo
    # f32 reduction-order noise).
    dev = float(np.max(np.abs(losses_fused - np.asarray(losses))))
    assert dev < 1e-3 * max(1.0, abs(losses[0])), (
        f"fused vs per-step loss trajectories diverge: {dev:.3e}")

    print(f"total training time ({args.epochs} epochs): "
          f"per-step {t_total:.2f}s, fused one-dispatch {fused_total_s:.2f}s"
          f" (compile {fused_compile_s:.1f}s); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(fused agrees to {dev:.2e})")
    with open("exp2_results.json", "w") as f:
        json.dump({"device": str(jax.devices()[0]),
                   "total_time_s": t_total,
                   "fused_total_s": fused_total_s,
                   "fused_compile_s": fused_compile_s,
                   "fused_vs_loop_loss_dev": dev,
                   "losses": losses,
                   "config": vars(args)}, f, indent=2)
    print("wrote exp2_results.json")


if __name__ == "__main__":
    main()
