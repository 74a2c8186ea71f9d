"""Smoke test of the batched QP solvers on NVIDIA GPUs.

    python chip_smoke.py          # one card: phases kernels, main, families
    python chip_smoke.py --four   # four cards: the sharded solves only

Drives the public entry points at the flagship of the reference's
Experiment 1 (arXiv:2112.07464): B=128 random SPD box QPs, dz=1000, f32,
eps_abs = eps_rel = 1e-5, forward plus fixed-point backward.  Every kernel
on that path runs compiled for the card and is compared with a plain
reference; every solver output is checked for convergence and KKT
residuals.  Each tolerance is printed with its reason.  Times printed here
are smoke numbers, not benchmark metrics.

The last line of standard output is ``{"ok": true, "device": {...}}``.
The script exits non-zero, without that line, when JAX finds no GPU or
any check fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import time

import numpy as np

import jax
import jax.numpy as jnp

from lqp_py_tpu import (BoxQPConfig, GenQPConfig, OptNetConfig, boxqp,
                        prepare_box_qp, solve_box_qp, solve_box_qp_ip,
                        solve_box_qp_prepared, solve_qp_gen, solve_qp_optnet)
from lqp_py_tpu.cpu.boxqp_numpy import solve_box_qp_np
from lqp_py_tpu.ops import linalg as lin
from lqp_py_tpu.ops.pallas.spd_inverse import LEAF, sweep_spd_inverse
from lqp_py_tpu.utils.compile_cache import enable_compile_cache
from lqp_py_tpu.utils.device import card_info, require_gpu
from lqp_py_tpu.utils.generators import create_qp_data, kkt_residuals

TOL = 1e-5
N_FLAGSHIP, B_FLAGSHIP = 1000, 128
#: KKT residuals of an ADMM/IP solution stopped at tolerance ``tol`` land
#: within a modest constant factor of it (the criterion of
#: tests/test_box_qp_forward.py).
KKT_FACTOR = 200


class SmokeFailure(AssertionError):
    pass


class Phase:
    """Collects the checks of one phase; ``close`` raises if any failed."""

    def __init__(self, name):
        self.name = name
        self.failed = []
        print(f"=== phase {name}", flush=True)

    def check(self, what, value, tol, reason):
        ok = value <= tol
        print(f"[{self.name}] {what}: {value:.3e} <= {tol:.3e} "
              f"{'ok' if ok else 'FAILED'}  ({reason})", flush=True)
        if not ok:
            self.failed.append(what)

    def require(self, what, ok):
        print(f"[{self.name}] {what}: {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            self.failed.append(what)

    def close(self):
        if self.failed:
            raise SmokeFailure(f"phase {self.name} failed: {self.failed}")
        print(f"[{self.name}] passed", flush=True)


def compile_timed(phase, label, fn, *args):
    """AOT-compile ``fn`` for ``args``; compile time is set-up time."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    print(f"[{phase.name}] compile {label}: "
          f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
    return compiled


def median_s(fn, *args, n=5):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def f64(a):
    return np.asarray(a, np.float64)


def factorization_operand(n, B, seed=0):
    """The solver's factorization operand: Jacobi-scaled Q plus a rho
    shift (box_qp._prep_h builds ``D Q D + rho I``)."""
    Q = create_qp_data(n, B, seed=seed, dtype=jnp.float32).Q
    _, Hs = lin._jacobi(Q)
    return Hs + 0.1 * jnp.eye(n, dtype=jnp.float32)


def diagonal_leaves(H):
    """The 128x128 diagonal blocks of identity-padded (B, n, n) H:
    (B * n_pad / 128, 128, 128), the first leaves the recursion inverts."""
    Hp = lin._pad_to_leaf(H)
    k = Hp.shape[-1] // LEAF
    return jnp.concatenate([Hp[:, i * LEAF:(i + 1) * LEAF,
                               i * LEAF:(i + 1) * LEAF] for i in range(k)])


def dot_algorithms():
    """What each einsum precision lowers to on this card (cuBLAS gemm
    backend config of the compiled HLO)."""
    a = jnp.ones((8, 256, 256), jnp.float32)
    out = {}
    for prec in ("default", "high", "highest"):
        txt = jax.jit(lambda x, y: jnp.einsum(
            "bij,bjk->bik", x, y, precision=prec)).lower(a, a).compile(
            ).as_text()
        found = re.findall(r'"(?:precision_config|algorithm|compute_type|'
                           r'selected_algorithm)":(?:\{[^}]*\}|"[^"]*")', txt)
        out[prec] = sorted(set(found)) or ["(no gemm backend config)"]
    return out


# --------------------------------------------------------------------------
# phase kernels


def phase_kernels(n=N_FLAGSHIP, B=B_FLAGSHIP, interpret=False):
    ph = Phase("kernels")
    print(f"[kernels] matmul precision: jax.default_matmul_precision"
          f"('highest'), FP32 on the CUDA cores (an f32 product without it "
          f"may run in TF32)", flush=True)
    for prec, alg in dot_algorithms().items():
        print(f"[kernels] einsum precision={prec!r} lowers to: {alg}",
              flush=True)
    reason_inv = ("f32 elimination: n * eps32 * cond(H), n=128, cond<=1e2 "
                  "for these unit-diagonal SPD blocks")
    with jax.default_matmul_precision("highest"):
        H = factorization_operand(n, B)
        leaves = diagonal_leaves(H)
        leaf_fn = functools.partial(sweep_spd_inverse, interpret=interpret)
        leaf_c = compile_timed(ph, f"sweep leaf {tuple(leaves.shape)}",
                               leaf_fn, leaves)
        Li = np.asarray(jax.block_until_ready(leaf_c(leaves)), np.float64)
        L64 = f64(leaves)
        ref = np.linalg.inv(L64)
        err = float(np.max(np.abs(Li - ref)) / np.max(np.abs(ref)))
        chol = f64(jax.jit(lin.spd_inverse)(leaves))
        cond = float(np.max(np.linalg.cond(L64[::64])))
        print(f"[kernels] leaf cond (every 64th) max {cond:.2e}; plain "
              f"Cholesky reference error "
              f"{np.max(np.abs(chol - ref)) / np.max(np.abs(ref)):.3e}",
              flush=True)
        ph.check("sweep leaf vs numpy f64, max rel error", err, 1e-4,
                 reason_inv)
        print(f"[kernels] sweep leaf {median_s(leaf_c, leaves) * 1e3:.3f} ms"
              f" (smoke)", flush=True)

        inv_c = compile_timed(ph, f"spd_inverse_fast {tuple(H.shape)}",
                              lin.spd_inverse_fast, H)
        Hi = f64(inv_c(H)[:4])
        H64 = f64(H[:4])
        res = float(np.max(np.abs(H64 @ Hi - np.eye(n))))
        ph.check("spd_inverse_fast ||H Hinv - I||_inf (4 elements, f64)",
                 res, 1e-4, "n=1000 recursion of f32 GEMMs over leaves; "
                 "cond(H)<=1e2 after Jacobi scaling")
        R = jax.random.normal(jax.random.PRNGKey(1), (B, n, 2), jnp.float32)
        sol_c = compile_timed(ph, f"spd_solve_fast {tuple(H.shape)}",
                              lin.spd_solve_fast, H, R)
        X = f64(sol_c(H, R)[:4])
        ref_x = np.linalg.solve(H64, f64(R[:4]))
        err = float(np.max(np.abs(X - ref_x)) / np.max(np.abs(ref_x)))
        ph.check("spd_solve_fast vs numpy f64 solve, max rel error", err,
                 1e-4, "same bound as the inverse")
    ph.close()


# --------------------------------------------------------------------------
# phase main


def kkt_check(ph, label, data, sol_x, lams, nus, tol):
    Q, p, A, b, lb, ub = data
    res = kkt_residuals(Q, p, A, b, lb, ub, sol_x, lams, nus)
    scale = 1.0 + float(jnp.max(jnp.abs(sol_x)))
    for name, v in res.items():
        ph.check(f"{label} KKT {name} (max over batch)", float(jnp.max(v)),
                 KKT_FACTOR * tol * scale,
                 f"{KKT_FACTOR} x tol x (1 + |x|_inf): the stopping test "
                 f"bounds the splitting residuals at tol")


def loss_fn(cfg):
    def loss(Q, p, A, b, lb, ub, w):
        return jnp.sum(boxqp(Q, p, A, b, lb, ub, config=cfg) * w)
    return loss


def phase_main(n=N_FLAGSHIP, B=B_FLAGSHIP, n_ref=4, n_grad=2):
    ph = Phase("main")
    data = tuple(create_qp_data(n, B, seed=0, dtype=jnp.float32))
    cfg = BoxQPConfig(eps_abs=TOL, eps_rel=TOL)
    w = jax.random.normal(jax.random.PRNGKey(3), (B, n), jnp.float32)
    print(f"[main] flagship: B={B}, dz={n}, f32, eps_abs=eps_rel={TOL}, "
          f"backward=fixed_point", flush=True)

    fwd = compile_timed(ph, "solve_box_qp", functools.partial(
        solve_box_qp, config=cfg), *data)
    fb = compile_timed(ph, "boxqp fwd+bwd", jax.value_and_grad(
        loss_fn(cfg), argnums=(0, 1)), *data, w)
    mem = fb.memory_analysis()
    print(f"[main] fwd+bwd memory_analysis: {mem}", flush=True)

    sol = fwd(*data)
    n_conv = int(jnp.sum(sol.converged))
    ph.require(f"converged {n_conv}/{B}", n_conv == B)
    print(f"[main] iterations {int(sol.iterations)}", flush=True)
    kkt_check(ph, "solve_box_qp", data, sol.x, sol.lams, sol.nus, TOL)

    # x against the NumPy f64 reference solver at a tight tolerance.
    Q, p, A, b, lb, ub = (f64(a) for a in data)
    x32 = f64(sol.x)
    for i in range(n_ref):
        ref = solve_box_qp_np(Q[i], p[i], A[i], b[i], lb[i], ub[i],
                              eps_abs=1e-10, eps_rel=1e-10)
        lam_min = float(np.linalg.eigvalsh(Q[i])[0])
        tol_x = 10 * TOL * (1 + np.max(np.abs(ref["x"]))) / lam_min
        ph.check(f"x[{i}] vs NumPy f64 reference, max abs", float(
            np.max(np.abs(x32[i] - ref["x"]))), tol_x,
            f"10 x tol x (1+|x|) / lambda_min(Q)={lam_min:.3f}: residuals "
            f"at tol bound the solution error through Q's conditioning")

    (l32, (dQ, dp)) = fb(*data, w)
    ph.require("loss and gradients finite", bool(
        np.isfinite(float(l32)) and jnp.all(jnp.isfinite(dQ))
        and jnp.all(jnp.isfinite(dp))))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        args64 = [jax.device_put(f64(a[:n_grad]), cpu)
                  for a in data + (w,)]
        cfg64 = BoxQPConfig(eps_abs=1e-10, eps_rel=1e-10)
        g64 = jax.jit(jax.grad(loss_fn(cfg64), argnums=(0, 1)))(*args64)
        x64 = jax.jit(lambda *a: solve_box_qp(*a, config=cfg64).x)(
            *args64[:6])
        dQ64, dp64, x64 = f64(g64[0]), f64(g64[1]), f64(x64)
    # Compare on coordinates whose active status the f32 and f64 solutions
    # agree on: at an active-set boundary the gradient jumps.
    lbn, ubn = lb[:n_grad], ub[:n_grad]
    band = 1e-3

    def active(x):
        return (x - lbn <= band) | (ubn - x <= band)
    same = active(x32[:n_grad]) == active(x64)
    print(f"[main] gradient coordinates with differing active status "
          f"(band {band}): {int(np.sum(~same))} of {same.size}", flush=True)
    dp32 = f64(dp[:n_grad])
    err_p = np.max(np.abs(np.where(same, dp32 - dp64, 0.0))) / np.max(
        np.abs(dp64))
    both = same[:, :, None] & same[:, None, :]
    dQ32 = f64(dQ[:n_grad])
    err_q = np.max(np.abs(np.where(both, dQ32 - dQ64, 0.0))) / np.max(
        np.abs(dQ64))
    reason = ("active-set KKT solve: its inputs carry the forward's "
              "tol-1e-5 error (<=1e-4 relative), the f32 solve adds less")
    ph.check("dp vs f64 CPU (Cholesky path), max rel", float(err_p), 2e-3,
             reason)
    ph.check("dQ vs f64 CPU (Cholesky path), max rel", float(err_q), 2e-3,
             reason)

    t_fwd = median_s(fwd, *data)
    t_fb = median_s(fb, *data, w)
    print(f"[main] smoke timing (median of 5 steady calls, not a benchmark):"
          f" fwd {t_fwd * 1e3:.2f} ms, fwd+bwd {t_fb * 1e3:.2f} ms, "
          f"iterations {int(sol.iterations)}", flush=True)
    ph.close()
    return data, sol, dp


# --------------------------------------------------------------------------
# phase families


def phase_families(main_out, n=N_FLAGSHIP, B=B_FLAGSHIP):
    ph = Phase("families")
    data, sol_fp, dp_fp = main_out
    Q, p, A, b, lb, ub = data
    w = jax.random.normal(jax.random.PRNGKey(3), (B, n), jnp.float32)
    base = dict(eps_abs=TOL, eps_rel=TOL)

    # Backward modes: same forward, other gradient formulations.
    cfg = BoxQPConfig(backward="kkt", **base)
    g = compile_timed(ph, "boxqp backward=kkt", jax.grad(
        loss_fn(cfg), argnums=(0, 1)), *data, w)(*data, w)
    ph.require("kkt backward gradients finite",
               bool(all(jnp.all(jnp.isfinite(x)) for x in g)))
    rel = float(jnp.max(jnp.abs(g[1] - dp_fp)) / jnp.max(jnp.abs(dp_fp)))
    print(f"[families] kkt vs fixed_point dp, max rel {rel:.3e}",
          flush=True)

    cfg = BoxQPConfig(unroll=True, unroll_iters=60, adaptive_rho=False,
                      **base)
    f = compile_timed(ph, "boxqp unroll=True fwd+bwd", jax.value_and_grad(
        lambda *a: jnp.sum(boxqp(*a[:6], config=cfg) * a[6]),
        argnums=(0, 1)), *data, w)
    (_l, gu) = f(*data, w)
    x_u = jax.jit(lambda *a: boxqp(*a, config=cfg))(*data)
    ph.check("unroll=True x vs while-loop solve, max abs",
             float(jnp.max(jnp.abs(x_u - sol_fp.x))), 2e-2,
             "60 fixed iterations without adaptive rho; the deviation gate "
             "of experiments/experiment_1.py")
    ph.require("unroll gradients finite",
               bool(all(jnp.all(jnp.isfinite(x)) for x in gu)))

    # Serving path: prepare once, solve a perturbed p warm-started.
    cfg = BoxQPConfig(**base)
    prep = compile_timed(ph, "prepare_box_qp", functools.partial(
        prepare_box_qp, config=cfg), Q, A, b, lb, ub)(Q, A, b, lb, ub)
    p2 = p + 0.01 * jax.random.normal(jax.random.PRNGKey(5), p.shape,
                                      p.dtype)
    warm = compile_timed(ph, "solve_box_qp_prepared warm start",
                         lambda prep, p, ws: solve_box_qp_prepared(
                             prep, p, config=cfg, warm_start=ws),
                         prep, p2, sol_fp)
    sol = warm(prep, p2, sol_fp)
    n_conv = int(jnp.sum(sol.converged))
    ph.require(f"prepared+warm start converged {n_conv}/{B}, iterations "
               f"{int(sol.iterations)} (cold {int(sol_fp.iterations)})",
               n_conv == B)
    kkt_check(ph, "prepared+warm", (Q, p2, A, b, lb, ub), sol.x, sol.lams,
              sol.nus, TOL)

    cfg = BoxQPConfig(polish=True, **base)
    sol = compile_timed(ph, "solve_box_qp polish=True", functools.partial(
        solve_box_qp, config=cfg), *data)(*data)
    n_conv = int(jnp.sum(sol.converged))
    ph.require(f"polish converged {n_conv}/{B}", n_conv == B)
    kkt_check(ph, "polish", data, sol.x, sol.lams, sol.nus, TOL)

    G, h = create_qp_data(n, B, seed=0, dtype=jnp.float32).with_G_h()
    for label, fn, args, cfg in (
            ("solve_qp_gen", solve_qp_gen, (Q, p, A, b, G, h),
             GenQPConfig(**base)),
            ("solve_qp_optnet", solve_qp_optnet, (Q, p, A, b, G, h),
             OptNetConfig(tol=TOL, max_iters=30)),
            ("solve_box_qp_ip", solve_box_qp_ip, data,
             OptNetConfig(tol=TOL, max_iters=30))):
        sol = compile_timed(ph, label, functools.partial(fn, config=cfg),
                            *args)(*args)
        n_conv = int(jnp.sum(sol.converged))
        ph.require(f"{label} converged {n_conv}/{B}, iterations "
                   f"{int(jnp.max(sol.iterations))}", n_conv == B)
        kkt_check(ph, label, data, sol.x, sol.lams, sol.nus, TOL)
    ph.close()


# --------------------------------------------------------------------------
# phase four (behind --four)


def phase_four(n=N_FLAGSHIP, B=4 * B_FLAGSHIP, n_tp=4096, B_tp=4):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lqp_py_tpu.models.train import init_params, make_train_step
    from lqp_py_tpu.parallel.mesh import make_mesh
    from lqp_py_tpu.parallel.sharded import (solve_box_qp_sharded,
                                             solve_box_qp_shard_map)
    from lqp_py_tpu.parallel.tp import solve_box_qp_tp

    ph = Phase("four")
    devs = jax.devices()
    ph.require(f"{len(devs)} devices", len(devs) == 4)
    cfg = BoxQPConfig(eps_abs=TOL, eps_rel=TOL)
    single = jax.jit(functools.partial(solve_box_qp, config=cfg))
    reason = ("x is determined to the stopping tolerance; a partitioned "
              "program sums in another order")

    def spans_all(x, label):
        owners = {s.device for s in x.addressable_shards}
        ph.require(f"{label} shards on {len(owners)} distinct devices",
                   owners == set(devs))

    data = tuple(create_qp_data(n, B, seed=1, dtype=jnp.float32))
    ref = single(*data)
    print(f"[four] single-card reference: B={B}, dz={n}, iterations "
          f"{int(ref.iterations)}, converged "
          f"{int(jnp.sum(ref.converged))}/{B}", flush=True)
    mesh = make_mesh()
    for label, fn in (("solve_box_qp_sharded (GSPMD dp)",
                       solve_box_qp_sharded),
                      ("solve_box_qp_shard_map (dp)",
                       solve_box_qp_shard_map)):
        t0 = time.perf_counter()
        sol = jax.block_until_ready(fn(mesh, *data, config=cfg))
        print(f"[four] {label}: first call {time.perf_counter() - t0:.1f} s"
              f" (compile included)", flush=True)
        spans_all(sol.x, label)
        ph.require(f"{label} converged {int(jnp.sum(sol.converged))}/{B}",
                   bool(jnp.all(sol.converged)))
        ph.require(f"{label} iterations {int(jnp.max(sol.iterations))} == "
                   f"single-card {int(ref.iterations)}",
                   int(jnp.max(sol.iterations)) == int(ref.iterations))
        ph.check(f"{label} x vs single card, max abs", float(
            jnp.max(jnp.abs(f64(sol.x) - f64(ref.x)))), 1e-4, reason)

    data_tp = tuple(create_qp_data(n_tp, B_tp, seed=2, dtype=jnp.float32))
    ref_tp = single(*data_tp)
    mesh_tp = make_mesh((1, 4), ("dp", "tp"))
    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve_box_qp_tp(mesh_tp, *data_tp,
                                                config=cfg))
    print(f"[four] solve_box_qp_tp B={B_tp} n={n_tp}: first call "
          f"{time.perf_counter() - t0:.1f} s (compile included)", flush=True)
    ph.require(f"tp converged {int(jnp.sum(sol.converged))}/{B_tp}",
               bool(jnp.all(sol.converged)))
    ph.require(f"tp iterations {int(sol.iterations)} == single-card "
               f"{int(ref_tp.iterations)}",
               int(sol.iterations) == int(ref_tp.iterations))
    ph.check("tp x vs single card, max abs", float(
        jnp.max(jnp.abs(f64(sol.x) - f64(ref_tp.x)))), 1e-4, reason)

    # dp x tp train step: linear model -> QP layer -> QP objective -> SGD.
    n_feat = 16
    feats = jax.random.normal(jax.random.PRNGKey(4), (B, n_feat),
                              jnp.float32)
    params = init_params(jax.random.PRNGKey(5), n_feat, n, jnp.float32)
    step = jax.jit(make_train_step(cfg, lr=5e-4))
    batch = (feats,) + data
    ref_params, ref_loss = step(params, *batch)
    mesh2 = make_mesh((2, 2), ("dp", "tp"))

    def sh(*spec):
        return NamedSharding(mesh2, P(*spec))
    params_s = params._replace(W=jax.device_put(params.W, sh(None, "tp")),
                               bias=jax.device_put(params.bias, sh("tp")))
    batch_s = tuple(jax.device_put(x, sh("dp", *([None] * (x.ndim - 1))))
                    for x in batch)
    t0 = time.perf_counter()
    new_params, loss = jax.block_until_ready(step(params_s, *batch_s))
    print(f"[four] dp x tp train step: first call "
          f"{time.perf_counter() - t0:.1f} s (compile included)", flush=True)
    spans_all(new_params.W, "train step W")
    ph.check("train step loss vs single card, rel", abs(
        float(loss) - float(ref_loss)) / abs(float(ref_loss)), 1e-4, reason)
    ph.check("train step W vs single card, max abs", float(jnp.max(jnp.abs(
        f64(new_params.W) - f64(ref_params.W)))), 1e-5,
        "one SGD step of lr 5e-4 on gradients that agree to ~1e-2 absolute")
    ph.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded solves")
    args = ap.parse_args(argv)
    dev = require_gpu()
    enable_compile_cache()
    print(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}",
          flush=True)
    print(f"nvidia-smi name, power.limit: {card_info()}", flush=True)
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_families(phase_main())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
