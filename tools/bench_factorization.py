"""Compare the f32 SPD factorization paths on the GPU.

Every solver family pays an SPD factorization: once per solve, again at
each adaptive-rho refactorization, in the fixed-point backward, in polish
and in every interior-point iteration.  This script times the three ways
``ops/linalg.py`` can produce ``H^-1`` (``spd_inverse_fast``) and
``H^-1 R`` (``spd_solve_fast``) at B=128, f32, under the solvers'
"highest" matmul precision:

  chol         lax Cholesky + triangular solve (cuSOLVER / cuBLAS)
  schur_sweep  Schur recursion over GEMMs, Pallas/Triton sweep leaves
  schur_chol   Schur recursion over GEMMs, Cholesky leaves

It also times the 128x128 leaf alone (sweep kernel per ``num_warps`` vs a
batched Cholesky inverse), the batch-major Gauss-Jordan against Cholesky
at n <= 64, traces one call of each path at the largest size (top device
kernels), reads what the backward's "high" precision lowers to, and times
the flagship forward+backward (B=128, dz=1000, tol 1e-5) through each
path, and traces it on the default path (device busy share, top
kernels).  Needs a GPU:

    python tools/bench_factorization.py [--sizes 250 500 1000]
        [--sections leaf paths small_n trace precision e2e e2e_trace]

Prints one JSON object per measurement; all of them also go to
``chiprun_out/bench_factorization.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import json
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.lax import linalg as lax_linalg  # noqa: E402

from lqp_py_tpu.ops import linalg as lin  # noqa: E402
from lqp_py_tpu.ops.pallas import spd_inverse as sw  # noqa: E402
from lqp_py_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from lqp_py_tpu.utils.device import describe, require_gpu  # noqa: E402
from lqp_py_tpu.utils.generators import create_qp_data  # noqa: E402

PATHS = ("chol", "schur_sweep", "schur_chol")
SECTIONS = ("leaf", "paths", "small_n", "trace", "precision", "e2e",
            "e2e_trace")
RESULTS = []


def emit(**rec):
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def median_s(fn, *args, n=7):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _ee(precision):
    return functools.partial(jnp.einsum, precision=precision,
                             preferred_element_type=jnp.float32)


def inverse(path, H, precision="highest"):
    if path == "chol":
        return lin.spd_inverse(H)
    leaf = lin._sweep_leaf if path == "schur_sweep" else lin.spd_inverse
    n = H.shape[-1]
    return lin._schur_inverse(lin._pad_to_leaf(H), _ee(precision),
                              leaf)[:, :n, :n]


def solve(path, H, R, precision="highest"):
    if path == "chol":
        return lin.chol_solve(lax_linalg.cholesky(H), R)
    leaf = lin._sweep_leaf if path == "schur_sweep" else lin.spd_inverse
    n = H.shape[-1]
    Hp = lin._pad_to_leaf(H)
    Rp = jnp.pad(R, ((0, 0), (0, Hp.shape[-1] - n), (0, 0)))
    return lin._schur_solve_rec(Hp, Rp, _ee(precision), leaf)[:, :n, :]


def operand(n, B=128, seed=0):
    """The solver's factorization operand: Jacobi-scaled Q + rho I."""
    Q = create_qp_data(n, B, seed=seed, dtype=jnp.float32).Q
    _, Hs = lin._jacobi(Q)
    return Hs + 0.05 * jnp.eye(n, dtype=jnp.float32)


@jax.jit
def inv_residual(H, Hi):
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)
    R = jnp.einsum("bij,bjk->bik", H, Hi, precision="highest") - eye
    return jnp.max(jnp.abs(R))


@jax.jit
def solve_residual(H, X, R):
    HX = jnp.einsum("bij,bjk->bik", H, X, precision="highest")
    return jnp.max(jnp.abs(HX - R)) / jnp.max(jnp.abs(R))


def section(name):
    @contextlib.contextmanager
    def guard():
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:  # keep measuring the other sections
            emit(section=name, error=f"{type(e).__name__}: {e}"[:2000],
                 traceback=traceback.format_exc()[-3000:])
        finally:
            print(f"[{name}] {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
    return guard()


def leaf_alone(n_leaves):
    H = operand(128, B=n_leaves)
    ref = np.linalg.inv(np.asarray(H[:4], np.float64))
    for w in (4, 8, 16):
        with section(f"leaf num_warps={w}"):
            f = jax.jit(functools.partial(sw.sweep_spd_inverse,
                                          interpret=False, num_warps=w))
            t0 = time.perf_counter()
            Hi = jax.block_until_ready(f(H))
            compile_s = time.perf_counter() - t0
            emit(section="leaf", impl="sweep_triton", num_warps=w,
                 shape=list(H.shape), compile_s=compile_s,
                 median_s=median_s(f, H),
                 max_abs_err_vs_f64=float(np.max(np.abs(
                     np.asarray(Hi[:4], np.float64) - ref))),
                 residual_inf=float(inv_residual(H, Hi)))
    f = jax.jit(lin.spd_inverse)
    Hi = f(H)
    emit(section="leaf", impl="cholesky_inverse", shape=list(H.shape),
         median_s=median_s(f, H),
         max_abs_err_vs_f64=float(np.max(np.abs(
             np.asarray(Hi[:4], np.float64) - ref))),
         residual_inf=float(inv_residual(H, Hi)))


def paths_at(n):
    H = operand(n)
    R = jax.random.normal(jax.random.PRNGKey(1), (H.shape[0], n, 2),
                          jnp.float32)
    for path in PATHS:
        fi = jax.jit(functools.partial(inverse, path))
        fs = jax.jit(functools.partial(solve, path))
        emit(section="paths", n=n, path=path, op="spd_inverse_fast",
             median_s=median_s(fi, H),
             residual_inf=float(inv_residual(H, fi(H))))
        emit(section="paths", n=n, path=path, op="spd_solve_fast",
             median_s=median_s(fs, H, R),
             rel_residual_inf=float(solve_residual(H, fs(H, R), R)))


def small_n():
    for n in (10, 16, 32, 64, 100):
        H = operand(n)
        for impl, f in (("gauss_jordan", lin._gj_inverse_small),
                        ("cholesky_inverse", lin.spd_inverse),
                        ("schur_sweep", functools.partial(inverse,
                                                          "schur_sweep"))):
            f = jax.jit(f)
            emit(section="small_n", n=n, impl=impl,
                 median_s=median_s(f, H),
                 residual_inf=float(inv_residual(H, f(H))))


#: Derived lines of a GPU plane that span kernels rather than run them.
_SUMMARY_LINES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Steps",
                  "Framework Ops", "Framework Name Scope")


def _device_events(logdir, lines_seen=None):
    """(name, start_ns, duration_ns) of every kernel/copy on a GPU stream
    line of the newest trace under ``logdir``."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True))[-1]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if lines_seen is not None:
                lines_seen.add(line.name)
            if line.name in _SUMMARY_LINES:
                continue
            out.extend((ev.name, ev.start_ns, ev.duration_ns)
                       for ev in line.events)
    return out


def top_kernels(logdir, k=10):
    """Per-name device totals of the newest trace under ``logdir``."""
    totals = {}
    for name, _, dur in _device_events(logdir):
        c, t = totals.get(name, (0, 0.0))
        totals[name] = (c + 1, t + dur)
    top = sorted(totals.items(), key=lambda kv: -kv[1][1])[:k]
    return [{"kernel": name[:120], "count": c, "total_ms": t / 1e6}
            for name, (c, t) in top]


def busy_share(logdir):
    """Union of device-event intervals over the span from the first event
    to the last: the device's busy share of that window."""
    lines = set()
    ivs = sorted((s, s + d) for _, s, d in _device_events(logdir, lines))
    if not ivs:
        return float("nan"), 0.0, sorted(lines)
    busy, end = 0, None
    for s, e in ivs:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = ivs[-1][1] - ivs[0][0]
    return busy / window, window / 1e6, sorted(lines)


def trace_paths(n):
    H = operand(n)
    for path in PATHS:
        f = jax.jit(functools.partial(inverse, path))
        jax.block_until_ready(f(H))
        with tempfile.TemporaryDirectory() as d:
            with jax.profiler.trace(d):
                for _ in range(2):
                    jax.block_until_ready(f(H))
            emit(section="trace", n=n, path=path, calls=2,
                 top=top_kernels(d))


def high_precision_lowering():
    a = jnp.ones((128, 256, 256), jnp.float32)
    for prec in ("high", "highest", "default"):
        hlo = jax.jit(lambda x, y: jnp.einsum(
            "bij,bjk->bik", x, y, precision=prec)).lower(a, a).compile()
        lines = [ln.strip() for ln in hlo.as_text().splitlines()
                 if "custom-call" in ln or " dot(" in ln]
        emit(section="precision", precision=prec,
             config=[ln[ln.find("backend_config"):][:1500]
                     for ln in lines[:2]],
             median_s=median_s(jax.jit(lambda x, y: jnp.einsum(
                 "bij,bjk->bik", x, y, precision=prec)), a, a))


def e2e_trace(n=1000, B=128, tol=1e-5, calls=3):
    """Profiler trace of the flagship forward+backward on the default
    path: device busy share and the kernels that take the time."""
    from lqp_py_tpu import BoxQPConfig, boxqp
    cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol)
    Q, p, A, b, lb, ub = create_qp_data(n, B, seed=0, dtype=jnp.float32)

    def loss(Q, p):
        return jnp.sum(boxqp(Q, p, A, b, lb, ub, config=cfg))
    fb = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
    jax.block_until_ready(fb(Q, p))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(calls):
                jax.block_until_ready(fb(Q, p))
        share, window_ms, lines = busy_share(d)
        emit(section="e2e_trace", n=n, B=B, calls=calls,
             busy_share=share, window_ms=window_ms, gpu_lines=lines,
             top=top_kernels(d, k=15))


def _fast_pair(path):
    def inv_fast(H, precision="highest", equilibrate=True):
        d, Hs = lin._jacobi(H) if equilibrate else (None, H)
        Hi = inverse(path, Hs, precision)
        return Hi if d is None else Hi * d[..., :, None] * d[..., None, :]

    def solve_fast(H, R, equilibrate=True, precision="highest"):
        if equilibrate:
            d, Hs = lin._jacobi(H)
            R = R * d[..., :, None]
        else:
            d, Hs = None, H
        X = solve(path, Hs, R, precision)
        return X if d is None else X * d[..., :, None]
    return inv_fast, solve_fast


def e2e(n=1000, B=128, tol=1e-5, reps=5):
    from lqp_py_tpu import BoxQPConfig, boxqp, solve_box_qp
    cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol)
    data = create_qp_data(n, B, seed=0, dtype=jnp.float32)
    Q, p, A, b, lb, ub = data
    orig = lin.spd_inverse_fast, lin.spd_solve_fast
    order = list(PATHS) + list(reversed(PATHS))
    times = {p_: {"fwd": [], "fwd_bwd": []} for p_ in PATHS}
    for rnd, path in enumerate(order):
        lin.spd_inverse_fast, lin.spd_solve_fast = _fast_pair(path)
        try:
            fwd = jax.jit(lambda Q, p: solve_box_qp(Q, p, A, b, lb, ub,
                                                    cfg))

            def loss(Q, p):
                return jnp.sum(boxqp(Q, p, A, b, lb, ub, config=cfg))
            fb = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
            t0 = time.perf_counter()
            sol = jax.block_until_ready(fwd(Q, p))
            jax.block_until_ready(fb(Q, p))
            compile_s = time.perf_counter() - t0
            times[path]["fwd"].append(median_s(fwd, Q, p, n=reps))
            times[path]["fwd_bwd"].append(median_s(fb, Q, p, n=reps))
            emit(section="e2e", round=rnd, path=path, n=n, B=B, tol=tol,
                 compile_s=compile_s, iterations=int(sol.iterations),
                 converged=int(jnp.sum(sol.converged)),
                 fwd_s=times[path]["fwd"][-1],
                 fwd_bwd_s=times[path]["fwd_bwd"][-1])
        finally:
            lin.spd_inverse_fast, lin.spd_solve_fast = orig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[250, 500, 1000])
    ap.add_argument("--sections", nargs="*", default=list(SECTIONS),
                    choices=SECTIONS)
    args = ap.parse_args()
    dev = require_gpu()
    enable_compile_cache()
    print(describe(dev), flush=True)
    with jax.default_matmul_precision("highest"):
        if "leaf" in args.sections:
            with section("leaf"):
                leaf_alone(128 * 1024 // 128)
        if "paths" in args.sections:
            for n in args.sizes:
                with section(f"paths n={n}"):
                    paths_at(n)
        if "small_n" in args.sections:
            with section("small_n"):
                small_n()
        if "trace" in args.sections:
            with section("trace"):
                trace_paths(max(args.sizes))
    if "precision" in args.sections:
        with section("precision"):
            high_precision_lowering()
    if "e2e" in args.sections:
        with section("e2e"):
            e2e()
    if "e2e_trace" in args.sections:
        with section("e2e_trace"):
            e2e_trace()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_factorization.json").write_text(json.dumps(
        {"device": describe(dev), "results": RESULTS}, indent=1))


if __name__ == "__main__":
    main()
