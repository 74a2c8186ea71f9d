"""Profiling / observability hooks.

The reference's only instrumentation is ``time.time()`` spans in demo
scripts (SURVEY.md §5).  Here:

- ``trace(logdir)``: context manager around ``jax.profiler`` producing a
  TensorBoard-compatible device trace of everything inside.
- ``timed(fn)``: steady-state wall-clock timing of a jitted callable
  (compiles first, waits for the device with ``block_until_ready``).
- ``solve_stats(sol)``: summarize a solution pytree (iterations, residuals,
  per-element convergence) as a plain dict for logging.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(logdir: str):
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


force = jax.block_until_ready


def timed(fn: Callable, *args, n: int = 5, warmup: int = 1) -> Dict:
    """Median/min steady-state wall-clock of ``fn(*args)`` in seconds."""
    for _ in range(max(warmup, 1)):
        force(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        force(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "min_s": min(ts),
            "max_s": max(ts), "n": n}


def solve_stats(sol) -> Dict:
    out = {
        "iterations": int(jnp.max(jnp.asarray(sol.iterations))),
        "converged_frac": float(jnp.mean(sol.converged.astype(jnp.float32))),
        "max_primal_residual": float(jnp.max(sol.primal_residual)),
        "max_dual_residual": float(jnp.max(sol.dual_residual)),
    }
    if hasattr(sol, "rho") and sol.rho is not None:
        out["rho_min"] = float(jnp.min(sol.rho))
        out["rho_max"] = float(jnp.max(sol.rho))
    return out
