"""Matmul-precision scoping for solver entry points.

On a GPU an f32 ``jnp.einsum``/``dot`` at default precision may run in
TF32 on the tensor cores (about three decimal digits) — too coarse for a
solver targeting 1e-5 KKT residuals: the unchecked equality residual
silently grows.  Every solver entry point is wrapped in
``jax.default_matmul_precision("highest")``, which keeps f32 products in
FP32 on the CUDA cores; the per-iteration GEMV is HBM-bound, so this
costs little while restoring full f32 accuracy.
"""

from __future__ import annotations

import functools

import jax

PRECISION = "highest"


def solver_precision(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(PRECISION):
            return fn(*args, **kwargs)
    return wrapped
