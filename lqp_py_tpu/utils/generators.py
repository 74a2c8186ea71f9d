"""Deterministic QP problem generators for tests and benchmarks.

Replicates the reference experiment data distributions
(experiments/utils.py:41-131) with JAX PRNG:

- ``create_qp_data``: random SPD Q = L'L/n_samples, a sum-to-one equality
  row, uniform box bounds in +/-[1, 2].
- ``generate_hard_qp``: sparse-masked Q + 1e-2 I ridge, sqrt(n_x) random
  sparse equality rows anchored to a feasible point (rank-deficient-ish,
  heterogeneous conditioning).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class QPData(NamedTuple):
    Q: jax.Array
    p: jax.Array
    A: Optional[jax.Array]
    b: Optional[jax.Array]
    lb: jax.Array
    ub: jax.Array

    def with_G_h(self):
        """Materialize the box as G = [-I; I], h = [-lb; ub] for the
        general-inequality solvers (experiments/utils.py:55-58)."""
        n = self.Q.shape[-1]
        B = self.Q.shape[0]
        eye = jnp.eye(n, dtype=self.Q.dtype)
        G = jnp.broadcast_to(jnp.concatenate([-eye, eye], 0), (B, 2 * n, n))
        h = jnp.concatenate([-self.lb, self.ub], axis=-1)
        return G, h


def _uniform(key, shape, lower, upper, dtype):
    return jax.random.uniform(key, shape, dtype=dtype,
                              minval=lower, maxval=upper)


def create_qp_data(n_x: int, n_batch: int, n_samples: Optional[int] = None,
                   seed: int = 0, dtype=jnp.float32) -> QPData:
    """Well-conditioned random box QPs (experiments/utils.py:41-61)."""
    if n_samples is None:
        n_samples = 2 * n_x
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    L = jax.random.normal(k[0], (n_batch, n_samples, n_x), dtype)
    Q = jnp.einsum("bsi,bsj->bij", L, L,
                   preferred_element_type=dtype) / n_samples
    p = jax.random.normal(k[1], (n_batch, n_x), dtype)
    A = jnp.ones((n_batch, 1, n_x), dtype)
    b = jnp.ones((n_batch, 1), dtype)
    lb = -_uniform(k[2], (n_batch, n_x), 1.0, 2.0, dtype)
    ub = _uniform(k[3], (n_batch, n_x), 1.0, 2.0, dtype)
    return QPData(Q=Q, p=p, A=A, b=b, lb=lb, ub=ub)


def generate_hard_qp(n_x: int, n_batch: int, prob: float = 0.15,
                     seed: int = 0, dtype=jnp.float64) -> QPData:
    """Hard QP set: sparse Q with ridge, sparse equality rows, bounds
    anchored to a feasible point (experiments/utils.py:64-131)."""
    m = max(round(n_x ** 0.5), 1)
    k = jax.random.split(jax.random.PRNGKey(seed), 8)

    M = jax.random.normal(k[0], (n_batch, n_x, n_x), dtype)
    mask = jax.random.bernoulli(k[1], prob, (n_batch, n_x, n_x))
    M = M * mask
    Q = jnp.einsum("bki,bkj->bij", M, M, preferred_element_type=dtype) \
        + 1e-2 * jnp.eye(n_x, dtype=dtype)

    p = jax.random.normal(k[2], (n_batch, n_x), dtype)
    x0 = jax.random.normal(k[3], (n_batch, n_x), dtype)

    Arow = jax.random.normal(k[4], (n_batch, m, n_x), dtype)
    amask = jax.random.bernoulli(k[5], prob, (n_batch, m, n_x))
    # Guard against all-zero rows (the reference resamples;
    # experiments/utils.py:126-130 — here the first entry is forced on).
    any_on = jnp.any(amask, axis=-1, keepdims=True)
    first = jnp.zeros((n_batch, m, n_x), bool).at[..., 0].set(True)
    amask = jnp.where(any_on, amask, first)
    A = Arow * amask
    b = jnp.einsum("bmj,bj->bm", A, x0, preferred_element_type=dtype)

    lb = x0 - _uniform(k[6], (n_batch, n_x), 0.0, 1.0, dtype)
    ub = x0 + _uniform(k[7], (n_batch, n_x), 0.0, 1.0, dtype)
    return QPData(Q=Q, p=p, A=A, b=b, lb=lb, ub=ub)


def kkt_residuals(Q, p, A, b, lb, ub, x, lams, nus):
    """Solver-independent optimality oracle: stationarity, feasibility and
    complementarity residuals of a box-QP solution (infinity norms).

    lams is (B, 2n) = [lambda_lb; lambda_ub] (both >= 0).  Matmuls run at
    "highest" precision — the default f32 precision on a GPU may run in
    TF32, which would corrupt the oracle itself.
    """
    import jax as _jax
    with _jax.default_matmul_precision("highest"):
        return _kkt_residuals_impl(Q, p, A, b, lb, ub, x, lams, nus)


def _kkt_residuals_impl(Q, p, A, b, lb, ub, x, lams, nus):
    n = x.shape[-1]
    lam_lb = lams[..., :n]
    lam_ub = lams[..., n:]
    stat = jnp.einsum("bij,bj->bi", Q, x) + p - lam_lb + lam_ub
    if A is not None:
        stat = stat + jnp.einsum("bmi,bm->bi", A, nus)
        eq = jnp.max(jnp.abs(jnp.einsum("bmi,bi->bm", A, x) - b), axis=-1)
    else:
        eq = jnp.zeros(x.shape[0], x.dtype)
    finite_lb = jnp.isfinite(lb)
    finite_ub = jnp.isfinite(ub)
    viol_lb = jnp.where(finite_lb, jnp.maximum(lb - x, 0.0), 0.0)
    viol_ub = jnp.where(finite_ub, jnp.maximum(x - ub, 0.0), 0.0)
    comp_lb = jnp.where(finite_lb, jnp.abs(lam_lb * (x - lb)), 0.0)
    comp_ub = jnp.where(finite_ub, jnp.abs(lam_ub * (ub - x)), 0.0)
    return {
        "stationarity": jnp.max(jnp.abs(stat), axis=-1),
        "eq": eq,
        "bound_violation": jnp.max(jnp.maximum(viol_lb, viol_ub), axis=-1),
        "complementarity": jnp.max(jnp.maximum(comp_lb, comp_ub), axis=-1),
    }
