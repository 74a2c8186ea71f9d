"""Solution pytrees returned by the solvers.

The reference returns plain dicts ``{x, z, u, lams, nus, rho, iter}``
(solve_box_qp_admm_torch.py:331).  Here the solution is a typed pytree that
additionally carries per-element convergence status and final residuals —
the reference silently returns the current iterate on non-convergence
(SURVEY.md §5), which we consider a gap.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from lqp_py_tpu.utils import pytree


@pytree.dataclass
class BoxQPSolution:
    """Batched box-QP solution.

    Vector fields are ``(n_batch, n)`` (squeezed layout; the layer API
    restores the caller's ``(n_batch, n, 1)`` layout).
    """

    x: jax.Array                    # primal solution
    z: jax.Array                    # auxiliary (projected) primal
    u: jax.Array                    # scaled dual of the box constraint
    lams: jax.Array                 # (n_batch, 2n): [lambda_lb; lambda_ub]
    nus: Optional[jax.Array]        # (n_batch, n_eq) equality duals, or None
    rho: jax.Array                  # (n_batch,) final ADMM penalty
    iterations: jax.Array           # () int32: iterations executed
    primal_residual: jax.Array      # (n_batch,) final unscaled primal residual
    dual_residual: jax.Array        # (n_batch,) final unscaled dual residual
    converged: jax.Array            # (n_batch,) bool
    #: (n_batch,) bool — an OSQP-style primal-infeasibility certificate was
    #: found (successive dual differences converge to a separating
    #: functional; Banjac et al. 2019).  The reference has no infeasibility
    #: reporting at all; SCS's eps_infeas is the closest analogue.
    primal_infeasible: Optional[jax.Array] = None
    #: (K, 3) ring buffer of ``[iteration, max primal, max dual]`` rows —
    #: the last K residual checks (config.residual_trace = K > 0), rows not
    #: yet written hold iteration -1.  Mid-solve observability kept on the
    #: device, without host callbacks (the reference's verbose prints,
    #: solve_box_qp_admm_torch.py:289-294, need the host).  None when off.
    residual_trace: Optional[jax.Array] = None


@pytree.dataclass
class QPSolution:
    """Batched general-QP solution (equality + linear inequality)."""

    x: jax.Array
    lams: jax.Array                 # (n_batch, n_ineq) inequality duals >= 0
    slacks: jax.Array               # (n_batch, n_ineq) slacks h - Gx >= 0
    nus: Optional[jax.Array]        # (n_batch, n_eq) equality duals
    iterations: jax.Array
    primal_residual: jax.Array
    dual_residual: jax.Array
    converged: jax.Array
    #: (n_batch,) bool Farkas certificate found (genqp), or None (IP).
    primal_infeasible: Optional[jax.Array] = None


@pytree.dataclass
class EqQPSolution:
    """Solution of an equality-constrained (or unconstrained) QP."""

    x: jax.Array
    nus: Optional[jax.Array]


def tree_stop_gradient(sol):
    return jax.tree_util.tree_map(jax.lax.stop_gradient, sol)


def as_vector(v, name="input"):
    """Canonicalize ``(B, n, 1)`` or ``(B, n)`` to ``(B, n)``."""
    if v is None:
        return None
    v = jnp.asarray(v)
    if v.ndim == 3:
        if v.shape[-1] != 1:
            raise ValueError(f"{name}: expected trailing dim 1, got {v.shape}")
        return v[..., 0]
    if v.ndim == 2:
        return v
    raise ValueError(f"{name}: expected rank 2 or 3, got shape {v.shape}")


def like_layout(v, template):
    """Return ``v (B, n)`` in the same layout as ``template``."""
    if template is not None and jnp.ndim(template) == 3:
        return v[..., None]
    return v
