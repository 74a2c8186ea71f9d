"""End-to-end learning through the QP layer (Experiment-2 workload).

The reference's Experiment 2 (experiments/experiment_2.py:43-99) learns the
linear-cost vector of a QP: a ``Linear(n_features, n_x)`` model predicts
``p_hat``, the differentiable QP layer solves the box QP, and the loss is
the true QP objective ``0.5 z'Qz + p'z`` evaluated at the layer output.

Here the same workload is a pure-functional JAX train step: params pytree,
``jax.grad`` through the implicit QP layer, SGD update.  The step is a
single jittable function, shardable over a ('dp', 'tp') mesh: batch over
'dp', the linear layer's output features (n_x) over 'tp'.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lqp_py_tpu.config import BoxQPConfig
from lqp_py_tpu.models.layers import boxqp


class LinearQPParams(NamedTuple):
    W: jax.Array   # (n_features, n_x)
    bias: jax.Array  # (n_x,)


def init_params(key, n_features: int, n_x: int, dtype=jnp.float32):
    kw, = jax.random.split(key, 1)
    W = jax.random.normal(kw, (n_features, n_x), dtype) / jnp.sqrt(
        jnp.asarray(n_features, dtype))
    return LinearQPParams(W=W, bias=jnp.zeros((n_x,), dtype))


def predict_p(params: LinearQPParams, features):
    """features (B, n_features) -> p_hat (B, n_x)."""
    return jnp.einsum("bf,fn->bn", features, params.W,
                      preferred_element_type=features.dtype) + params.bias


def qp_objective(Q, p, z):
    """True QP objective 0.5 z'Qz + p'z (experiment_2.py:83)."""
    Qz = jnp.einsum("bij,bj->bi", Q, z, preferred_element_type=z.dtype)
    return jnp.mean(0.5 * jnp.sum(z * Qz, axis=-1) + jnp.sum(p * z, axis=-1))


def make_train_step(config: BoxQPConfig, lr: float = 5e-4):
    """Returns step(params, batch) -> (params, loss); jit/pjit-ready.

    batch = (features, Q, p_true, A, b, lb, ub).
    """

    def loss_fn(params, features, Q, p_true, A, b, lb, ub):
        p_hat = predict_p(params, features)
        z = boxqp(Q, p_hat, A, b, lb, ub, config=config)
        return qp_objective(Q, p_true, z)

    def step(params, features, Q, p_true, A, b, lb, ub):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, features, Q, p_true, A, b, lb, ub)
        params = jax.tree_util.tree_map(
            lambda w, g: w - lr * g, params, grads)
        return params, loss

    return step


def make_train_scan(config: BoxQPConfig, lr: float = 5e-4):
    """Whole-run training as ONE jitted dispatch: ``lax.scan`` over the
    epochs' minibatch index matrix, gathering each minibatch on device.

    The per-step loop (``make_train_step`` driven from Python, the
    reference's shape — experiments/experiment_2.py:43-99) pays one host
    round-trip per epoch, with the device idle meanwhile.  Fusing the
    horizon into a scan runs the same workload with identical math and
    update order in one dispatch.

    Returns ``run(params, sel, features, Q, p_true, A, b, lb, ub) ->
    (params, losses)`` where ``sel`` is an ``(epochs, mini_batch)`` int32
    index matrix (precomputed on host so the sampling RNG matches the
    per-step path exactly) and ``losses`` is the per-epoch loss
    trajectory.
    """
    step = make_train_step(config, lr=lr)

    def run(params, sel, features, Q, p_true, A, b, lb, ub):
        data = (features, Q, p_true, A, b, lb, ub)

        def body(params, idx):
            mb = tuple(None if v is None else jnp.take(v, idx, axis=0)
                       for v in data)
            return step(params, *mb)

        return jax.lax.scan(body, params, sel)

    return run
