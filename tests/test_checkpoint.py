"""Checkpoint/resume of the training workload (utils/checkpoint.py).

The invariant that matters: interrupt-at-K + restore + finish must
reproduce the uninterrupted run's loss trajectory and final params
exactly (same dispatch shapes, same update order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# orbax is an optional extra (checkpoint/resume only).
pytest.importorskip("orbax.checkpoint")

from lqp_py_tpu import BoxQPConfig  # noqa: E402
from lqp_py_tpu.models.train import (init_params, make_train_scan)  # noqa: E402
from lqp_py_tpu.utils.checkpoint import (TrainState, checkpointed_run,  # noqa: E402
                                         init_train_state,
                                         latest_checkpoint,
                                         restore_train_state,
                                         save_train_state)
from lqp_py_tpu.utils.generators import create_qp_data  # noqa: E402

N_X, N_FEAT, B, MB, EPOCHS = 8, 4, 16, 8, 6


@pytest.fixture(scope="module")
def workload():
    Q, p, A, b, lb, ub = [jnp.asarray(v) for v in
                          create_qp_data(N_X, B, seed=11,
                                         dtype=jnp.float64)[:6]]
    rng = np.random.default_rng(5)
    features = jnp.asarray(rng.normal(size=(B, N_FEAT)))
    sel = jnp.asarray(rng.integers(0, B, size=(EPOCHS, MB)), jnp.int32)
    params = init_params(jax.random.PRNGKey(0), N_FEAT, N_X,
                         dtype=jnp.float64)
    run = jax.jit(make_train_scan(
        BoxQPConfig(eps_abs=1e-7, eps_rel=1e-7, unroll=True,
                    unroll_iters=60)))
    data = (features, Q, p, A, b, lb, ub)
    return run, params, sel, data


def test_save_restore_roundtrip(tmp_path, workload):
    run, params, sel, data = workload
    state = init_train_state(params, EPOCHS, dtype=jnp.float64)
    state = checkpointed_run(run, state, sel, *data)
    save_train_state(tmp_path / "ck", state)
    restored = restore_train_state(
        tmp_path / "ck", init_train_state(params, EPOCHS,
                                          dtype=jnp.float64))
    assert int(restored.epoch) == EPOCHS
    for a, b_ in zip(jax.tree_util.tree_leaves(state),
                     jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_resume_matches_uninterrupted(tmp_path, workload):
    run, params, sel, data = workload
    f64 = jnp.float64

    # Uninterrupted run.
    full = checkpointed_run(run, init_train_state(params, EPOCHS, f64),
                            sel, *data)
    assert bool(jnp.isfinite(full.losses).all())

    # Checkpoint every 2 epochs, "crash" after epoch 4, restore, finish.
    root = tmp_path / "ckpts"
    _ = checkpointed_run(run, init_train_state(params, EPOCHS, f64),
                         sel[:4], *data, root=root, every=2)
    latest = latest_checkpoint(root)
    assert latest is not None and latest.name == "step_4"
    # The restore template is a FRESH state — nothing carried in memory.
    resumed = restore_train_state(
        latest, init_train_state(init_params(jax.random.PRNGKey(1),
                                             N_FEAT, N_X, f64),
                                 EPOCHS, f64))
    # Resumed state thinks 4 epochs are done, but its losses buffer is
    # sized for the FIRST 4 epochs' sel: rebuild a full-horizon state.
    resumed = TrainState(params=resumed.params,
                         epoch=resumed.epoch,
                         losses=full.losses.at[:].set(jnp.nan)
                                            .at[:4].set(resumed.losses[:4]))
    finished = checkpointed_run(run, resumed, sel, *data)

    np.testing.assert_array_equal(np.asarray(full.losses),
                                  np.asarray(finished.losses))
    for a, b_ in zip(jax.tree_util.tree_leaves(full.params),
                     jax.tree_util.tree_leaves(finished.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_restore_sharded_template(tmp_path, workload, mesh8):
    """A state saved unsharded restores directly onto a dp-sharded
    template (orbax reshards on load) — the multi-chip resume path."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    run, params, sel, data = workload
    state = checkpointed_run(
        run, init_train_state(params, EPOCHS, jnp.float64), sel, *data)
    save_train_state(tmp_path / "ck", state)

    template = init_train_state(params, EPOCHS, jnp.float64)
    sharded_W = jax.device_put(
        template.params.W, NamedSharding(mesh8, P(None, "tp")))
    template = template._replace(
        params=template.params._replace(W=sharded_W))
    restored = restore_train_state(tmp_path / "ck", template)
    assert restored.params.W.sharding.spec == P(None, "tp")
    np.testing.assert_array_equal(np.asarray(restored.params.W),
                                  np.asarray(state.params.W))


def test_resume_with_partial_sel_rejected(workload):
    """Epoch indices are global: resuming with only the remaining sel rows
    would silently train the wrong epochs (round-3 review).  A resumed
    state must be called with the full-run sel."""
    run, params, sel, data = workload
    state = init_train_state(params, EPOCHS, jnp.float64)
    state = state._replace(epoch=jnp.asarray(4, jnp.int32))
    with pytest.raises(ValueError, match="FULL run's sel"):
        checkpointed_run(run, state, sel[4:], *data)


def test_rerun_over_existing_root_overwrites(tmp_path, workload):
    """A run retried from scratch with the same checkpoint root must
    overwrite the stale step_* directories instead of crashing after a
    full chunk of training (orbax 'checkpoint already exists')."""
    run, params, sel, data = workload
    root = tmp_path / "root"
    s1 = checkpointed_run(run, init_train_state(params, EPOCHS, jnp.float64),
                          sel, *data, root=root, every=3)
    s2 = checkpointed_run(run, init_train_state(params, EPOCHS, jnp.float64),
                          sel, *data, root=root, every=3)
    np.testing.assert_array_equal(np.asarray(s1.losses),
                                  np.asarray(s2.losses))
    # The low-level writer still refuses to clobber unless told to.
    with pytest.raises(Exception):
        save_train_state(root / f"step_{EPOCHS}", s2)
    save_train_state(root / f"step_{EPOCHS}", s2, overwrite=True)
