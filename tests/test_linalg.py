"""Unit tests for the L1 numerics: the sweep-kernel SPD inverse, the Schur
recursion, the path choice of the fast SPD inverse/solve, and KKT
factorization consistency across modes.

These run on CPU (conftest pins JAX_PLATFORMS=cpu); the Pallas sweep
kernel runs in interpreter mode there, the same kernel the GPU compiles
through Triton.  Tests marked ``gpu`` run it compiled on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lqp_py_tpu.ops import linalg as lin
from lqp_py_tpu.ops.pallas.spd_inverse import (interpret_on,
                                               spd_inverse_leaf,
                                               sweep_spd_inverse)


def _spd(key, b, n, dtype=jnp.float64, scale=0.1):
    a = jax.random.normal(key, (b, n, n), dtype) * scale
    return jnp.einsum("bki,bkj->bij", a, a) + jnp.eye(n, dtype=dtype)


def _ee():
    return functools.partial(jnp.einsum, precision="highest")


def _interpreted_leaf(X):
    return sweep_spd_inverse(X, interpret=True)


def test_sweep_leaf_matches_numpy_inverse():
    H = _spd(jax.random.PRNGKey(0), 4, 128, jnp.float32)
    Hinv = sweep_spd_inverse(H, interpret=True)
    ref = np.linalg.inv(np.asarray(H, np.float64))
    np.testing.assert_allclose(np.asarray(Hinv), ref, rtol=2e-4, atol=2e-5)


def test_sweep_leaf_odd_batch_tile():
    # One program per leaf: an odd batch needs no tiling or padding.
    H = _spd(jax.random.PRNGKey(1), 7, 128, jnp.float32)
    Hinv = sweep_spd_inverse(H, interpret=True)
    ref = np.linalg.inv(np.asarray(H, np.float64))
    np.testing.assert_allclose(np.asarray(Hinv), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("B,m", [(1, 128), (3, 128), (5, 16), (9, 32)])
def test_sweep_leaf_interpret_batches(B, m):
    """Batch sizes that are no multiple of any tile, and smaller
    power-of-two blocks, against NumPy f64."""
    H = _spd(jax.random.PRNGKey(B), B, m, jnp.float32)
    Hinv = sweep_spd_inverse(H, interpret=True)
    assert Hinv.shape == H.shape and Hinv.dtype == H.dtype
    ref = np.linalg.inv(np.asarray(H, np.float64))
    np.testing.assert_allclose(np.asarray(Hinv), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 96, 96), (2, 128, 64), (2, 7, 7)])
def test_sweep_leaf_rejects_bad_blocks(shape):
    with pytest.raises(ValueError, match="power-of-two"):
        sweep_spd_inverse(jnp.zeros(shape, jnp.float32), interpret=True)


@pytest.mark.parametrize("platform,interpret", [("cpu", True),
                                                ("cuda", False)])
def test_leaf_platform_rule(platform, interpret):
    assert interpret_on(platform) is interpret


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_leaf_platform_rule_raises_elsewhere(platform):
    with pytest.raises(ValueError, match="no route"):
        interpret_on(platform)


def test_leaf_lowers_to_triton_for_cuda():
    """The platform-dependent leaf lowers, for CUDA, to one Triton custom
    call over a grid of one program per leaf (lowered here, without a
    card), and refuses a platform it has no route to."""
    H = jax.ShapeDtypeStruct((24, 128, 128), jnp.float32)
    traced = jax.jit(spd_inverse_leaf).trace(H)
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "sweep_spd_inverse"' in text
    assert "grid_x = 24" in text
    with pytest.raises(NotImplementedError):
        traced.lower(lowering_platforms=("rocm",))


def test_leaf_inside_jit_runs_interpreted_on_cpu():
    H = _spd(jax.random.PRNGKey(7), 2, 128, jnp.float32)
    Hinv = jax.jit(spd_inverse_leaf)(H)
    ref = np.linalg.inv(np.asarray(H, np.float64))
    np.testing.assert_allclose(np.asarray(Hinv), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype,n,leaf", [
    (jnp.float64, 200, None),
    (jnp.float64, 16, None),
    (jnp.float32, 200, "sweep"),
    (jnp.float32, 1000, "sweep"),
])
def test_fast_path_choice_by_dtype(dtype, n, leaf):
    """The fast inverse/solve pick their path from the operand's dtype
    (Cholesky for every dtype but f32) — no backend string involved."""
    H = jax.ShapeDtypeStruct((2, n, n), dtype)
    got = lin._leaf_for(H)
    assert got is ({None: None, "sweep": lin._sweep_leaf}[leaf])
    with lin.lax_linalg_only():
        assert lin._leaf_for(H) is lin.spd_inverse


@pytest.mark.parametrize("n", [lin._GJ_MAX, lin._GJ_MAX + 1])
def test_fast_small_n_regime(n):
    """At n <= _GJ_MAX the f32 inverse is the batch-major Gauss-Jordan;
    above it the padded Schur/sweep path — both agree with NumPy f64."""
    H = _spd(jax.random.PRNGKey(n), 3, n, jnp.float32)
    Hi = lin.spd_inverse_fast(H)
    if n <= lin._GJ_MAX:
        np.testing.assert_allclose(
            np.asarray(Hi), np.asarray(lin._gj_inverse_small(
                lin._jacobi(H)[1]) * _outer_d(H)), rtol=1e-6, atol=1e-7)
    ref = np.linalg.inv(np.asarray(H, np.float64))
    np.testing.assert_allclose(np.asarray(Hi), ref, rtol=5e-4, atol=5e-5)


def _outer_d(H):
    d, _ = lin._jacobi(H)
    return d[..., :, None] * d[..., None, :]


def test_fast_inverse_and_solve_f32_sweep_path():
    """spd_inverse_fast / spd_solve_fast on f32 go through the Schur
    recursion with interpreted sweep leaves (n padded 200 -> 256)."""
    n = 200
    H = _spd(jax.random.PRNGKey(11), 2, n, jnp.float32)
    R = jax.random.normal(jax.random.PRNGKey(12), (2, n, 3), jnp.float32)
    H64 = np.asarray(H, np.float64)
    np.testing.assert_allclose(np.asarray(lin.spd_inverse_fast(H)),
                               np.linalg.inv(H64), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(lin.spd_solve_fast(H, R)),
                               np.linalg.solve(H64, np.asarray(R, np.float64)),
                               rtol=5e-4, atol=5e-5)


def test_schur_inverse_padding_exact():
    # n not a multiple of 128: identity-block padding must be exact.
    n = 200
    H = _spd(jax.random.PRNGKey(2), 2, n, jnp.float32)
    Hp = lin._pad_to_leaf(H)
    assert Hp.shape[-1] == 256
    P = lin._schur_inverse(Hp, _ee(), _interpreted_leaf)[:, :n, :n]
    ref = np.linalg.inv(np.asarray(H, np.float64))
    np.testing.assert_allclose(np.asarray(P), ref, rtol=5e-4, atol=5e-5)


def test_factorize_modes_agree():
    key = jax.random.PRNGKey(3)
    B, n, m = 3, 40, 5
    Q = _spd(key, B, n)
    A = jax.random.normal(jax.random.PRNGKey(4), (B, m, n), jnp.float64)
    rho = jnp.linspace(0.5, 2.0, B, dtype=jnp.float64)
    r = jax.random.normal(jax.random.PRNGKey(5), (B, n), jnp.float64)
    b = jax.random.normal(jax.random.PRNGKey(6), (B, m), jnp.float64)

    f_inv = lin.factorize_kkt(Q, rho, A, mode="inverse")
    f_cho = lin.factorize_kkt(Q, rho, A, mode="cholesky")
    x1, nu1 = lin.kkt_apply(f_inv, r, b)
    x2, nu2 = lin.kkt_apply(f_cho, r, b)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(nu1), np.asarray(nu2),
                               rtol=1e-9, atol=1e-11)
    # And both actually solve M [x; nu] = [r; b]:
    H = Q + rho[:, None, None] * jnp.eye(n, dtype=jnp.float64)
    top = jnp.einsum("bij,bj->bi", H, x1) + jnp.einsum("bmi,bm->bi", A, nu1)
    bot = jnp.einsum("bmi,bi->bm", A, x1)
    np.testing.assert_allclose(np.asarray(top), np.asarray(r),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(bot), np.asarray(b),
                               rtol=1e-8, atol=1e-10)


def test_gj_inverse_small_matches_cholesky():
    """The batch-major Gauss-Jordan small-n inverse matches the lax
    Cholesky inverse to near machine precision."""
    for n, B, seed in ((4, 3, 0), (10, 128, 1), (64, 5, 2)):
        L = jax.random.normal(jax.random.PRNGKey(seed), (B, 2 * n, n),
                              jnp.float64)
        H = jnp.einsum("bsi,bsj->bij", L, L) / (2 * n) \
            + 0.5 * jnp.eye(n, dtype=jnp.float64)
        Hi = lin._gj_inverse_small(H)
        np.testing.assert_allclose(np.asarray(Hi),
                                   np.asarray(lin.spd_inverse(H)),
                                   rtol=1e-9, atol=1e-9)
        R = jnp.einsum("bij,bjk->bik", H, Hi) - jnp.eye(n, dtype=jnp.float64)
        assert float(jnp.max(jnp.abs(R))) < 1e-10

    # f32 sanity at n=32.
    L = jax.random.normal(jax.random.PRNGKey(3), (7, 64, 32), jnp.float32)
    H = jnp.einsum("bsi,bsj->bij", L, L) / 64 \
        + 0.5 * jnp.eye(32, dtype=jnp.float32)
    Hi = lin._gj_inverse_small(H)
    R = jnp.einsum("bij,bjk->bik", H, Hi,
                   precision="highest") - jnp.eye(32, dtype=jnp.float32)
    assert float(jnp.max(jnp.abs(R))) < 1e-4


@pytest.mark.gpu
def test_sweep_leaf_compiled_on_gpu(gpu):
    """The Triton leaf compiled for the card against NumPy f64."""
    H = jax.device_put(_spd(jax.random.PRNGKey(8), 33, 128, jnp.float32),
                       gpu)
    Hinv = jax.jit(functools.partial(sweep_spd_inverse, interpret=False))(H)
    ref = np.linalg.inv(np.asarray(H, np.float64))
    np.testing.assert_allclose(np.asarray(Hinv), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_fast_inverse_and_solve_on_gpu(gpu):
    """spd_inverse_fast / spd_solve_fast on the card (platform-dependent
    leaf compiled through Triton) against NumPy f64."""
    n = 300
    H = jax.device_put(_spd(jax.random.PRNGKey(9), 4, n, jnp.float32), gpu)
    R = jax.device_put(jax.random.normal(jax.random.PRNGKey(10), (4, n, 2),
                                         jnp.float32), gpu)
    with jax.default_matmul_precision("highest"):
        Hi = jax.jit(lin.spd_inverse_fast)(H)
        X = jax.jit(lin.spd_solve_fast)(H, R)
    H64 = np.asarray(H, np.float64)
    np.testing.assert_allclose(np.asarray(Hi), np.linalg.inv(H64),
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(X), np.linalg.solve(
        H64, np.asarray(R, np.float64)), rtol=5e-4, atol=5e-5)
