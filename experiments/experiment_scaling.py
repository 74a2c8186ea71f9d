"""Batch-sharded scaling: weak-scaling correctness and throughput of the
GSPMD and shard_map paths over a device mesh.

On several GPUs this measures scaling over NVLink (the only collective
is the convergence all-reduce).  In this environment it runs on the
8-virtual-device CPU mesh (set XLA_FLAGS=--xla_force_host_platform_
device_count=8) to validate that sharded execution produces the same
per-element solutions as single-device execution — the same check the
driver's dryrun performs for the training step.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python experiments/experiment_scaling.py --cpu
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU platform (virtual mesh)")
    ap.add_argument("--n-x", type=int, default=64)
    ap.add_argument("--per-dev-batch", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-6)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from lqp_py_tpu import BoxQPConfig, solve_box_qp
    from lqp_py_tpu.parallel.mesh import make_mesh
    from lqp_py_tpu.parallel.sharded import (solve_box_qp_sharded,
                                             solve_box_qp_shard_map)
    from lqp_py_tpu.utils.compile_cache import enable_compile_cache
    from lqp_py_tpu.utils.generators import create_qp_data

    enable_compile_cache()
    n_dev = len(jax.devices())
    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol)

    for d in sorted({1, max(n_dev // 2, 1), n_dev}):
        mesh = make_mesh(shape=(d,), devices=jax.devices()[:d])
        B = args.per_dev_batch * d
        data = create_qp_data(args.n_x, B, seed=0, dtype=jnp.float32)

        ref = solve_box_qp(*data, config=cfg)          # single-device
        t0 = time.perf_counter()
        s_g = solve_box_qp_sharded(mesh, *data, config=cfg)
        jax.block_until_ready(s_g.x)
        t_g = time.perf_counter() - t0
        err_g = float(jnp.max(jnp.abs(s_g.x - ref.x)))

        t0 = time.perf_counter()
        s_m = solve_box_qp_shard_map(mesh, *data, config=cfg)
        jax.block_until_ready(s_m.x)
        t_m = time.perf_counter() - t0
        err_m = float(jnp.max(jnp.abs(s_m.x - ref.x)))

        print(f"devices={d} batch={B}: GSPMD {t_g:.3f}s (|dx|={err_g:.1e}) "
              f"shard_map {t_m:.3f}s (|dx|={err_m:.1e}) "
              f"conv={int(jnp.sum(s_g.converged))}/{B}")
        assert err_g < 1e-4 and err_m < 1e-4, "sharded != single-device"

    print("scaling OK: sharded solutions match single-device at every "
          "mesh size")

    # --- tensor-parallel ('tp') section: the KKT operator column-sharded
    # across the mesh for a single LARGE problem (SURVEY §5 "long axis").
    # n is chosen so the factorization temporaries dominate; XLA's memory
    # analysis proves the per-device footprint shrinks with tp degree.
    from lqp_py_tpu.parallel.tp import lowered_tp_memory, solve_box_qp_tp
    n_tp = max(args.n_x, 512)
    data = create_qp_data(n_tp, 2, seed=0, dtype=jnp.float32)
    ref = solve_box_qp(*data, config=cfg)
    mesh_tp = make_mesh((1, n_dev), ("dp", "tp"))
    t0 = time.perf_counter()
    s_tp = solve_box_qp_tp(mesh_tp, *data, config=cfg)
    jax.block_until_ready(s_tp.x)
    t_tp = time.perf_counter() - t0
    err_tp = float(jnp.max(jnp.abs(s_tp.x - ref.x)))
    m_tp = lowered_tp_memory(mesh_tp, *data, config=cfg)
    m_1 = lowered_tp_memory(make_mesh((1, 1), ("dp", "tp")), *data,
                            config=cfg)
    ratio = m_1.temp_size_in_bytes / max(m_tp.temp_size_in_bytes, 1)
    print(f"tp={n_dev} n={n_tp}: solve {t_tp:.3f}s |dx|={err_tp:.1e} "
          f"per-device temp bytes {m_tp.temp_size_in_bytes} vs "
          f"unsharded {m_1.temp_size_in_bytes} ({ratio:.2f}x smaller)")
    assert err_tp < 1e-4, "tp-sharded != single-device"


if __name__ == "__main__":
    main()
