"""lqp_py_tpu — a batched differentiable quadratic-programming framework.

Capabilities mirror ipo-lab/lqp_py (batched box-constrained QP layers with
implicit/unrolled differentiation, plus interior-point and operator-splitting
general-QP solvers), re-designed for JAX/XLA/Pallas on an NVIDIA GPU: on-device
``lax.while_loop`` solvers, Schur-reduced Cholesky KKT solves, ``custom_vjp``
implicit gradients, and batch-sharded multi-chip execution via
``jax.sharding``.
"""

from lqp_py_tpu.config import (
    BoxQPConfig,
    GenQPConfig,
    OptNetConfig,
    box_qp_control,
    genqp_control,
    optnet_control,
    scs_control,
)
from lqp_py_tpu.types import BoxQPSolution, EqQPSolution, QPSolution
from lqp_py_tpu.models.box_qp import (
    prepare_box_qp,
    solve_box_qp,
    solve_box_qp_prepared,
    solve_box_qp_unrolled,
)
from lqp_py_tpu.models.layers import BoxQP, BoxQPLayer, boxqp
from lqp_py_tpu.models.eqcon import qp_eqcon, solve_qp_eqcon
from lqp_py_tpu.models.uncon import qp_uncon, solve_qp_uncon
from lqp_py_tpu.models.optnet import OptNetLayer, qp_optnet, solve_qp_optnet
from lqp_py_tpu.models.box_ip import boxqp_ip, solve_box_qp_ip
from lqp_py_tpu.models.genqp import (GenQP, GenQPLayer, prepare_qp_gen,
                                     qp_gen, solve_qp_gen,
                                     solve_qp_gen_prepared)

__version__ = "0.1.0"

__all__ = [
    "BoxQPConfig", "GenQPConfig", "OptNetConfig",
    "box_qp_control", "genqp_control", "optnet_control", "scs_control",
    "BoxQPSolution", "EqQPSolution", "QPSolution",
    "solve_box_qp", "solve_box_qp_unrolled",
    "prepare_box_qp", "solve_box_qp_prepared",
    "prepare_qp_gen", "solve_qp_gen_prepared",
    "BoxQP", "BoxQPLayer", "boxqp",
    "qp_eqcon", "solve_qp_eqcon", "qp_uncon", "solve_qp_uncon",
    "OptNetLayer", "qp_optnet", "solve_qp_optnet",
    "boxqp_ip", "solve_box_qp_ip",
    "GenQP", "GenQPLayer", "qp_gen", "solve_qp_gen",
]
