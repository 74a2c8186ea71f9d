"""Typed, frozen solver configurations.

The reference (`/root/reference/lqp_py/control.py:1-77`) uses plain dicts with
``control.get(key, default)`` lookups scattered through the solvers, which
caused two silent key-mismatch bugs (``check_terimnation`` vs ``check_solved``,
``adaptive_rho_max_iter`` vs ``adaptive_max_iter``).  Here every config is a
frozen dataclass: hashable (so it can be a static argument under ``jax.jit``),
typo-proof, and with a single source of defaults.

Dict-style constructors (``box_qp_control`` etc.) are provided for drop-in
familiarity with the reference API; they return the dataclass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def _check_interval_default(n_x: int) -> int:
    # Reference heuristic: max(round(sqrt(n_x)/10)*10, 1)
    # (solve_box_qp_admm_torch.py:139), capped at 4.  The reference's
    # uncapped value (30 at n_x=1000) was tuned for CPU, where each check
    # costs a host sync.  Here the check is traced on-device, and since
    # the Qx tolerance normalizer moved to the KKT identity (no (B, n, n)
    # GEMV per check) a check costs a fraction of an iteration: expected
    # overshoot past convergence is cs/2 iterations, so the optimum sits
    # near sqrt(iters * check/iter) ~ 3-4 (cap 10 exits at 21 iterations
    # where convergence is at 17).
    return max(min(round(math.sqrt(n_x) / 10) * 10, 4), 1)


def _check_acceleration(m: int) -> None:
    # SCS selects type-I AA with a NEGATIVE acceleration_lookback; only
    # type-II is implemented here, so reject the sign at construction
    # instead of tracing jnp.zeros((B, -m, ...)) into an opaque shape error.
    if m < 0:
        raise ValueError(
            f"acceleration must be >= 0 (type-II AA window size), got {m}; "
            f"SCS's negative acceleration_lookback selects type-I AA, which "
            f"is not implemented — pass the window size itself")


@dataclasses.dataclass(frozen=True)
class BoxQPConfig:
    """Configuration for the batched box-QP ADMM solver.

    Mirrors the knobs of the reference's ``box_qp_control``
    (control.py:1-24) with the key-mismatch bugs fixed: ``check_solved``
    and ``adaptive_rho_max_iter`` are actually honored here.
    """

    max_iters: int = 10_000
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    #: Residual-check interval; ``None`` -> reference heuristic
    #: max(round(sqrt(n_x)/10)*10, 1).
    check_solved: Optional[int] = None
    #: ADMM penalty; ``None`` -> per-element auto:
    #: rho_scale * ||Q||_F / sqrt(n_x).
    rho: Optional[float] = None
    #: Multiplier on the auto-rho.  The reference implicitly uses 1.0
    #: (solve_box_qp_admm_torch.py:200-203); 0.5 measured best across the
    #: random-SPD and hard-QP families at tol 1e-5 with the per-element
    #: adaptive-rho gate (21 vs 41 iters at dz=1000).
    rho_scale: float = 0.5
    rho_min: float = 1e-6
    rho_max: float = 1e6
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0
    #: First adaptive-rho update / update spacing, in iterations.  The
    #: reference waits 100 iterations; here a refactorization is a batch
    #: of GEMMs, so adapting early (25) pays for itself on hard problems
    #: (711 -> 286 iters on the hard dz=50 set).
    adaptive_rho_iter: int = 25
    adaptive_rho_max_iter: int = 1000
    adaptive_rho_threshold: float = 1e-5
    #: Over-relaxation parameter (x_hat = alpha*x + (1-alpha)*z before the
    #: z/u updates).  The classical ADMM accelerator (OSQP defaults to 1.6);
    #: the reference has no such knob (always 1.0) but converges to the
    #: same fixed point — the relaxed iteration typically needs ~30% fewer
    #: iterations at tight tolerances.  Set 1.0 for step-for-step parity
    #: with the reference iteration.
    alpha: float = 1.6
    verbose: bool = False
    scale: bool = True
    #: Scaling blend factor; ``None`` -> per-element auto from D quantiles.
    beta: Optional[float] = None
    unroll: bool = False
    #: Defensively symmetrize Q (0.5*(Q + Q^T)) before solving, so the
    #: solution — and therefore every gradient — is a well-defined function
    #: on the symmetric manifold even when callers pass a slightly
    #: asymmetric Q.  The reference performs no such pass (it uses Q as
    #: given, solve_box_qp_admm_torch.py:161-215); disabling it for inputs
    #: known to be exactly symmetric saves a full (B, n, n) HBM round trip
    #: per solve.
    symmetrize: bool = True
    #: Backward mode: 'fixed_point' | 'kkt' (unroll=True uses autodiff).
    backward: str = "fixed_point"
    #: KKT solve strategy inside the ADMM loop:
    #:   'inverse'  - precompute the reduced KKT inverse; each iteration is a
    #:                single batched GEMV (the fast path).
    #:   'cholesky' - keep triangular factors; each iteration does two
    #:                triangular solves (better conditioned, slower).
    kkt_solver: str = "inverse"
    #: Fixed iteration count used when ``unroll=True`` (JAX cannot
    #: reverse-differentiate a while_loop, so unrolled mode runs a static
    #:-length lax.scan).  ``None`` -> max_iters.
    unroll_iters: Optional[int] = None
    #: Diagonal regularizer added to the masked KKT system in the
    #: fixed-point backward (reference uses 1e-8).
    backward_reg: float = 1e-8
    #: OSQP-style solution polish (no reference counterpart): after the
    #: ADMM loop, re-solve with the detected active bounds penalty-pinned
    #: (models/_polish.py) and accept per element only if feasibility does
    #: not degrade and the implied active multipliers are nonnegative —
    #: lifts x from stopping-tolerance accuracy to near working-precision
    #: for the cost of one extra factorization per solve.  Off by default:
    #: the flagship per-call latency budget is one factorization.
    polish: bool = False
    #: Detect primal infeasibility (inconsistent equality constraints /
    #: crossed bounds) from successive dual differences, OSQP-style
    #: (Banjac et al. 2019).  The reference runs to max_iters silently;
    #: SCS's eps_infeas is the closest analogue.
    detect_infeasibility: bool = True
    #: Relative tolerance of the infeasibility certificate test.
    eps_infeas: float = 1e-5
    #: Mid-solve observability without host callbacks: when K > 0 the
    #: while-loop carries a (K, 3) ring buffer of
    #: ``[iteration, max primal residual, max dual residual]`` rows — one
    #: per residual check, keeping the LAST K checks — returned as
    #: ``solution.residual_trace``.  The reference prints residuals
    #: mid-solve (solve_box_qp_admm_torch.py:289-294), which ``verbose``
    #: replicates through host callbacks; this keeps the record on the
    #: device and returns it with the solution.  0 = off.
    residual_trace: int = 0
    #: Anderson-acceleration window on the (z, u) ADMM fixed point (same
    #: batched safeguarded type-II scheme as GenQPConfig.acceleration).
    #: 0 = off: the tuned defaults
    #: already sit at the iteration floor (~21 at dz=1000) on the
    #: random-SPD family; turn on for slowly-converging problems
    #: (measured on the hard ill-conditioned set, see
    #: experiments/experiment_1_hard.py artifacts).
    acceleration: int = 0
    aa_safeguard: float = 2.0      # see GenQPConfig.aa_safeguard
    aa_reg: float = 1e-8           # see GenQPConfig.aa_reg
    aa_max_weight: float = 1e3     # see GenQPConfig.aa_max_weight

    def __post_init__(self):
        if not (0.0 < self.alpha < 2.0):
            raise ValueError(
                f"alpha must be in (0, 2) for ADMM convergence, got "
                f"{self.alpha}")
        if self.acceleration and self.unroll:
            raise ValueError(
                "acceleration is not implemented for the unrolled "
                "(differentiate-through-iterations) path; use the implicit "
                "backward modes with acceleration, or unroll without it")
        _check_acceleration(self.acceleration)
        if self.polish and self.unroll:
            raise ValueError(
                "polish is not implemented for the unrolled "
                "(differentiate-through-iterations) path — it returns the "
                "bare iterate; use the implicit backward modes with polish")

    def resolved_check_interval(self, n_x: int) -> int:
        cs = self.check_solved
        if cs is None:
            cs = _check_interval_default(n_x)
        return max(int(cs), 1)

    def resolved_adaptive_interval(self, n_x: int) -> int:
        # Reference rounds the adaptive-rho interval to a multiple of the
        # check interval (solve_box_qp_admm_torch.py:146-147).
        cs = self.resolved_check_interval(n_x)
        it = round(self.adaptive_rho_iter / cs) * cs
        return max(it, 1)


@dataclasses.dataclass(frozen=True)
class OptNetConfig:
    """Configuration for the batched interior-point (OptNet-style) solver.

    Mirrors ``optnet_control`` (control.py:27-36).
    """

    max_iters: int = 10
    tol: float = 1e-3
    check_solved: int = 1
    verbose: bool = False
    #: Residual reduction across the batch for the stopping test:
    #: 'mean' | 'max'.
    reduce: str = "max"
    #: Defensive 0.5*(Q + Q^T) pass — see BoxQPConfig.symmetrize.
    symmetrize: bool = True
    int_reg: float = 1e-6
    #: Per-iteration factorization strategy:
    #:   'schur'     - reference shape (optnet.py:281-296): invert the
    #:                 ni x ni inequality-Schur block each iteration.
    #:   'condensed' - invert the n x n ``Q + G' diag(d) G`` each iteration
    #:                 (8x fewer FLOPs for the box shape G = [-I; I]).
    #:   'auto'      - condensed iff n_ineq > n_x.
    factor: str = "auto"
    #: Iterative-refinement steps on each condensed KKT solve (f32 only
    #: needs this at large n: the materialized-inverse solve floors around
    #: 1e-3 dual infeasibility at n=1000; 1-2 steps of refinement recover
    #: the digits for a few GEMVs each).  Ignored by the 'schur' path.
    refine_steps: int = 0
    #: Active-set polish after convergence (OSQP-style; absent in the
    #: reference): one masked factorization solving the active-set
    #: equality problem exactly, accepted per element only when feasibility
    #: does not regress.  Lifts the f32 weak-activity solution-error floor
    #: (~sqrt(tol)) to solve accuracy.
    polish: bool = True


@dataclasses.dataclass(frozen=True)
class GenQPConfig:
    """Configuration for the batched general-inequality QP solver
    (batched replacement for the reference's sequential SCS wrapper,
    scs_qp.py:52-118).  Solves  min 1/2 x'Qx + p'x  s.t. Ax=b, Gx<=h.
    """

    max_iters: int = 20_000
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    check_solved: int = 25
    rho: Optional[float] = None
    #: Multiplier on the auto-rho (||Q||_F / sqrt(n)); 0.3 measured best
    #: across sizes on the random-SPD family (26 vs 76 iterations at
    #: n=500/1000 relative to 1.0).
    rho_scale: float = 0.3
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    #: Defensive 0.5*(Q + Q^T) pass — see BoxQPConfig.symmetrize.
    symmetrize: bool = True
    #: Over-relaxation on the splitting variable (1.0 = plain iteration);
    #: same accelerator as BoxQPConfig.alpha.
    alpha: float = 1.6
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0
    adaptive_rho_iter: int = 100
    adaptive_rho_max_iter: int = 4000
    #: Converged-enough elements (both residuals below max(tol, this)) are
    #: excluded from rho updates — same gate as BoxQPConfig.
    adaptive_rho_threshold: float = 1e-5
    #: True masks rho updates per element (each element moves only when
    #: ITS OWN ratio is out of band), as the box solver does.  False
    #: rescales every element whenever any one trips (the reference
    #: behavior, solve_box_qp_admm_torch.py:247-250).  MEASURED on the
    #: hard set (experiments/experiment_1_hard.py, exp1_hard_results.json):
    #: for THIS splitting the gate is neutral on the random-SPD family but
    #: slower on hard problems (8401 vs 5576 iters at n=50, 526 vs 226 at
    #: n=100) — the opposite of the box solver, where gating was a large
    #: win.  Hence the reference behavior is the default here.
    adaptive_rho_per_element: bool = False
    verbose: bool = False
    scale: bool = True
    #: Backward mode: 'conic' (SCS-style projection-derivative implicit
    #: diff, scs_qp.py:121-189) | 'kkt' (active-set KKT implicit diff).
    backward: str = "kkt"
    #: Farkas-style primal-infeasibility certificate from successive dual
    #: differences (the SCS eps_infeas capability).
    detect_infeasibility: bool = True
    eps_infeas: float = 1e-5
    #: OSQP-style active-set polish (see BoxQPConfig.polish): re-solve with
    #: the detected active rows of G x <= h penalty-pinned
    #: (H = Q + w G_act' G_act, models/_polish.py) after the splitting
    #: loop; per-element acceptance.  One extra factorization per solve.
    polish: bool = False
    #: Anderson-acceleration window on the (w, u) splitting fixed point
    #: (the SCS ``acceleration_lookback`` capability, batched and
    #: lock-step: type-II AA with a sum-to-one combination solved from
    #: regularized normal equations, per-element safeguarding).  0 = off
    #: (default: on the random-SPD family the splitting already converges
    #: in ~26 iterations and AA only adds per-iteration work; turn it on
    #: for slowly-converging problems — measured 2-4x fewer iterations on
    #: the hard ill-conditioned set, experiments/experiment_1_hard.py).
    acceleration: int = 0
    #: Per-element safeguard: if the fixed-point residual grows past this
    #: factor times the BEST residual seen since the last reset, that
    #: element takes the plain (un-accelerated) step and its AA history is
    #: reset.  (A consecutive-iterate monitor is too weak: slow exponential
    #: churn that grows < factor per iteration never trips it — measured as
    #: a 201 -> 20000-iteration blow-up on the f32 hard set.)
    aa_safeguard: float = 2.0
    #: Tikhonov regularizer on the column-normalized AA normal equations
    #: (relative to trace/m; the history columns are normalized to unit
    #: 2-norm before forming R'R, or squaring the column-scale spread
    #: destroys the f32 solve).
    aa_reg: float = 1e-8
    #: Reject the accelerated step (keep the plain one, no reset) when the
    #: combination weights' 1-norm exceeds this — extrapolations that
    #: aggressive amplify roundoff faster than they converge.
    aa_max_weight: float = 1e3

    def __post_init__(self):
        _check_acceleration(self.acceleration)


def box_qp_control(**kwargs) -> BoxQPConfig:
    """Dict-style constructor mirroring the reference's ``box_qp_control``.

    Unknown keys raise immediately instead of being silently ignored.
    """
    return BoxQPConfig(**kwargs)


def optnet_control(**kwargs) -> OptNetConfig:
    return OptNetConfig(**kwargs)


def genqp_control(**kwargs) -> GenQPConfig:
    return GenQPConfig(**kwargs)


#: Reference ``scs_control`` knobs (control.py:39-77) that have no
#: counterpart in the batched solver.  Deliberate scoping, not
#: accidental drops — see PARITY.md ("conic knob surface") for rationale:
#: the sequential C-solver plumbing (mkl/gpu/use_indirect/files),
#: per-k AA scheduling, and wall-clock limits do not map onto a
#: lock-step jitted batch.  (``acceleration_lookback`` itself DOES map —
#: onto ``GenQPConfig.acceleration`` — since round 3.)
_SCS_UNSUPPORTED = {
    "use_indirect", "mkl", "gpu",
    "acceleration_interval", "time_limit_secs", "write_data_filename",
    "log_csv_filename",
}


def scs_control(**kwargs) -> GenQPConfig:
    """Reference-compatible constructor for the SCS-capability solver: maps
    the reference's ``scs_control`` knob names (control.py:39-77) onto
    GenQPConfig.

    Mapping: normalize -> scale; scale -> rho (SCS's dual scale plays the
    role of the splitting penalty; None keeps the auto rho); adaptive_scale
    -> adaptive_rho; rho_x -> sigma (primal regularization); alpha,
    eps_abs/eps_rel, max_iters, verbose pass through.  Unsupported knobs
    (see ``_SCS_UNSUPPORTED``) raise unless ``ignore_unsupported=True``.
    """
    kwargs = dict(kwargs)
    ignore = kwargs.pop("ignore_unsupported", False)
    unsupported = sorted(set(kwargs) & _SCS_UNSUPPORTED)
    if unsupported and not ignore:
        raise ValueError(
            f"scs_control knobs {unsupported} have no batched counterpart "
            f"(see PARITY.md); pass ignore_unsupported=True to drop them")
    for k in _SCS_UNSUPPORTED:
        kwargs.pop(k, None)
    # Reference 'scale' is SCS's numeric dual-scale factor (the splitting
    # penalty), distinct from the 'normalize' preconditioning flag.
    if "scale" in kwargs:
        kwargs.setdefault("rho", float(kwargs.pop("scale")))
    # SCS's Anderson-acceleration window (negative = type-I in SCS; the
    # batched implementation is type-II, so take the magnitude).
    if "acceleration_lookback" in kwargs:
        kwargs.setdefault(
            "acceleration", abs(int(kwargs.pop("acceleration_lookback"))))
    # SCS's eps_infeas maps onto the Farkas certificate tolerance and
    # turns detection on (control.py:39-77 knob; capability:
    # GenQPConfig.detect_infeasibility/eps_infeas).
    if "eps_infeas" in kwargs:
        kwargs.setdefault("detect_infeasibility", True)
        kwargs["eps_infeas"] = float(kwargs["eps_infeas"])
    rename = {"normalize": "scale", "adaptive_scale": "adaptive_rho",
              "rho_x": "sigma"}
    out = {rename.get(k, k): v for k, v in kwargs.items()}
    return GenQPConfig(**out)
