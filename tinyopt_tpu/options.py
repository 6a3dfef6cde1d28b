"""Optimization options.

Frozen (hashable) dataclasses so an ``Options`` instance can be passed as a
static argument to ``jax.jit`` — every numeric option is baked into the
compiled program as a constant (no host->device scalar traffic per solve).

Defaults and semantics mirror the reference ``tinyopt::Options``
(reference: include/tinyopt/optimizers/options.h:18-156).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional


class SolverType(enum.Enum):
    """Which solver drives the step proposal (options.h:24-30).

    LM/GN/GD mirror the reference; SGD / ADAM / ADAMW / LBFGS are the
    "more optimizers" its roadmap promises (reference README.md:152) —
    first-order methods with per-solve state (momentum, moment estimates,
    curvature pairs) carried through the same jitted loop, sharing the
    full accept/reject, stop-reason, and Output machinery.
    """

    LEVENBERG_MARQUARDT = 0
    GAUSS_NEWTON = 1
    GRADIENT_DESCENT = 2
    SGD = 3                  #: gradient descent + (Nesterov) momentum
    ADAM = 4                 #: Adam (Kingma & Ba 2015)
    ADAMW = 5                #: Adam with decoupled weight decay
    LBFGS = 6                #: limited-memory BFGS (two-loop recursion)
    DOGLEG = 7               #: Powell dogleg trust region (beyond the
                             #: reference: it DISABLES Wood and
                             #: Freudenstein-Roth "pending trust-region",
                             #: tests/optimize_hard.cpp:289-295).  The
                             #: trust radius rides the λ machinery as a
                             #: step-length-relative inverse, Δ =
                             #: ‖dx_GN‖/λ: any λ ≤ 1 admits the full GN
                             #: step, rejections/failures compound λ =
                             #: shrink/bend the failed step, good steps
                             #: shrink λ back; lm.damping_range clamps.
                             #: The default lm.damping_init (1e-4 ≤ 1)
                             #: starts at the full GN step.


# Short aliases
LevenbergMarquardt = SolverType.LEVENBERG_MARQUARDT
GaussNewton = SolverType.GAUSS_NEWTON
GradientDescent = SolverType.GRADIENT_DESCENT
SGD = SolverType.SGD
Adam = SolverType.ADAM
AdamW = SolverType.ADAMW
LBFGS = SolverType.LBFGS
DogLeg = SolverType.DOGLEG

#: Solver types that never build a Hessian (gradient-only loop).
FIRST_ORDER_TYPES = frozenset({
    SolverType.GRADIENT_DESCENT, SolverType.SGD, SolverType.ADAM,
    SolverType.ADAMW, SolverType.LBFGS})

#: First-order types with per-solve optimizer state in the loop carry.
STATEFUL_FO_TYPES = frozenset({
    SolverType.SGD, SolverType.ADAM, SolverType.ADAMW, SolverType.LBFGS})


def is_stateful_fo(options: "Options") -> bool:
    """Whether this configuration carries first-order optimizer state in
    the loop (momentum/moments/curvature pairs, or GD's adaptive lr)."""
    return (options.solver_type in STATEFUL_FO_TYPES
            or (options.solver_type == SolverType.GRADIENT_DESCENT
                and options.gd.adaptive != "off"))

#: Types whose step-control state rides the λ schedule (λ = damping for
#: LM, λ = inverse trust radius for DOGLEG): GoodStep/BadStep/FailedStep
#: updates apply (lm.h:123-154 semantics for both).
LAMBDA_SCHEDULED_TYPES = frozenset({
    SolverType.LEVENBERG_MARQUARDT, SolverType.DOGLEG})


@dataclasses.dataclass(frozen=True)
class HessianOptions:
    """Hessian handling options (options.h:58-67)."""

    #: Use a Cholesky factorization with PSD-failure detection. If False, use
    #: an unchecked explicit inverse (except for 1-dim problems).
    use_ldlt: bool = True
    #: Reject the build when any |H[i,i]| is below this threshold (0 = off).
    check_min_H_diag: float = 0.0
    #: Whether manual acc functions fill the FULL Hessian.  If False, the
    #: acc function may fill only the upper triangle (the reference's
    #: recommended fast path, docs/API.md:170) and the lower part is
    #: recovered by symmetrization (reference: gn.h:139-145,
    #: options.h:58-67).  Only meaningful for mode="acc" with a dense H;
    #: AD/numdiff paths always build a full H.
    H_is_full: bool = True
    #: Save the last (un-damped) Hessian into the Output.
    save_last: bool = True
    #: Linear solver for the normal equations: "cholesky" (exact,
    #: PSD-failure detection) or "cg" (fixed-iteration Jacobi-PCG —
    #: inexact LM; under vmap the whole batch's solves run as one call,
    #: ops/pallas_cg.make_cg_solver).  No reference counterpart for "cg".
    solver: str = "cholesky"
    #: CG iteration count (0 = tangent dimension).
    cg_iters: int = 0
    #: Carry (H, g) across loop iterations so rejected steps re-damp the
    #: last built system without re-accumulating (the reference's
    #: Rebuild(false) optimization, lm.h:96-105).  With False the loop
    #: re-accumulates at the (rolled-back) point instead — mathematically
    #: the same system at every accepted step, but the large H tensor
    #: stays out of the while-loop carry, which removes per-iteration
    #: HBM copy/select traffic in the batched case (faster whenever
    #: rejections are rare).  Requires save_last=False.
    carry_system: bool = True
    #: Mixed-precision iterative-refinement rounds on the Schur-family
    #: REDUCED camera solve (schur_optimize / schur_sparse_optimize /
    #: sharded_schur_optimize).  Each round computes the residual
    #: r = rhs − S·dx in float64 (cheap: one matvec) and re-solves for
    #: the correction with the float32 factor — error contracts by
    #: ~eps32·cond(S) per round, recovering
    #: near-f64-quality steps from an f32 factorization.  Needs
    #: jax_enable_x64 (silently a no-op improvement-wise without it).
    #: Measured: a 1000-camera corridor BA stalls at 3×-noise rmse in
    #: plain f32 and converges to noise with 2 rounds.  0 = off.
    schur_refine: int = 0
    #: Solve the Schur-family REDUCED camera system by block-Jacobi
    #: preconditioned CG with this many iterations instead of the dense
    #: Cholesky (0 = direct).  Inexact-LM semantics (a poor step is
    #: rejected and λ escalates), matvecs are memory-bandwidth-bound —
    #: right when the (n_a·da)² factorization dominates the iteration.
    #: ``schur_refine`` is ignored on this path.  No reference
    #: counterpart (the reference's solver is Eigen LDLT only,
    #: math.h:232-277).
    schur_cg_iters: int = 0
    #: Exploit block-BANDED reduced camera systems ("auto", default):
    #: when the static camera co-observation structure has bandwidth
    #: bw ≪ n_cams (corridor / rail / sequential-SLAM rigs — detected
    #: at build time from cam_idx), consecutive cameras group into
    #: bw-sized super-blocks and the reduced solve runs by log-depth
    #: block cyclic reduction (ops/tridiag.py) in O(n_a·(bw·da)²)
    #: instead of the dense (n_a·da)³/3 Cholesky — exact algebra, same
    #: refine semantics.  Activates only when blocks ≤ 384 tangent
    #: dims and ≥ 8 groups (ops/schur_obs.pick_band_group); "off"
    #: forces the dense path.  Covers schur_sparse_optimize, the
    #: bucketed entry (bandwidth over the union of buckets) and the
    #: sharded entry (single-process meshes, where the global structure
    #: is host-visible).
    schur_banded: str = "auto"
    #: Internal landmark sort for camera locality ("auto", default):
    #: when the caller's landmark order defeats the windowed matmul
    #: reduced-system assembly (ops/schur_obs.plan_window_reduce) but a
    #: primary-camera sort admits it, schur_sparse_optimize re-orders
    #: landmarks INTERNALLY (one static permutation through the bucket
    #: machinery; x keeps the caller's order).  "off" keeps the given
    #: order.  Landmark order is semantically arbitrary in the
    #: point-major layout — this only changes summation order (f32
    #: rounding), never the algebra.
    schur_sort: str = "auto"

    def __post_init__(self):
        if self.solver not in ("cholesky", "cg"):
            raise ValueError(
                'hessian.solver must be "cholesky" or "cg", got '
                f"{self.solver!r}")


@dataclasses.dataclass(frozen=True)
class CostScalingOptions:
    """Cost scaling options (options.h:75-80)."""

    use_squared_norm: bool = True  #: cost = ||r||^2 (faster); else ||r||
    downscale_by_2: bool = False   #: cost *= 0.5
    normalize: bool = False        #: cost /= num_residuals


@dataclasses.dataclass(frozen=True)
class LMOptions:
    """Levenberg-Marquardt damping schedule (options.h:128-141)."""

    damping_init: float = 1e-4     #: Initial λ (0 disables damping ≈ GN)
    damping_range: tuple = (1e-9, 1e9)  #: λ clamp range
    good_factor: float = 1.0 / 3.0  #: λ scale on accepted steps
    bad_factor: float = 2.0         #: λ scale on rejected steps (compounds)


@dataclasses.dataclass(frozen=True)
class GDOptions:
    """Gradient descent options (options.h:147-154).

    ``adaptive`` implements the reference's declared TODO ("Adaptive
    learning rate", options.h:149-152): ``"bb"`` uses the
    Barzilai–Borwein two-point step size (Barzilai & Borwein 1988,
    IMA J. Numer. Anal. 8:141-148) — lr = sᵀy/yᵀy from the secant pair
    between consecutive build points, falling back to the previous lr
    when the curvature estimate is invalid (sᵀy ≤ 0 or non-finite).
    Adaptive proposals additionally share the stateful-method rejection
    backoff (lr·bad_factor₀/bad_factor), so rejected BB overshoots
    backtrack geometrically instead of re-proposing verbatim.
    ``"off"`` (default) keeps the reference's fixed-lr behavior."""

    lr: float = 1e-3          #: Fixed (or initial, for adaptive) rate
    adaptive: str = "off"     #: "off" | "bb" (Barzilai–Borwein)


@dataclasses.dataclass(frozen=True)
class SGDOptions:
    """SGD-with-momentum options (no reference counterpart — roadmap
    "more optimizers", README.md:152).  Torch-convention defaults."""

    lr: float = 1e-3
    momentum: float = 0.9     #: v ← µ·v + g; 0 reduces to plain GD
    nesterov: bool = False    #: step on g + µ·v instead of v


@dataclasses.dataclass(frozen=True)
class AdamOptions:
    """Adam / AdamW options (Kingma & Ba 2015; Loshchilov & Hutter 2019).

    ``weight_decay`` applies only for ``SolverType.ADAMW`` (decoupled:
    dx −= lr·wd·x) and requires pure-Euclidean parameters — decay toward
    the origin is not defined on a manifold.

    Deviation from the cited formulation: the decay term shares the
    rejection backoff with the gradient step (dx = −lr·backoff·(upd +
    wd·x)), so consecutive rejected proposals shrink the effective decay
    of the step finally accepted.  Scaling the whole proposal keeps the
    accept/reject backtracking sound; see solvers/first_order.fo_propose."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2


@dataclasses.dataclass(frozen=True)
class LBFGSOptions:
    """Limited-memory BFGS options (no reference counterpart).

    The two-loop recursion runs over a fixed ring buffer of ``memory``
    curvature pairs; the step is scaled by ``lr · bad_factor₀/bad_factor``
    — the LM schedule's compounding rejection factor halves the step on
    every consecutive rejection and resets it on acceptance, i.e.
    geometric backtracking through the loop's own accept/reject machinery
    instead of a separate Wolfe line search."""

    memory: int = 8
    lr: float = 1.0


@dataclasses.dataclass(frozen=True)
class LogOptions:
    """Iteration logging options (options.h:113-125).

    When ``enable`` is True, a per-iteration log line is emitted through
    ``jax.debug.print`` (works from inside jit) with the same fields as the
    reference: error, dε, relative dε, |δx|, |∇|, 1/λ.

    ``print_emoji`` and ``print_t`` route the line through a host
    callback instead (the emoji choice and the clock are host-side):
    ℹ️/✅/❌ status prefix like the reference (optimizer.h:465), and
    ``τ:<ms>`` = host wall-clock milliseconds since the solve's first
    logged iteration (the reference's cumulative ``out.duration_ms``,
    optimizer.h:513; device-async skew is inherent — the callback fires
    when the iteration's values reach the host).
    """

    enable: bool = False
    e: str = "ε²"               #: Symbol used for the error in log lines
    print_emoji: bool = False   #: ℹ️ (first eval) / ✅ (accepted) / ❌ prefix
    print_x: bool = False
    print_dx: bool = False
    print_inliers: bool = False
    print_t: bool = False       #: τ: cumulative host ms since first iteration
    print_J_jet: bool = False   #: log the AD Jacobian from the NLLS adapter
    print_max_stdev: bool = False
    print_failure: bool = False


@dataclasses.dataclass(frozen=True)
class Options:
    """Common optimization options (options.h:18-156).

    Hashable so it can be a jit static argument. ``stop_callback`` must be a
    JAX-traceable callable ``(err, dx_norm2, grad_norm2) -> bool`` (traced
    into the loop); ``stop_callback2`` receives ``(err, dx, grad)``.
    """

    solver_type: SolverType = SolverType.LEVENBERG_MARQUARDT

    #: Re-evaluate the cost once more after the final iteration and roll back
    #: if it increased (options.h:43).
    check_final_cost: bool = False
    #: Use the relative error decrease as the LM step quality (options.h:46).
    use_step_quality_approx: bool = False
    #: Clip the gradient to [-v, +v]; 0 disables (options.h:49).
    grad_clipping: float = 0.0

    hessian: HessianOptions = HessianOptions()
    cost: CostScalingOptions = CostScalingOptions()

    # --- Stop criteria (options.h:89-106) ---
    max_iters: int = 50
    min_error: float = 1e-12
    min_rerr_dec: float = 1e-10
    min_step_norm2: float = 1e-14
    min_grad_norm2: float = 1e-18
    max_total_failures: int = 0
    max_consec_failures: int = 5
    max_duration_ms: float = 0.0

    #: Record per-iteration history (errs/deltas2/successes) in the
    #: Output.  Costs batched scatter updates per iteration; disable for
    #: maximum throughput on huge batches (history arrays come back
    #: empty, capacity 0).
    save_history: bool = True

    #: Traceable callback (err, |δx|², |∇|²) -> bool; True stops the loop.
    stop_callback: Optional[Callable[..., Any]] = None
    #: Traceable callback (err, δx, ∇) -> bool; True stops the loop.
    stop_callback2: Optional[Callable[..., Any]] = None

    log: LogOptions = LogOptions()
    lm: LMOptions = LMOptions()
    gd: GDOptions = GDOptions()
    sgd: SGDOptions = SGDOptions()
    adam: AdamOptions = AdamOptions()
    lbfgs: LBFGSOptions = LBFGSOptions()

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    # Convenience constructors mirroring the namespace products
    # (reference: optimizers/{lm,gn,gd}.h)
    @staticmethod
    def lm_(**kw) -> "Options":
        return Options(solver_type=SolverType.LEVENBERG_MARQUARDT, **kw)

    @staticmethod
    def gn(**kw) -> "Options":
        return Options(solver_type=SolverType.GAUSS_NEWTON, **kw)

    def for_dtype(self, dtype) -> "Options":
        """Stop thresholds rescaled to the solve dtype's precision.

        The reference's defaults (min_step_norm2 = 1e-14 etc.,
        options.h:89-106) are calibrated for double: in float32 a coupled
        problem converges to machine-precision cost but |dx|² floors near
        (f32 eps-level residual)² ≈ 1e-14 > 1e-16-ish thresholds, so the
        solve "stops" via the failure budget instead of a convergence
        criterion.  This scales each threshold by the FloatEpsilon ratio
        (math.h:297-301; 1e-4 f32 vs 1e-7 f64) raised to the quantity's
        order — squared quantities (min_error, min_step_norm2,
        min_grad_norm2) by ratio², the relative decrease by ratio — and
        leaves f64 options unchanged."""
        import jax.numpy as jnp

        from .utils import float_epsilon

        ratio = float_epsilon(dtype) / float_epsilon(jnp.float64)
        if ratio == 1.0:
            return self
        return self.replace(
            min_error=self.min_error * ratio ** 2,
            min_rerr_dec=self.min_rerr_dec * ratio,
            min_step_norm2=self.min_step_norm2 * ratio ** 2,
            min_grad_norm2=self.min_grad_norm2 * ratio ** 2,
        )

    @staticmethod
    def gd_(**kw) -> "Options":
        return Options(solver_type=SolverType.GRADIENT_DESCENT, **kw)
