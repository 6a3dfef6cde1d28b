"""Optimization results.

Mirrors the reference ``tinyopt::Output`` (reference:
include/tinyopt/output.h:26-147) as a JAX pytree dataclass so the whole
result can be produced from inside a jitted solve (and vmapped over batched
problem instances).

Per-iteration history (``errs``/``deltas2``/``successes``) is stored in
fixed-length arrays of capacity ``max_iters(+extras)`` with a valid-prefix
counter ``num_hist`` — the jit-compatible equivalent of the reference's
growing ``std::vector`` history.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .cost import Cost
from .stop_reasons import StopReason, stop_reason_description


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Output:
    # Last valid (accepted) cost; +inf until the first evaluation.
    final_cost: Cost
    final_rerr_dec: jax.Array          #: last relative error decrease
    stop_reason: jax.Array             #: int32 StopReason code

    num_iters: jax.Array               #: int32
    num_failures: jax.Array            #: int32
    num_consec_failures: jax.Array     #: int32
    duration_ms: jax.Array             #: float32, filled by the host driver

    final_grad: jax.Array | None       #: last gradient (JᵀR), post-clipping
    final_hessian: jax.Array | None    #: last un-damped JᵀJ (if save_last)

    errs: jax.Array                    #: (capacity,) per-iteration cost
    deltas2: jax.Array                 #: (capacity,) per-iteration |δx|²
    successes: jax.Array               #: (capacity,) bool accept flags
    num_hist: jax.Array                #: int32 valid prefix length

    #: last LM damping factor λ (continuity across host-chunked segments)
    final_lambda: jax.Array | None = None

    num_diff_used: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    #: True when per-iteration logging was REQUESTED (options.log.enable
    #: or print_failure) but the backend rejects host callbacks, so the
    #: log lines were silently dropped — the
    #: in-band signal for the degraded mode (a RuntimeWarning also fires
    #: once per process).  Use tinyopt_tpu.profile_iterations for
    #: per-iteration telemetry that works on callback-less backends.
    log_dropped: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    # ---- Semantics (output.h:30-35) ----
    def succeeded(self):
        """Stop reason is not a failure (>= kNone)."""
        return self.stop_reason >= int(StopReason.NONE)

    def converged(self):
        """Stop reason in [kMinError, kMaxIters)."""
        return (self.stop_reason >= int(StopReason.MIN_ERROR)) & (
            self.stop_reason < int(StopReason.MAX_ITERS))

    # CamelCase aliases matching the reference API
    Succeeded = succeeded
    Converged = converged

    def covariance(self, rescaled: bool = False):
        """Covariance ≈ H⁻¹ of the final (un-damped) Hessian.

        With ``rescaled=True`` and an overdetermined system
        (num_residuals > dims), scales by ``final_cost² / (#res − dims)``
        exactly as the reference does (output.h:80-93).  Returns None if no
        Hessian was saved; entries are NaN if H is singular.
        """
        if self.final_hessian is None:
            return None
        H = self.final_hessian
        d = H.shape[-1] if not hasattr(H, "inv") else H.shape[0]
        if hasattr(H, "inv"):       # BlockDiag: blockwise sparse covariance
            cov = H.inv().to_dense()
        else:
            eye = jnp.eye(d, dtype=H.dtype)
            cov = jnp.linalg.solve(H, eye)
        if rescaled:
            from .ops.linalg import cov_rescale
            cov = cov * cov_rescale(
                self.final_cost.cost, self.final_cost.num_residuals, d)
        return cov

    Covariance = covariance

    def stop_reason_description(self, options=None) -> str:
        return stop_reason_description(
            int(self.stop_reason), options, float(self.final_cost.cost))

    # Trimmed, host-side history views
    @property
    def errs_list(self):
        return [float(e) for e in self.errs[: int(self.num_hist)]]

    @property
    def deltas2_list(self):
        return [float(e) for e in self.deltas2[: int(self.num_hist)]]

    @property
    def successes_list(self):
        return [bool(e) for e in self.successes[: int(self.num_hist)]]

    def __repr__(self):
        try:
            reason = StopReason(int(self.stop_reason)).name
            return (f"Output(stop={reason}, cost={float(self.final_cost.cost):.6e}, "
                    f"iters={int(self.num_iters)}, fails={int(self.num_failures)})")
        except Exception:  # batched/traced output
            return (f"Output(stop_reason={self.stop_reason!r}, "
                    f"final_cost={self.final_cost!r})")
