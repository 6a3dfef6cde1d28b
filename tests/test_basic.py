"""Outer-loop semantics & failure injection.

Behavioral spec mirror of the reference's tests/basic.cpp: expected
StopReason per scenario, history invariants, and failure budgets
(SURVEY.md §4.2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu import StopReason


def _reason(out) -> StopReason:
    return StopReason(int(out.stop_reason))


class TestStopReasons:
    def test_min_error(self):
        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                             to.Options(min_error=1e-6))
        assert _reason(out) == StopReason.MIN_ERROR
        assert bool(out.converged()) and bool(out.succeeded())

    def test_max_iters(self):
        x, out = to.optimize(jnp.asarray(100.0), lambda x: x * x - 2.0,
                             to.Options(max_iters=2, min_error=0,
                                        min_rerr_dec=0, min_step_norm2=0,
                                        min_grad_norm2=0))
        assert _reason(out) == StopReason.MAX_ITERS
        assert bool(out.succeeded()) and not bool(out.converged())
        assert int(out.num_iters) == 3  # max_iters + 1 rollback slot

    def test_min_delta_norm(self):
        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                             to.Options(min_error=0, min_rerr_dec=0,
                                        min_step_norm2=1e-8,
                                        min_grad_norm2=0))
        assert _reason(out) == StopReason.MIN_DELTA_NORM

    def test_min_grad_norm(self):
        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                             to.Options(min_error=0, min_rerr_dec=0,
                                        min_step_norm2=0,
                                        min_grad_norm2=1e-8))
        assert _reason(out) == StopReason.MIN_GRAD_NORM

    def test_user_stop_callback(self):
        """Traceable stop callback (basic.cpp:125-143)."""
        def cb(err, dx2, g2):
            return err < 1e-3

        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                             to.Options(min_error=0, min_rerr_dec=0,
                                        min_step_norm2=0, min_grad_norm2=0,
                                        stop_callback=cb))
        assert _reason(out) == StopReason.USER_STOPPED

    def test_user_stop_callback2_receives_vectors(self):
        def cb2(err, dx, g):
            assert dx.shape == (2,) and g.shape == (2,)
            return jnp.sum(dx * dx) < 1e-10

        x, out = to.optimize(jnp.array([1.0, 1.0]),
                             lambda p: jnp.stack([p[0] * p[0] - 2.0,
                                                  p[1] - 1.0]),
                             to.Options(min_error=0, min_rerr_dec=0,
                                        min_step_norm2=0, min_grad_norm2=0,
                                        stop_callback2=cb2))
        assert _reason(out) == StopReason.USER_STOPPED

    def test_timeout_path_identical_to_plain_path(self):
        """With an ample budget the host-chunked timeout driver follows
        byte-identical trajectories to the un-chunked loop (full state
        carry across segments: λ + bad_factor, accept/reject, budgets)."""
        fn = lambda x: x * x - 2.0
        xa, oa = to.optimize(jnp.asarray(0.5), fn,
                             to.Options(max_consec_failures=0,
                                        max_duration_ms=60_000))
        xb, ob = to.optimize(jnp.asarray(0.5), fn,
                             to.Options(max_consec_failures=0))
        assert float(xa) == float(xb)
        assert int(oa.num_iters) == int(ob.num_iters)
        assert int(oa.num_failures) == int(ob.num_failures)
        assert oa.errs_list == ob.errs_list
        assert int(oa.stop_reason) == int(ob.stop_reason)

    def test_timeout_respects_max_iters(self):
        _, out = to.optimize(jnp.asarray(100.0), lambda x: x * x - 2.0,
                             to.Options(max_iters=5, max_duration_ms=60_000,
                                        min_error=0, min_rerr_dec=0,
                                        min_step_norm2=0, min_grad_norm2=0))
        assert int(out.num_iters) == 6  # max_iters + 1 rollback slot

    def test_timeout_with_zero_max_iters(self):
        _, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                             to.Options(max_iters=0, max_duration_ms=1e4))
        assert int(out.num_iters) == 1  # the +1 slot, no crash

    def test_timeout(self):
        """max_duration_ms > 0 stops with TIMED_OUT (basic.cpp:88-106)."""
        import time

        def slow_residual(x):
            # Host-side sleep inside the (uncached) trace is not possible;
            # rely on the host-chunked driver seeing elapsed wall time.
            return x * x - 2.0

        opts = to.Options(max_iters=10_000, min_error=0, min_rerr_dec=0,
                          min_step_norm2=0, min_grad_norm2=0,
                          max_duration_ms=1e-3)
        x, out = to.optimize(jnp.asarray(1e8), slow_residual, opts)
        assert _reason(out) == StopReason.TIMED_OUT
        assert not bool(out.converged()) and bool(out.succeeded())

    def test_nan_in_residuals(self):
        x, out = to.optimize(jnp.asarray(1.0),
                             lambda x: jnp.full((2,), jnp.nan) * x)
        assert _reason(out) == StopReason.SYSTEM_HAS_NAN_OR_INF
        assert not bool(out.succeeded())

    def test_inf_cost(self):
        x, out = to.optimize(jnp.asarray(1.0),
                             lambda x: jnp.asarray(jnp.inf) * x)
        assert _reason(out) == StopReason.SYSTEM_HAS_NAN_OR_INF

    def test_nan_in_manual_grad(self):
        """NaN injected through a manual acc (basic.cpp:158-218)."""
        def acc(x):
            c = jnp.sum(x * x)
            g = jnp.full((2,), jnp.nan)
            H = jnp.eye(2)
            return c, g, H

        x, out = to.optimize(jnp.array([1.0, 1.0]), acc, mode="acc")
        assert _reason(out) == StopReason.SYSTEM_HAS_NAN_OR_INF

    def test_forgotten_hessian_min_diag(self):
        """Zero H + check_min_H_diag → SOLVER_FAILED (basic.cpp:219-233)."""
        def acc(x):
            return jnp.sum(x * x), 2.0 * x, jnp.zeros((2, 2))

        x, out = to.optimize(
            jnp.array([1.0, 1.0]), acc, mode="acc",
            options=to.Options(
                hessian=to.HessianOptions(check_min_H_diag=1e-8)))
        assert _reason(out) == StopReason.SOLVER_FAILED
        assert not bool(out.succeeded())

    def test_empty_x_skipped(self):
        """Empty parameters → SKIPPED (basic.cpp:234-258)."""
        x, out = to.optimize(jnp.zeros((0,)), lambda x: x)
        assert _reason(out) == StopReason.SKIPPED
        assert not bool(out.succeeded())

    def test_empty_residuals_skipped(self):
        x, out = to.optimize(jnp.asarray(1.0), lambda x: jnp.zeros((0,)))
        assert _reason(out) == StopReason.SKIPPED

    def test_out_of_memory(self):
        """100k-dim dense Hessian (80 GB) → OUT_OF_MEMORY, not a crash
        (basic.cpp:259-281)."""
        x, out = to.optimize(jnp.zeros(100_000), lambda p: p - 1.0)
        assert _reason(out) == StopReason.OUT_OF_MEMORY
        assert not bool(out.succeeded())


class TestHistoryInvariants:
    """History sizes and contents (basic.cpp:22-37)."""

    def test_history_prefix(self):
        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0)
        n = int(out.num_hist)
        assert 0 < n <= int(out.num_iters)
        errs = out.errs_list
        assert len(errs) == n
        assert all(np.isfinite(errs))
        # Costs decrease monotonically on this convex problem
        assert all(b <= a for a, b in zip(errs, errs[1:]))
        assert len(out.deltas2_list) == n
        assert len(out.successes_list) == n
        assert out.successes_list[-1]

    def test_final_cost_matches_history(self):
        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0)
        assert float(out.final_cost.cost) == pytest.approx(
            out.errs_list[-1], rel=1e-12)


class TestFailureBudgets:
    def test_max_total_failures(self):
        """A cost that increases after the first step exhausts the budget
        (optimizer.h:450-459 semantics)."""
        def acc(x):
            # cost grows with iteration count via x moving: make H identity,
            # gradient pointing away so every step is rejected
            return jnp.sum(x * x) + 1.0, -2.0 * x, jnp.eye(1)

        x, out = to.optimize(jnp.ones((1,)) * 2.0, acc, mode="acc",
                             options=to.Options(max_total_failures=1,
                                                min_error=0, min_rerr_dec=0,
                                                min_step_norm2=0,
                                                min_grad_norm2=0))
        assert _reason(out) in (StopReason.MAX_NO_DECR,
                                StopReason.MAX_CONSEC_NO_DECR)

    def test_max_consec_failures_exhausted(self):
        def acc(x):
            return jnp.sum(x * x) + 1.0, -2.0 * x, jnp.eye(1)

        x, out = to.optimize(jnp.ones((1,)) * 2.0, acc, mode="acc",
                             options=to.Options(max_consec_failures=3,
                                                min_error=0, min_rerr_dec=0,
                                                min_step_norm2=0,
                                                min_grad_norm2=0))
        assert _reason(out) == StopReason.MAX_CONSEC_NO_DECR
        assert int(out.num_consec_failures) >= 3

    def test_recovery_via_lambda_escalation(self):
        """max_consec_failures=0 (unlimited) recovers on a hard start."""
        x, out = to.optimize(jnp.asarray(0.5), lambda x: x * x - 2.0,
                             to.Options(max_consec_failures=0))
        assert float(x) == pytest.approx(np.sqrt(2), abs=1e-5)


class TestOutputExtras:
    def test_stop_reason_description(self):
        _, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0)
        s = out.stop_reason_description()
        assert "error" in s.lower() or "ε" in s

    def test_final_hessian_saved_and_undamped(self):
        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0)
        H = out.final_hessian
        assert H is not None and H.shape == (1, 1)
        # H = (2x)² at the solution ≈ 8, un-damped (lm.h:157-171 contract)
        assert float(H[0, 0]) == pytest.approx(8.0, rel=1e-4)

    def test_save_last_disabled(self):
        x, out = to.optimize(
            jnp.asarray(1.0), lambda x: x * x - 2.0,
            to.Options(hessian=to.HessianOptions(save_last=False)))
        assert out.final_hessian is None

    def test_covariance_rescaled(self):
        residual = lambda x: jnp.array([x[0] - 1.0, x[0] - 1.2, x[0] - 0.8])
        x, out = to.optimize(jnp.zeros((1,)), residual)
        cov = out.covariance(rescaled=True)
        # H = 3, cost = 0.08, n-d = 2 → cov = (1/3)·(0.08²/2)
        assert cov.shape == (1, 1)
        assert float(cov[0, 0]) == pytest.approx(
            (0.08 ** 2 / 2.0) / 3.0, rel=1e-3)


class TestCheckFinalCost:
    def test_final_cost_reflects_last_accepted_point(self):
        """check_final_cost adds one evaluation-only iteration and the
        reported final cost is of the returned x (optimizer.h:250,279)."""
        x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                             to.Options(max_iters=6, min_error=0,
                                        min_rerr_dec=0, min_step_norm2=0,
                                        min_grad_norm2=0,
                                        check_final_cost=True))
        r = float(x) ** 2 - 2.0
        assert float(out.final_cost.cost) == pytest.approx(r * r, rel=1e-6)
        assert int(out.num_iters) <= 6 + 2

    def test_identical_result_with_and_without(self):
        xa, _ = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                            to.Options(check_final_cost=True))
        xb, _ = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0,
                            to.Options(check_final_cost=False))
        assert float(xa) == pytest.approx(float(xb), rel=1e-12)


class TestGradClipping:
    def test_gd_step_uses_clipped_gradient(self):
        """One GD step with grad_clipping=1: |dx| = lr·1 exactly."""
        def acc(x):
            return jnp.sum(x * x), jnp.full((1,), 1e6)

        lr = 0.5
        x, out = to.optimize(
            jnp.ones((1,)), acc, mode="acc",
            options=to.Options(solver_type=to.GradientDescent,
                               max_iters=1, min_error=0, min_rerr_dec=0,
                               min_step_norm2=0, min_grad_norm2=0,
                               grad_clipping=1.0, gd=to.GDOptions(lr=lr)))
        assert float(out.deltas2_list[0]) == pytest.approx(lr ** 2, rel=1e-6)


class TestVmapConsistency:
    def test_vmapped_lane_matches_unbatched(self):
        """Regression: under XLA excess-precision fusion, (err − best) can
        be ±1 ulp even for bit-identical values, and the MIN_REL_ERROR
        knife-edge at the rollback evaluation falsely fired under vmap.
        A batch-of-one must follow the identical trajectory."""
        s = jnp.asarray(0.5342465753424658)
        solve = to.optimize  # noqa - use build_solver for raw control
        solver = to.build_solver(lambda x: x * x - 2.0,
                                 to.Options(max_consec_failures=0),
                                 "residuals", s)
        import jax as _jax
        x1, o1 = _jax.jit(solver)(s)
        xs, os_ = _jax.jit(_jax.vmap(solver))(s[None])
        assert float(xs[0]) == float(x1)
        assert int(os_.num_iters[0]) == int(o1.num_iters)
        assert int(os_.stop_reason[0]) == int(o1.stop_reason)

    def test_dense_start_sweep_all_converge(self):
        starts = jnp.linspace(0.5, 4.0, 256)
        solver = to.build_solver(lambda x: x * x - 2.0,
                                 to.Options(max_consec_failures=0),
                                 "residuals", starts[0])
        xs, outs = jax.jit(jax.vmap(solver))(starts)
        assert bool(jnp.all(outs.converged()))
        assert float(jnp.max(jnp.abs(xs - np.sqrt(2.0)))) < 1e-5


class TestFloat32:
    """f32 is the accelerator's working dtype (SURVEY.md §7 precision
    hard part);
    solves must converge to f32-appropriate tolerances."""

    def test_sqrt2_f32(self):
        x, out = to.optimize(jnp.float32(1.0), lambda x: x * x - 2.0)
        assert x.dtype == jnp.float32
        assert float(x) == pytest.approx(np.sqrt(2), abs=1e-5)
        assert bool(out.succeeded())

    def test_prior_f32(self):
        y = jnp.asarray(np.linspace(-1, 1, 12), jnp.float32)
        x, out = to.optimize(jnp.zeros(12, jnp.float32), lambda p: p - y)
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-5)

    def test_se3_f32(self):
        from tinyopt_tpu.manifolds import SE3
        prior_inv = SE3.exp(jnp.asarray(np.linspace(-0.3, 0.3, 6),
                                        jnp.float32))
        pose, out = to.optimize(SE3.identity(jnp.float32),
                                lambda T: (prior_inv @ T).log())
        assert float(jnp.linalg.norm((pose @ prior_inv).log())) < 1e-4


class TestCostScaling:
    def test_normalize_and_downscale(self):
        res = lambda x: jnp.stack([x[0] - 1.0, x[0] - 1.0])
        _, out_plain = to.optimize(jnp.zeros((1,)), res, to.Options(
            max_iters=1, min_error=0, min_rerr_dec=0, min_step_norm2=0,
            min_grad_norm2=0))
        _, out_scaled = to.optimize(jnp.zeros((1,)), res, to.Options(
            max_iters=1, min_error=0, min_rerr_dec=0, min_step_norm2=0,
            min_grad_norm2=0,
            cost=to.CostScalingOptions(downscale_by_2=True, normalize=True)))
        # cost 2.0 → ×0.5 ÷2 = 0.5
        assert float(out_scaled.errs_list[0]) == pytest.approx(
            float(out_plain.errs_list[0]) / 4.0)

    def test_sqrt_norm(self):
        res = lambda x: jnp.stack([x[0] - 3.0])
        _, out = to.optimize(jnp.zeros((1,)), res, to.Options(
            max_iters=1, min_error=0, min_rerr_dec=0, min_step_norm2=0,
            min_grad_norm2=0,
            cost=to.CostScalingOptions(use_squared_norm=False)))
        assert float(out.errs_list[0]) == pytest.approx(3.0, rel=1e-6)


class TestCheckFinalCostEvalOnly:
    def test_cfc_extra_iteration_is_evaluate_only(self):
        """check_final_cost's extra iteration must run the cost-only
        evaluate branch, not a full accumulation (regression: the
        eval_only flag was set one iteration too late, so the branch was
        dead — the check paid a full Jacobian build and, in carry mode,
        overwrote the saved H with the possibly-rejected check point's
        system)."""
        from tinyopt_tpu.optimize import _build_system
        from tinyopt_tpu.optimizers.loop import optimize_from_acc

        counts = {"acc": 0, "ev": 0}
        res = lambda x: x * x - jnp.arange(2.0, 5.0)
        x0 = jnp.ones(3)
        acc0, ev0, _n, spec, _ndu, _mode = _build_system(
            res, to.Options(), "auto", x0)

        def acc(x):
            jax.debug.callback(
                lambda: counts.__setitem__("acc", counts["acc"] + 1))
            return acc0(x)

        def ev(x):
            jax.debug.callback(
                lambda: counts.__setitem__("ev", counts["ev"] + 1))
            return ev0(x)

        o = to.Options(max_iters=3, check_final_cost=True, min_error=0.0,
                       min_rerr_dec=0.0, min_step_norm2=0.0,
                       min_grad_norm2=0.0, max_consec_failures=0)
        _, out = optimize_from_acc(x0, acc, ev, o, spec)
        jax.effects_barrier()
        assert int(out.num_iters) == 5          # 3 + rollback + check
        assert counts["ev"] >= 1                # the check was eval-only
        assert counts["acc"] == 4               # not 5


class TestOptionsForDtype:
    def test_f32_thresholds_classify_convergence(self):
        """The reference's stop thresholds are f64-calibrated; in f32 a
        coupled problem reaches machine-precision cost but budget-stops
        (|dx|² floors above min_step_norm2).  Options.for_dtype scales
        the thresholds by the FloatEpsilon ratio so the same solve stops
        via a convergence criterion."""
        d = 50
        y = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, d),
                        jnp.float32)

        def banded(x):
            return jnp.concatenate(
                [x[:-1] + 0.5 * x[1:] - y[:-1], x[-1:] - y[-1:]])

        x0 = jnp.asarray(np.random.default_rng(1).uniform(-1, 1, d),
                         jnp.float32)
        base = to.Options(max_iters=20, min_error=0.0,
                          min_rerr_dec=1e-12, min_step_norm2=1e-16,
                          max_consec_failures=3)
        _, out_raw = to.optimize(x0, banded, base)
        _, out_scaled = to.optimize(x0, banded,
                                    base.for_dtype(jnp.float32))
        assert not bool(out_raw.converged())       # budget stop
        assert bool(out_raw.succeeded())
        assert bool(out_scaled.converged())        # criterion stop
        assert float(out_scaled.final_cost.cost) < 1e-10

    def test_f64_unchanged(self):
        o = to.Options()
        assert o.for_dtype(jnp.float64) is o
