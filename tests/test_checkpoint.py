"""Checkpoint / resume (tinyopt_tpu.checkpoint).

No reference counterpart (SURVEY.md §5.4: the reference's solves are
µs-scale and have no checkpointing); the contract tested here is EXACT
continuation: N segments of k iterations — with an orbax save/load round
trip in the middle — follow the identical trajectory to one unchunked
solve of the same total iteration count.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu import checkpoint as ck
from tinyopt_tpu.models.problems import rosenbrock_residuals

x0 = jnp.array([-1.2, 1.0])


class TestSegmentSolver:
    def test_disk_round_trip_is_invisible(self, tmp_path):
        """Segments with an orbax save/load in the middle are bit-identical
        to segments without it."""
        opts = to.Options(max_consec_failures=0)
        solver = ck.segment_solver(rosenbrock_residuals, opts, x0,
                                   iters_per_segment=10)

        def run3(with_disk):
            x, out, st = solver.start(x0)
            if with_disk:
                p = os.path.join(str(tmp_path), "ck")
                ck.save_state(p, st)
                st = ck.load_state(p, solver.abstract_state())
            x, out, st = solver.resume(st)
            x, out, st = solver.resume(st)
            return x, out, st

        xa, outa, sta = run3(True)
        xb, outb, stb = run3(False)
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))
        np.testing.assert_array_equal(np.asarray(sta.best_x),
                                      np.asarray(stb.best_x))
        assert float(outa.final_cost.cost) == float(outb.final_cost.cost)

    def test_run_matches_unchunked(self):
        """run() == one unchunked solve with the same total budget: the
        driver's host-side final evaluation reproduces the unchunked
        loop's gated final iteration exactly."""
        opts = to.Options(max_iters=29, max_consec_failures=0)
        x_ref, out_ref = to.optimize(x0, rosenbrock_residuals, opts)
        solver = ck.segment_solver(rosenbrock_residuals, opts, x0,
                                   iters_per_segment=10)
        x, out, _ = solver.run(x0)
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                                   rtol=0, atol=0)
        assert float(out.final_cost.cost) == float(out_ref.final_cost.cost)

    def test_run_until_convergence(self):
        solver = ck.segment_solver(
            lambda x: x * x - 2.0, to.Options(), jnp.array(1.0),
            iters_per_segment=2)
        x, out, _ = solver.run(jnp.array(1.0))
        assert bool(out.converged())
        assert abs(float(x) - 2 ** 0.5) < 1e-7

    def test_first_order_state_survives(self, tmp_path):
        """Adam moment estimates live in the segment state: resumed
        segments continue the same momentum trajectory."""
        opts = to.Options(solver_type=to.Adam, max_consec_failures=0,
                          adam=to.AdamOptions(lr=0.1))
        cost = lambda x: jnp.sum((x - 1.0) ** 2)
        x_ref, out_ref = to.optimize(
            jnp.array([3.0, -2.0]), cost,
            opts.replace(max_iters=19), mode="cost")

        solver = ck.segment_solver(cost, opts.replace(max_iters=19),
                                   jnp.array([3.0, -2.0]),
                                   mode="cost", iters_per_segment=5)
        x, out, st = solver.start(jnp.array([3.0, -2.0]))
        p = os.path.join(str(tmp_path), "ck")
        ck.save_state(p, st)
        st = ck.load_state(p, solver.abstract_state())
        for _ in range(3):                   # 20 iterations total
            x, out, st = solver.resume(st)
        # non-terminal exit: the unchunked loop's gated final apply makes
        # its x the best accepted point, which the segments track exactly
        np.testing.assert_allclose(np.asarray(st.best_x),
                                   np.asarray(x_ref), rtol=0, atol=0)

    def test_run_honors_total_budget(self):
        """run() stops at the ORIGINAL options' max_iters (+1 rollback
        slot) even when no stop criterion ever fires (regression: it
        looped as long as segments returned MAX_ITERS)."""
        opts = to.Options(solver_type=to.GradientDescent, max_iters=12,
                          min_error=0.0, min_rerr_dec=0.0,
                          min_step_norm2=0.0, min_grad_norm2=0.0,
                          max_consec_failures=0,
                          gd=to.GDOptions(lr=1e-6))
        solver = ck.segment_solver(lambda x: jnp.sum(x * x), opts,
                                   jnp.array([1.0]), mode="cost",
                                   iters_per_segment=5)
        x, out, _ = solver.run(jnp.array([1.0]))
        # EXACT budget: 12 + 1 iterations — the last segment is a
        # compiled tail sized to the remainder (no overshoot to a
        # segment multiple)
        assert int(out.num_iters) == 13

    def test_run_honors_budget_on_first_segment(self):
        """The FIRST segment is budget-sized too: with max_iters +
        allowances < iters_per_segment, run() must not execute a full
        iters_per_segment segment (ADVICE r1: the unsized start ran 10
        iterations for a 3-iteration budget)."""
        opts = to.Options(solver_type=to.GradientDescent, max_iters=3,
                          min_error=0.0, min_rerr_dec=0.0,
                          min_step_norm2=0.0, min_grad_norm2=0.0,
                          max_consec_failures=0,
                          gd=to.GDOptions(lr=1e-6))
        solver = ck.segment_solver(lambda x: jnp.sum(x * x), opts,
                                   jnp.array([1.0]), mode="cost",
                                   iters_per_segment=10)
        x, out, _ = solver.run(jnp.array([1.0]))
        assert int(out.num_iters) == 4  # max_iters + 1 rollback slot

    def test_run_aggregates_history(self):
        opts = to.Options(max_iters=29, max_consec_failures=0)
        solver = ck.segment_solver(rosenbrock_residuals, opts, x0,
                                   iters_per_segment=10)
        x, out, _ = solver.run(x0)
        assert int(out.num_iters) == int(out.num_hist) == len(out.errs_list)
        assert int(out.num_iters) > 10  # spans multiple segments

    def test_check_final_cost_fallback(self):
        """check_final_cost falls back to best_x when the final point
        regressed (options.h:43 semantics, as in the timeout driver)."""
        opts = to.Options(check_final_cost=True, max_iters=20,
                          max_consec_failures=0)
        solver = ck.segment_solver(rosenbrock_residuals, opts, x0,
                                   iters_per_segment=7)
        x, out, st = solver.run(x0)
        import tinyopt_tpu.diff.auto as da
        r = da.flatten_residuals(rosenbrock_residuals(x))
        assert float(jnp.vdot(r, r)) <= float(out.final_cost.cost) + 1e-12

    def test_requires_x_example(self):
        with pytest.raises(ValueError, match="x_example"):
            ck.segment_solver(lambda x: x, to.Options())


class TestStepper:
    """Public imperative Step() API (reference optimizer.h:332)."""

    def test_step_by_step_matches_optimize(self):
        """N step() calls follow the identical trajectory to one
        optimize(max_iters=N) call (modulo the gated final apply, which
        best_x reproduces)."""
        N = 25
        opts = to.Options(max_iters=N, max_consec_failures=0)
        x_ref, out_ref = to.optimize(x0, rosenbrock_residuals, opts)
        st_api = to.stepper(rosenbrock_residuals, opts, x_example=x0)
        x, out, state = st_api.step(x0)
        n = 1
        # +1: the unchunked loop grants a rollback slot (optimizer.h:249)
        while (int(out.stop_reason) in (int(to.StopReason.MAX_ITERS),
                                        int(to.StopReason.NONE))
               and n < N + 1):
            x, out, state = st_api.step(state=state)
            n += 1
        np.testing.assert_array_equal(np.asarray(st_api.best_x(state)),
                                      np.asarray(x_ref))
        assert float(out.final_cost.cost) == float(out_ref.final_cost.cost)

    def test_stop_reason_propagates(self):
        """A terminal stop reason (not MAX_ITERS) surfaces through step()."""
        opts = to.Options(min_error=1e-12)
        st_api = to.stepper(lambda x: x * x - 2.0, opts,
                            x_example=jnp.array(1.0))
        x, out, state = st_api.step(jnp.array(1.0))
        for _ in range(20):
            if int(out.stop_reason) != int(to.StopReason.MAX_ITERS):
                break
            x, out, state = st_api.step(state=state)
        assert int(out.stop_reason) == int(to.StopReason.MIN_ERROR)
        assert abs(float(st_api.best_x(state)) - 2.0 ** 0.5) < 1e-6

    def test_custom_outer_logic(self):
        """User-driven early stop on a custom criterion + evaluate()."""
        opts = to.Options(max_consec_failures=0)
        st_api = to.stepper(rosenbrock_residuals, opts, x_example=x0)
        x, out, state = st_api.step(x0)
        costs = [float(st_api.evaluate(st_api.best_x(state)))]
        for _ in range(80):
            x, out, state = st_api.step(state=state)
            costs.append(float(st_api.evaluate(st_api.best_x(state))))
            if costs[-1] < 1e-3:        # custom outer criterion
                break
        assert costs[-1] < 1e-3
        assert costs[-1] <= costs[0]

    def test_arg_validation(self):
        st_api = to.stepper(rosenbrock_residuals, to.Options(), x_example=x0)
        with pytest.raises(ValueError):
            st_api.step()
        _, _, state = st_api.step(x0)
        with pytest.raises(ValueError):
            st_api.step(x0, state=state)


class TestProfiling:
    """profile_iterations (profiling.py): per-iteration τ without host
    callbacks (on a backend that rejects callbacks, options.log.enable's
    τ is unavailable)."""

    def test_tau_per_iteration_and_trajectory_parity(self):
        import numpy as np
        rng = np.random.default_rng(0)
        y = jnp.asarray(rng.normal(size=6))
        fn = lambda x: x - y
        o = to.Options(max_iters=10)
        x, out, taus = to.profile_iterations(jnp.zeros(6), fn, o,
                                             perturb=0.0)
        x_ref, out_ref = to.optimize(jnp.zeros(6), fn, o)
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                                   atol=1e-15)
        assert int(out.num_iters) == int(out_ref.num_iters) == len(taus)
        assert int(out.stop_reason) == int(out_ref.stop_reason)
        assert (taus > 0).all()
        assert float(out.duration_ms) == pytest.approx(
            taus.sum() * 1e3, rel=1e-5)

    def test_perturbed_start_still_converges(self):
        import numpy as np
        y = jnp.asarray([1.0, -2.0, 0.5])
        x, out, taus = to.profile_iterations(
            jnp.zeros(3), lambda x: x - y, to.Options(max_iters=10),
            perturb=1e-6)
        assert bool(out.converged())
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   atol=1e-5)

    def test_dispatch_floor_positive(self):
        f = to.dispatch_floor()
        assert 0 < f < 1.0


class TestLogDropped:
    def test_flag_set_when_callbacks_unavailable(self, monkeypatch):
        import tinyopt_tpu.optimizers.loop as lp
        monkeypatch.setattr(lp, "_CB_OK", False)
        x, out = to.optimize(jnp.array(1.0), lambda x: x * x - 2.0,
                             to.Options(max_iters=7,
                                        log=to.LogOptions(enable=True)))
        assert out.log_dropped is True
        assert bool(out.converged())       # solve unaffected, only silent

    def test_flag_false_when_logging_off_or_supported(self, monkeypatch):
        x, out = to.optimize(jnp.array(1.0), lambda x: x * x - 2.0)
        assert out.log_dropped is False
        import tinyopt_tpu.optimizers.loop as lp
        monkeypatch.setattr(lp, "_CB_OK", False)
        x, out = to.optimize(jnp.array(1.0), lambda x: x * x - 2.0)
        assert out.log_dropped is False    # nothing requested -> no flag
