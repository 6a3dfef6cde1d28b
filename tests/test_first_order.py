"""First-order optimizer suite: SGD-momentum, Adam/AdamW, L-BFGS.

The reference ships only fixed-lr gradient descent (solvers/gd.h:131-134)
and lists these as roadmap work ("more optimizers: Adam, SGD, ... lbfgs",
reference README.md:152); here they run inside the same jitted loop as
GD/GN/LM and must honor the identical Output / stop-reason / validation
contracts (tests mirror the GD coverage in tests/unconstrained.cpp and
tests/solvers.cpp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to


def quad(x):
    return jnp.sum((x - 1.0) ** 2)


def rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


x0 = jnp.array([3.0, -2.0])


class TestSGD:
    def test_quadratic(self):
        x, out = to.sgd.optimize(
            x0, quad, to.Options(max_iters=200,
                                 sgd=to.SGDOptions(lr=0.05, momentum=0.9)))
        assert bool(out.succeeded())
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=0.15)

    def test_momentum_beats_plain_gd(self):
        """Same lr: momentum accelerates descent ~1/(1−µ)× (the textbook
        motivation), measured as final cost after equal iterations."""
        f = lambda x: jnp.sum(x * x)
        opts = to.Options(max_iters=100, max_consec_failures=0)
        _, out_gd = to.gd.optimize(jnp.array([1.0]), f,
                                   opts.replace(gd=to.GDOptions(lr=1e-3)))
        _, out_sgd = to.sgd.optimize(
            jnp.array([1.0]), f,
            opts.replace(sgd=to.SGDOptions(lr=1e-3, momentum=0.9)))
        assert float(out_sgd.final_cost.cost) < 0.1 * float(
            out_gd.final_cost.cost)

    def test_nesterov(self):
        x, out = to.sgd.optimize(
            x0, quad,
            to.Options(max_iters=400,
                       sgd=to.SGDOptions(lr=0.02, momentum=0.9,
                                         nesterov=True)))
        assert bool(out.succeeded())
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=0.15)

    def test_vector_residual_rejected(self):
        """First-order solvers demand a scalar cost (optimize.h:59-72)."""
        with pytest.raises(ValueError):
            to.sgd.optimize(jnp.ones(3), lambda x: x - 1.0)


class TestAdaptiveGD:
    """gd.adaptive="bb": Barzilai–Borwein two-point step size — the
    reference's own declared TODO (options.h:149-152 "adaptive learning
    rate"); Barzilai & Borwein 1988."""

    def _illcond(self, x):
        d = jnp.concatenate([jnp.ones(2), jnp.full((2,), 100.0)])
        return jnp.sum(d * x * x)

    def test_bb_beats_fixed_lr_on_illconditioned_quadratic(self):
        """BB adapts to the curvature spread; fixed lr is capped by the
        largest eigenvalue and crawls along the smallest."""
        x0 = jnp.array([1.0, -1.0, 1.0, -1.0])
        opts = to.Options(max_iters=100, max_consec_failures=0,
                          min_error=0.0)
        _, out_fix = to.gd.optimize(
            x0, self._illcond, opts.replace(gd=to.GDOptions(lr=1e-3)))
        _, out_bb = to.gd.optimize(
            x0, self._illcond,
            opts.replace(gd=to.GDOptions(lr=1e-3, adaptive="bb")))
        assert float(out_bb.final_cost.cost) < 1e-6 * float(
            out_fix.final_cost.cost), (float(out_bb.final_cost.cost),
                                       float(out_fix.final_cost.cost))

    def test_bb_converges_on_rosenbrock(self):
        """Non-convex: BB overshoots get rejected and backtracked by the
        shared backoff; fixed-lr GD at the same budget is nowhere near."""
        x, out = to.gd.optimize(
            jnp.array([-1.2, 1.0]), rosen,
            to.Options(max_iters=10000, max_consec_failures=0,
                       gd=to.GDOptions(lr=1e-3, adaptive="bb")))
        assert bool(out.converged())
        # ~6k iterations (the monotone accept/reject loop rejects BB's
        # non-monotone excursions); fixed-lr GD is at cost ~0.5 after 100k.
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=1e-3)

    def test_off_is_reference_fixed_lr(self):
        """adaptive="off" (default) proposes the identical fixed-lr
        iterates as before (reference gd.h:131-134 parity preserved)."""
        opts = to.Options(max_iters=50, max_consec_failures=0)
        x_a, out_a = to.gd.optimize(x0, quad, opts)
        x_b, out_b = to.gd.optimize(
            x0, quad, opts.replace(gd=to.GDOptions(lr=1e-3,
                                                   adaptive="off")))
        np.testing.assert_array_equal(np.asarray(x_a), np.asarray(x_b))
        assert int(out_a.num_iters) == int(out_b.num_iters)

    def test_unknown_adaptive_rejected(self):
        with pytest.raises(ValueError, match="adaptive"):
            to.gd.optimize(x0, quad,
                           to.Options(gd=to.GDOptions(adaptive="wolfe")))

    def test_vmap_batched_bb(self):
        """Per-instance lr state vmaps like the other stateful methods."""
        starts = jnp.stack([x0, x0 + 1.0, x0 - 2.0])
        solve = to.build_solver(
            quad, to.Options(max_iters=200, max_consec_failures=0,
                             gd=to.GDOptions(lr=1e-3, adaptive="bb"),
                             solver_type=to.GradientDescent),
            "cost", x0)
        xs, outs = jax.jit(jax.vmap(solve))(starts)
        np.testing.assert_allclose(np.asarray(xs), 1.0, atol=1e-4)


class TestAdam:
    def test_quadratic(self):
        x, out = to.adam.optimize(
            x0, quad, to.Options(max_iters=300,
                                 adam=to.AdamOptions(lr=0.1)))
        assert bool(out.succeeded())
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=0.02)

    def test_bounded_steps(self):
        """|dx| per iteration is bounded by ~lr — Adam's signature
        invariance to gradient scale."""
        opts = to.Options(max_iters=5, adam=to.AdamOptions(lr=0.01),
                          min_grad_norm2=0.0, min_step_norm2=0.0)
        x, out = to.adam.optimize(jnp.array([1e6]), lambda x: jnp.sum(x**2),
                                  opts)
        # max_iters+2 applied steps of at most ~lr each
        assert abs(float(x[0]) - 1e6) < 7 * 0.011

    def test_adamw_decay_pulls_toward_origin(self):
        """Decoupled decay: the AdamW fixed point of min (x-1)² sits
        strictly between 0 and the undecayed optimum 1."""
        xw, _ = to.adamw.optimize(
            jnp.array([3.0]), lambda x: jnp.sum((x - 1.0) ** 2),
            to.Options(max_iters=2000, max_consec_failures=0,
                       min_step_norm2=0.0, min_grad_norm2=0.0,
                       adam=to.AdamOptions(lr=0.05, weight_decay=1.0)))
        assert 0.0 < float(xw[0]) < 0.99

    def test_adamw_rejects_manifold_decay(self):
        from tinyopt_tpu.manifolds import SO3
        with pytest.raises(ValueError, match="Euclidean"):
            to.adamw.optimize(SO3.identity(jnp.float64),
                              lambda R: jnp.sum(R.log() ** 2))

    def test_adam_on_manifold(self):
        """Adam (no decay) works on manifold parameters — the state lives
        on the tangent space."""
        from tinyopt_tpu.manifolds import SO3
        target = SO3.exp(jnp.asarray([0.3, -0.1, 0.2]))
        R, out = to.adam.optimize(
            SO3.identity(jnp.float64),
            lambda R: jnp.sum((target.inverse() @ R).log() ** 2),
            to.Options(max_iters=500, max_consec_failures=10,
                       adam=to.AdamOptions(lr=0.02)))
        assert float(jnp.linalg.norm((target.inverse() @ R).log())) < 0.1


class TestLBFGS:
    def test_quadratic_exact(self):
        """On a quadratic, L-BFGS with one curvature pair takes Newton-like
        steps: convergence in a handful of iterations."""
        x, out = to.lbfgs.optimize(x0, quad)
        assert bool(out.converged())
        assert int(out.num_iters) <= 6
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=1e-8)

    def test_rosenbrock(self):
        x, out = to.lbfgs.optimize(
            jnp.array([-1.2, 1.0]), rosen,
            to.Options(max_iters=200, max_consec_failures=30))
        assert bool(out.succeeded())
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=1e-5)

    def test_beats_gd_on_rosenbrock(self):
        """The roadmap promise: a curvature-aware first-order method far
        outperforms plain GD on the banana function."""
        opts = to.Options(max_iters=200, max_consec_failures=30)
        x_l, out_l = to.lbfgs.optimize(jnp.array([-1.2, 1.0]), rosen, opts)
        x_g, _ = to.gd.optimize(jnp.array([-1.2, 1.0]), rosen,
                                to.Options(max_iters=200))
        assert float(rosen(x_l)) < 1e-8 < float(rosen(x_g))

    def test_memory_option(self):
        x, out = to.lbfgs.optimize(
            jnp.arange(6.0), lambda x: jnp.sum((x - 2.0) ** 2),
            to.Options(lbfgs=to.LBFGSOptions(memory=3)))
        assert bool(out.converged())
        np.testing.assert_allclose(np.asarray(x), np.full(6, 2.0),
                                   atol=1e-7)

    def test_high_dim(self):
        """100-dim separable quartic: L-BFGS converges where GD crawls."""
        def f(x):
            return jnp.sum((x - 1.0) ** 4 + 0.5 * (x - 1.0) ** 2)
        x, out = to.lbfgs.optimize(
            jnp.linspace(-2.0, 3.0, 100), f,
            to.Options(max_iters=300, max_consec_failures=30))
        assert bool(out.succeeded())
        np.testing.assert_allclose(np.asarray(x), np.ones(100), atol=1e-3)


class TestLoopContract:
    """The new solvers share the loop's Output / stop / history
    machinery (behavioral spec of tests/test_basic.py)."""

    @pytest.mark.parametrize("ns", ["sgd", "adam", "lbfgs"])
    def test_nan_routing(self, ns):
        _, out = getattr(to, ns).optimize(
            jnp.array([1.0]), lambda x: jnp.sum(x) * jnp.nan)
        assert out.stop_reason == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)

    @pytest.mark.parametrize("ns", ["sgd", "adam", "lbfgs"])
    def test_history_recorded(self, ns):
        _, out = getattr(to, ns).optimize(
            x0, quad, to.Options(max_iters=10, max_consec_failures=0))
        assert int(out.num_hist) > 0
        assert len(out.errs_list) == int(out.num_hist)

    def test_uphill_momentum_escapes(self):
        """Regression: a momentum/Adam direction that points uphill at
        the current point must not deadlock the solve (state frozen +
        identical re-proposal).  The state keeps integrating the current
        gradient across rejections until the direction turns downhill."""
        def mse(x):  # narrow curved valley: momentum overshoots turns
            return (x[0] - 1.0) ** 2 + 20.0 * (x[1] - x[0] ** 2) ** 2
        x, out = to.adam.optimize(
            jnp.array([-1.0, 1.0]), mse,
            to.Options(max_iters=800, max_consec_failures=0,
                       adam=to.AdamOptions(lr=0.2)))
        # progress far beyond any single deadlock point
        assert float(out.final_cost.cost) < 1e-2
        # and rejections did occur along the way (the scenario is real)
        assert int(out.num_failures) > 0

    def test_returned_x_carries_final_cost(self):
        """Regression: the returned x must be the point whose cost is
        final_cost — no unevaluated trailing proposal (stale-gradient
        L-BFGS steps made this visible; the reference always returns an
        evaluated point, optimizer.h:266-299)."""
        x, out = to.lbfgs.optimize(x0, quad)
        np.testing.assert_allclose(float(quad(x)),
                                   float(out.final_cost.cost), atol=1e-12)

    def test_rejected_steps_keep_best_monotone(self):
        """A huge-lr Adam run rejects most steps; rejected proposals are
        never applied to x, so the best cost stays monotone even though
        the optimizer state keeps learning from every evaluation."""
        x, out = to.adam.optimize(
            x0, quad, to.Options(max_iters=50, max_consec_failures=0,
                                 adam=to.AdamOptions(lr=2.5)))
        errs = np.asarray(out.errs_list)
        assert float(out.final_cost.cost) <= errs.min() + 1e-12

    @pytest.mark.parametrize("st", ["LBFGS", "Adam"])
    def test_vmap_batched(self, st):
        """First-order state vmaps: batched instances, per-instance
        momentum/memory (no reference counterpart)."""
        from tinyopt_tpu.optimize import build_solver
        opts = to.Options(solver_type=getattr(to, st), max_iters=400,
                          adam=to.AdamOptions(lr=0.1))
        solver = build_solver(lambda x: jnp.sum((x - 1.0) ** 2), opts,
                              "cost", jnp.zeros(3))
        rng = np.random.default_rng(0)
        x0b = jnp.asarray(rng.uniform(-3, 3, (8, 3)))
        xb, outb = jax.jit(jax.vmap(solver))(x0b)
        assert float(outb.succeeded().mean()) == 1.0
        tol = 1e-8 if st == "LBFGS" else 0.3
        assert float(jnp.abs(xb - 1.0).max()) < tol

    def test_warm_start_gradient(self):
        """InitWith-style warm start actually passes warm_start and must
        not degrade the trajectory (regression: L-BFGS paired the first
        build's gradient with the zeros-initialized g_prev, storing a
        corrupt secant pair y = g1 − 0 that made the cost oscillate)."""
        from tinyopt_tpu.optimize import build_solver
        g0 = jax.grad(quad)(x0)
        warm = build_solver(quad, to.Options(solver_type=to.LBFGS),
                            "cost", x0, warm_start=(g0,))
        cold = build_solver(quad, to.Options(solver_type=to.LBFGS),
                            "cost", x0)
        xw, outw = warm(x0)
        xc, outc = cold(x0)
        assert bool(outw.converged())
        np.testing.assert_allclose(np.asarray(xw), [1.0, 1.0], atol=1e-7)
        # warm start skips one accumulation; it must not cost extra
        # iterations
        assert int(outw.num_iters) <= int(outc.num_iters) + 1
        # monotone best cost (no oscillation back to the start value)
        errs = np.asarray(outw.errs_list)
        assert errs[-1] <= errs[0]
