"""End-to-end convergence: easy suite.

Mirror of reference tests/optimize_easy.cpp:35-221 — Rosenbrock, Easom
(plateau), Powell-singular — each with a manual full-Hessian accumulation
path AND the AD residual path, converging to the reference's targets
within its margins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu.diff import check_gradient
from tinyopt_tpu.models.problems import (
    easom_cost, powell_singular_residuals, rosenbrock_cost,
    rosenbrock_residuals)


class TestRosenbrock:
    def test_ad_residual_path(self):
        x, out = to.optimize(jnp.array([-1.2, 1.0]), rosenbrock_residuals,
                             to.Options(max_iters=100))
        assert bool(out.succeeded()) and bool(out.converged())
        assert float(x[0]) == pytest.approx(1.0, abs=1e-5)
        assert float(x[1]) == pytest.approx(1.0, abs=1e-5)

    def test_manual_full_hessian_acc(self):
        """Analytic grad + full Hessian, the reference's formulation
        (optimize_easy.cpp:40-75)."""
        def acc(v):
            a, b = 1.0, 100.0
            t1 = a - v[0]
            t2 = v[1] - v[0] * v[0]
            cost = t1 * t1 + b * t2 * t2
            g = jnp.stack([-2.0 * t1 - 4.0 * b * v[0] * t2, 2.0 * b * t2])
            H = jnp.array([
                [2.0 - 4.0 * 100.0 * (v[1] - 3.0 * v[0] ** 2), -400.0 * v[0]],
                [-400.0 * v[0], 200.0],
            ])
            return cost, g, H

        assert check_gradient(jnp.array([-1.2, 1.0]), acc, 1e-5).ok
        # Reference options (optimize_easy.cpp:64-71): the indefinite full
        # Hessian needs a deep λ-escalation budget.
        x, out = to.optimize(jnp.array([-1.2, 1.0]), acc, mode="acc",
                             options=to.Options(max_iters=200,
                                                min_rerr_dec=0,
                                                max_consec_failures=20))
        assert bool(out.succeeded())
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=1e-5)

    def test_gd_on_cost(self):
        x, out = to.optimize(
            jnp.array([0.8, 0.8]), rosenbrock_cost,
            to.Options(solver_type=to.GradientDescent, max_iters=20000,
                       min_grad_norm2=1e-16, gd=to.GDOptions(lr=2e-3)))
        np.testing.assert_allclose(np.asarray(x), [1.0, 1.0], atol=1e-2)


class TestEasom:
    def test_converges_to_pi_from_near_dip(self):
        """Start (3,3) close to the dip (optimize_easy.cpp:90-143)."""
        def acc(v):
            pi = jnp.pi
            c = easom_cost(v)
            g = jax.grad(easom_cost)(v)
            H = jax.hessian(easom_cost)(v)
            return c, g, H

        x, out = to.optimize(jnp.array([3.0, 3.0]), acc, mode="acc",
                             options=to.Options(max_iters=100))
        assert bool(out.succeeded())
        assert float(x[0]) == pytest.approx(np.pi, abs=1e-4)
        assert float(x[1]) == pytest.approx(np.pi, abs=1e-4)


class TestPowellSingular:
    def test_converges_to_zero(self):
        """Singular Hessian at the optimum (optimize_easy.cpp:155-221)."""
        x, out = to.optimize(jnp.array([3.0, -1.0, 0.0, 1.0]),
                             powell_singular_residuals,
                             to.Options(max_iters=200))
        assert bool(out.succeeded())
        assert bool(jnp.all(jnp.abs(x) < 1e-3))

    def test_gradient_check(self):
        res = check_gradient(
            jnp.array([3.0, -1.0, 0.0, 1.0]),
            lambda v: (jnp.sum(powell_singular_residuals(v) ** 2),
                       2.0 * jax.jacfwd(powell_singular_residuals)(v).T
                       @ powell_singular_residuals(v)),
            1e-4)
        assert res.ok, res


class TestGenerateStarts:
    """Catch2 GENERATE analogue: sqrt2 across start points — batched
    through vmap instead of a loop, the batched pattern."""

    def test_sqrt2_multi_start_vmapped(self):
        starts = jnp.array([0.9, 1.0, 2.0, 4.0])
        solve = to.build_solver(lambda x: x * x - 2.0, to.Options(),
                                "residuals", starts[0])
        xs, outs = jax.jit(jax.vmap(solve))(starts)
        np.testing.assert_allclose(np.asarray(xs), np.sqrt(2.0), atol=1e-6)
        assert bool(jnp.all(outs.converged()))
