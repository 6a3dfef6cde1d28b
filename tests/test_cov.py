"""Covariance recovery.

Mirror of reference tests/cov.cpp:20-170: after optimizing a whitened
Gaussian prior, the posterior covariance (H⁻¹ of the final Hessian) must
equal the prior covariance — in all formulations: manual acc vs AD, ×
stdev-whitening vs full-covariance whitening vs information-matrix
whitening.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu.losses import mahalanobis


Y = jnp.array([1.0, -2.0, 0.5])
STDEVS = jnp.array([0.5, 1.5, 2.0])
COV = jnp.array([[2.0, 0.3, 0.1],
                 [0.3, 1.5, 0.2],
                 [0.1, 0.2, 1.0]])


def _solve_and_cov(fn, mode="auto"):
    x, out = to.optimize(jnp.zeros(3), fn, mode=mode)
    assert bool(out.succeeded()) and bool(out.converged())
    assert out.final_hessian is not None
    return x, out.covariance()


class TestStdevWhitening:
    def test_ad_path(self):
        x, C = _solve_and_cov(lambda x: (x - Y) / STDEVS)
        np.testing.assert_allclose(np.sqrt(np.diag(np.asarray(C))),
                                   np.asarray(STDEVS), atol=1e-7)

    def test_manual_acc_path(self):
        def acc(x):
            r = (x - Y) / STDEVS
            J = jnp.diag(1.0 / STDEVS)
            return (jnp.vdot(r, r), 3), J.T @ r, J.T @ J

        x, C = _solve_and_cov(acc, mode="acc")
        np.testing.assert_allclose(np.sqrt(np.diag(np.asarray(C))),
                                   np.asarray(STDEVS), atol=1e-7)


class TestFullCovWhitening:
    def test_ad_path(self):
        x, C = _solve_and_cov(
            lambda x: mahalanobis.maha_whitened(x - Y, COV))
        np.testing.assert_allclose(np.asarray(C), np.asarray(COV),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(x), np.asarray(Y), atol=1e-6)

    def test_manual_acc_path(self):
        def acc(x):
            r, J = mahalanobis.maha_whitened_with_jac(x - Y, COV)
            return (jnp.vdot(r, r), 3), J.T @ r, J.T @ J

        x, C = _solve_and_cov(acc, mode="acc")
        np.testing.assert_allclose(np.asarray(C), np.asarray(COV),
                                   atol=1e-5)


class TestInfoMatrixWhitening:
    def test_ad_path(self):
        """Upper info factor U with UᵀU = Σ⁻¹ → posterior == Σ."""
        inv_cov = jnp.linalg.inv(COV)
        # UᵀU = Σ⁻¹ with U upper: U = chol(Σ⁻¹) transposed appropriately
        L = jnp.linalg.cholesky(inv_cov)          # L Lᵀ = Σ⁻¹
        U = L.T                                   # UᵀU = L Lᵀ = Σ⁻¹
        x, C = _solve_and_cov(
            lambda x: mahalanobis.maha_whitened_info_u(x - Y, U))
        np.testing.assert_allclose(np.asarray(C), np.asarray(COV),
                                   atol=1e-5)


class TestRescaledCovariance:
    """The overdetermined-rescale branch — the sixth formulation of
    reference tests/cov.cpp; formula pinned to output.h:80-93:
    cov × final_cost²/(num_residuals − dims) when n > dims."""

    def test_overdetermined_rescale(self):
        # 2 stacked noisy priors: n=6 residuals > d=3 dims, and the two
        # targets disagree so final_cost > 0 at the minimizer.
        Y2 = Y + jnp.array([0.2, -0.1, 0.3])

        def fn(x):
            return jnp.concatenate([(x - Y) / STDEVS, (x - Y2) / STDEVS])

        x, out = to.optimize(jnp.zeros(3), fn)
        assert bool(out.converged())
        C = out.covariance()
        Cr = out.covariance(rescaled=True)
        c = float(out.final_cost.cost)
        n = int(out.final_cost.num_residuals)
        assert n == 6 and c > 0
        np.testing.assert_allclose(np.asarray(Cr),
                                   np.asarray(C) * (c * c / (n - 3)),
                                   rtol=1e-12)
        # un-rescaled posterior of the stacked prior is Σ/2 (two
        # independent measurements): σ_post = σ/√2
        np.testing.assert_allclose(np.sqrt(np.diag(np.asarray(C))),
                                   np.asarray(STDEVS) / np.sqrt(2.0),
                                   atol=1e-7)

    def test_determined_system_is_noop(self):
        """n == dims: rescaled must return the plain covariance
        (output.h:87 guards on num_residuals > cols)."""
        x, out = to.optimize(jnp.zeros(3), lambda x: (x - Y) / STDEVS)
        C = out.covariance()
        Cr = out.covariance(rescaled=True)
        np.testing.assert_array_equal(np.asarray(C), np.asarray(Cr))


class TestMaxStdDev:
    def test_matches_covariance(self):
        from tinyopt_tpu.ops.linalg import max_std_dev
        x, out = to.optimize(jnp.zeros(3), lambda x: (x - Y) / STDEVS)
        assert float(max_std_dev(out.final_hessian)) == pytest.approx(
            float(jnp.max(STDEVS)), rel=1e-6)


class TestCovarianceAt:
    """Post-hoc covariance for H-less solve paths (save_last=False /
    matfree)."""

    def test_matches_saved_hessian_covariance(self):
        import numpy as np
        y = jnp.asarray([0.3, -0.7, 1.1])
        inv_std = jnp.asarray([2.0, 1.0, 0.5])
        fn = lambda x: (x - y) * inv_std
        x, out = to.optimize(jnp.zeros(3), fn,
                             to.Options(hessian=to.HessianOptions(
                                 save_last=True)))
        ref = out.covariance()
        post = to.covariance_at(fn, x)
        np.testing.assert_allclose(np.asarray(post), np.asarray(ref),
                                   rtol=1e-9)
        # rescaled variant agrees too (overdetermined via repeats)
        fn2 = lambda x: jnp.concatenate([fn(x), fn(x) * 0.5 + 0.01])
        x2, out2 = to.optimize(jnp.zeros(3), fn2,
                               to.Options(hessian=to.HessianOptions(
                                   save_last=True)))
        np.testing.assert_allclose(
            np.asarray(to.covariance_at(fn2, x2, rescaled=True)),
            np.asarray(out2.covariance(rescaled=True)), rtol=1e-6)

    def test_batched_via_vmap(self):
        import jax
        import numpy as np
        from tinyopt_tpu.models.problems import (make_prior_batch,
                                                 prior_residual)
        data, x0 = make_prior_batch(6, 4, seed=2)
        from tinyopt_tpu.parallel import batched_optimize
        x, out = batched_optimize(x0, prior_residual, to.Options(
            hessian=to.HessianOptions(save_last=False)), data_batch=data)
        covs = jax.vmap(lambda xi, yi, si: to.covariance_at(
            lambda xv: (xv - yi) * si, xi))(x, data.y, data.inv_std)
        # whitened prior: covariance = diag(std^2)
        np.testing.assert_allclose(
            np.asarray(covs),
            np.asarray(jax.vmap(jnp.diag)(1.0 / data.inv_std ** 2)),
            rtol=1e-6, atol=1e-12)

    def test_first_order_rejected(self):
        with pytest.raises(ValueError, match="first-order"):
            to.covariance_at(lambda x: x, jnp.zeros(2),
                             to.Options(solver_type=to.GradientDescent))
