"""Batched solves equal one-instance-at-a-time solves.

``parallel.batched_solver`` vmaps the whole LM loop: every instance keeps
its own λ schedule, stop reason, counters and history, and under vmap the
CG solves of all instances run as one call (ops/pallas_cg.make_cg_solver).
These tests solve the same instances one at a time with the un-vmapped
solver — ``hessian.solver="cg"``, ``carry_system=False`` — and require the
batched answers to match instance by instance, up to f32 summation
order: parameters, costs, success classes, iteration and failure counts,
histories.  The hand-written cases
pin specific behaviours; the fuzz cases sweep seeded random residual
programs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu.models.problems import (jennrich_sampson_residuals,
                                         make_prior_batch, prior_residual)
from tinyopt_tpu.optimize import build_solver
from tinyopt_tpu.parallel.batched import batched_optimize, batched_solver


def _opts(**kw):
    hk = dict(save_last=False, solver="cg", cg_iters=8, carry_system=False)
    hk.update(kw.pop("hessian", {}))
    kw.setdefault("max_iters", 10)
    kw.setdefault("min_error", 0.0)
    kw.setdefault("min_rerr_dec", 1e-12)
    kw.setdefault("min_step_norm2", 1e-16)
    kw.setdefault("max_consec_failures", 3)
    kw.setdefault("save_history", False)
    return to.Options(hessian=to.HessianOptions(**hk), **kw)


def _first(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _one_at_a_time(residual_fn, opts, x0, data=None):
    """Solve each instance alone with the un-vmapped solver (one jit,
    called once per instance) and stack the results."""
    n = jax.tree_util.tree_leaves(x0)[0].shape[0]
    pick = lambda tree, i: jax.tree_util.tree_map(lambda a: a[i], tree)
    if data is None:
        single = jax.jit(build_solver(residual_fn, opts, "residuals",
                                      _first(x0)))
        runs = [single(pick(x0, i)) for i in range(n)]
    else:
        def solve1(x, d):
            return build_solver(lambda x_: residual_fn(x_, d), opts,
                                "residuals", x)(x)
        single = jax.jit(solve1)
        runs = [single(pick(x0, i), pick(data, i)) for i in range(n)]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *runs)


def _run_both(residual_fn, opts, x0, data=None):
    """(batched result, one-at-a-time result)."""
    d_ex = None if data is None else _first(data)
    batched = jax.jit(batched_solver(residual_fn, opts, "residuals",
                                     _first(x0), d_ex))
    got = batched(x0) if data is None else batched(x0, data)
    return got, _one_at_a_time(residual_fn, opts, x0, data)


def _assert_parity(got, ref, rtol=1e-5, atol=1e-6, iter_slack=1,
                   fail_slack=0, grad_rtol=1e-4):
    """Batched and single solves agree up to f32 summation order (a
    vmapped contraction may sum in another order), so an iteration that
    crosses a stop threshold can shift by one; the success/convergence
    classification must match exactly."""
    (xb, outb), (xs, outs) = got, ref
    np.testing.assert_allclose(
        np.asarray(jax.tree_util.tree_leaves(xb)[0]),
        np.asarray(jax.tree_util.tree_leaves(xs)[0]), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(np.asarray(outb.succeeded()),
                                  np.asarray(outs.succeeded()))
    np.testing.assert_array_equal(np.asarray(outb.converged()),
                                  np.asarray(outs.converged()))
    assert int(jnp.max(jnp.abs(outb.num_iters - outs.num_iters))) \
        <= iter_slack
    assert int(jnp.max(jnp.abs(outb.num_failures - outs.num_failures))) \
        <= fail_slack
    np.testing.assert_allclose(outb.final_cost.cost, outs.final_cost.cost,
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(outb.final_grad, outs.final_grad,
                               rtol=grad_rtol, atol=1e-5)


def test_prior_batch_parity_lm():
    data, x0 = make_prior_batch(32, 7, dtype=jnp.float32, seed=3)
    got, ref = _run_both(prior_residual, _opts(), x0, data)
    _assert_parity(got, ref)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(data.y),
                               atol=1e-4)


def test_prior_batch_parity_gn():
    data, x0 = make_prior_batch(16, 5, dtype=jnp.float32, seed=5)
    _assert_parity(*_run_both(prior_residual,
                              _opts(solver_type=to.GaussNewton), x0, data))


def test_robust_whitened_parity():
    """Robust (Huber-whitened) residuals through the batched CG path."""
    from tinyopt_tpu.losses.robust_norms import huber, robust_whiten

    def robust_prior(x, data):
        r = (x - data.y) * data.inv_std
        return jax.vmap(lambda ri: robust_whiten(ri[None], huber, 0.5))(r)

    data, x0 = make_prior_batch(24, 6, dtype=jnp.float32, seed=11)
    _assert_parity(*_run_both(robust_prior, _opts(), x0, data))


def test_rejection_heavy_parity():
    # Jennrich-Sampson from aggressive starts: rejected steps, rollback,
    # probe re-steps and compounded λ escalation all get exercised.
    key = jax.random.PRNGKey(0)
    x0 = jax.random.uniform(key, (24, 2), jnp.float32, 0.1, 0.45)
    opts = _opts(max_iters=20, max_consec_failures=5)
    got, ref = _run_both(jennrich_sampson_residuals, opts, x0)
    # ill-conditioned: last-bit differences grow along the rejection
    # chain, so wider fp tolerances
    _assert_parity(got, ref, rtol=2e-3, atol=1e-3, iter_slack=2,
                   fail_slack=2, grad_rtol=2e-2)
    # the problem actually produced some rejections (test is meaningful)
    assert int(jnp.sum(ref[1].num_failures)) > 0


def test_dogleg_prior_parity():
    """Powell dogleg (solvers/step.dogleg_core on the CG dense path)."""
    data, x0 = make_prior_batch(16, 7, dtype=jnp.float32, seed=3)
    _assert_parity(*_run_both(prior_residual, _opts(solver_type=to.DogLeg),
                              x0, data))


def test_dogleg_coupled_parity():
    # Banded residuals: H is NOT diagonal, so the dogleg runs real CG
    # solves for both the GN step and the curvature matvec.
    def banded(x, y):
        return jnp.concatenate([x[:-1] + 0.5 * x[1:], x[-1:]]) - y

    y = jax.random.normal(jax.random.PRNGKey(0), (12, 6), jnp.float32)
    x0 = jnp.zeros((12, 6), jnp.float32)
    _assert_parity(*_run_both(banded, _opts(solver_type=to.DogLeg), x0, y),
                   rtol=1e-4, atol=1e-5)


def test_dogleg_singular_h_parity():
    # Jennrich-Sampson near its symmetric minimum: H is (near-)exactly
    # singular, the GN step is insane, and the κ-cap + Levenberg fallback
    # (the lax.cond-gated reg solve, a select under vmap) fire.
    x0 = jnp.tile(jnp.array([[0.3, 0.4]], jnp.float32), (8, 1)) + \
        0.01 * jax.random.normal(jax.random.PRNGKey(2), (8, 2), jnp.float32)
    opts = _opts(solver_type=to.DogLeg, max_iters=30)
    (xb, outb), (xs, outs) = _run_both(jennrich_sampson_residuals, opts, x0)
    np.testing.assert_array_equal(np.asarray(outb.stop_reason),
                                  np.asarray(outs.stop_reason))
    np.testing.assert_allclose(outb.final_cost.cost, outs.final_cost.cost,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(outb.num_iters),
                                  np.asarray(outs.num_iters))


def test_nan_routing_per_instance():
    data, x0 = make_prior_batch(8, 4, dtype=jnp.float32, seed=1)
    bad_inv = data.inv_std.at[3].set(jnp.nan)
    data = dataclasses.replace(data, inv_std=bad_inv) \
        if dataclasses.is_dataclass(data) else data._replace(inv_std=bad_inv)
    (xb, outb), (xs, outs) = _run_both(prior_residual, _opts(), x0, data)
    assert int(outb.stop_reason[3]) == \
        int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
    np.testing.assert_array_equal(np.asarray(outb.stop_reason),
                                  np.asarray(outs.stop_reason))
    # the healthy instances still converge, unharmed by the NaN one
    ok = np.delete(np.asarray(outb.stop_reason), 3)
    assert np.all(ok > 0)
    np.testing.assert_allclose(np.delete(np.asarray(xb), 3, axis=0),
                               np.delete(np.asarray(data.y), 3, axis=0),
                               atol=1e-4)


def test_no_data_problem_parity():
    # residual closed over constants, no per-instance data argument
    x0 = jnp.linspace(0.5, 3.0, 12, dtype=jnp.float32)[:, None]

    def res(x):
        return jnp.stack([x[0] * x[0] - 2.0, 0.5 * (x[0] - 1.0)])

    _assert_parity(*_run_both(res, _opts(), x0))


def test_pytree_params_roundtrip():
    key = jax.random.PRNGKey(2)
    x0 = {"a": jax.random.normal(key, (10, 3), jnp.float32),
          "b": jax.random.normal(key, (10, 2), jnp.float32)}

    def res(x, data):
        return jnp.concatenate([x["a"] - data["ta"],
                                2.0 * (x["b"] - data["tb"])])

    data = {"ta": jnp.ones((10, 3), jnp.float32),
            "tb": jnp.full((10, 2), 0.5, jnp.float32)}
    (xb, outb), (xs, outs) = _run_both(res, _opts(), x0, data)
    np.testing.assert_allclose(xb["a"], xs["a"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xb["b"], xs["b"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(xb["a"]), 1.0, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(outb.stop_reason),
                                  np.asarray(outs.stop_reason))


def test_save_history_parity():
    """Per-instance history of the batched solve == each instance's own."""
    data, x0 = make_prior_batch(16, 6, dtype=jnp.float32, seed=13)
    opts = _opts(save_history=True)
    (xb, outb), (xs, outs) = _run_both(prior_residual, opts, x0, data)
    assert outb.errs.shape == outs.errs.shape
    np.testing.assert_array_equal(np.asarray(outb.num_hist),
                                  np.asarray(outs.num_hist))
    for i in range(16):
        n = int(outs.num_hist[i])
        assert n >= 1
        np.testing.assert_allclose(np.asarray(outb.errs[i, :n]),
                                   np.asarray(outs.errs[i, :n]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(outb.deltas2[i, :n]),
                                   np.asarray(outs.deltas2[i, :n]),
                                   rtol=1e-4, atol=1e-8)
        np.testing.assert_array_equal(np.asarray(outb.successes[i, :n]),
                                      np.asarray(outs.successes[i, :n]))
    np.testing.assert_allclose(np.asarray(xb), np.asarray(xs),
                               rtol=1e-5, atol=1e-6)


def test_save_history_rejections_parity():
    """History parity through rejected steps (succ records is_good,
    early failures leave the slot untouched)."""
    key = jax.random.PRNGKey(1)
    x0 = jax.random.uniform(key, (12, 2), jnp.float32, 0.1, 0.45)
    opts = _opts(max_iters=20, max_consec_failures=5, save_history=True)
    (xb, outb), (xs, outs) = _run_both(jennrich_sampson_residuals, opts, x0)
    assert int(jnp.sum(outs.num_failures)) > 0       # meaningful test
    nh_b = np.asarray(outb.num_hist)
    nh_s = np.asarray(outs.num_hist)
    for i in range(12):
        # Parity holds until the first rejection: a rejected proposal's
        # evaluated cost depends on the last bits of dx, and
        # Jennrich-Sampson amplifies them.  Compare the pre-rejection
        # prefix, then check the batched history's own invariants.
        n = min(nh_b[i], nh_s[i])
        ss = np.asarray(outs.successes[i, :n])
        rej = np.nonzero(~ss)[0]
        n_cmp = min(n, rej[0] if len(rej) else n)
        if n_cmp:
            np.testing.assert_allclose(np.asarray(outb.errs[i, :n_cmp]),
                                       np.asarray(outs.errs[i, :n_cmp]),
                                       rtol=5e-3, atol=1e-5)
        eb = np.asarray(outb.errs[i, :nh_b[i]])
        db = np.asarray(outb.deltas2[i, :nh_b[i]])
        sb = np.asarray(outb.successes[i, :nh_b[i]])
        assert np.all(np.isfinite(eb)) and np.all(db >= 0)
        acc = eb[sb]
        if len(acc):
            # final cost is the last accepted error
            assert float(outb.final_cost.cost[i]) == pytest.approx(
                float(acc[-1]), rel=1e-6)


def test_se3_batched_parity():
    # Batched SE(3) pose-prior refinement: ambient parameters P=7
    # (quaternion+translation), tangent D=6, steps applied through the
    # group retraction.
    from tinyopt_tpu.manifolds import SE3, SO3

    B = 16
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    prior = SE3.exp(0.4 * jax.random.normal(k1, (B, 6), jnp.float32))
    prior_inv = prior.inverse()
    data = (prior_inv.rotation.wxyz, prior_inv.translation)
    x0 = SE3.exp(0.2 * jax.random.normal(k2, (B, 6), jnp.float32))

    def res(T, d):
        q_inv, t_inv = d
        return (SE3(SO3(q_inv), t_inv) @ T).log()

    (xb, outb), (xs, outs) = _run_both(res, _opts(), x0, data)
    np.testing.assert_allclose(np.asarray(xb.rotation.wxyz),
                               np.asarray(xs.rotation.wxyz),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(xb.translation),
                               np.asarray(xs.translation),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(outb.succeeded()),
                                  np.asarray(outs.succeeded()))
    # converged onto the prior
    final_err = jax.vmap(res)(xb, data)
    assert float(jnp.max(jnp.abs(final_err))) < 1e-3
    assert bool(jnp.all(outb.succeeded()))


def test_mixed_manifold_euclidean_parity():
    # {SE3 pose, Euclidean bias} pytree: interleaved manifold and array
    # leaves with ambient P ≠ tangent D.
    from tinyopt_tpu.manifolds import SE3

    B = 8
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    x0 = {"T": SE3.exp(0.1 * jax.random.normal(k1, (B, 6), jnp.float32)),
          "bias": jax.random.normal(k2, (B, 2), jnp.float32)}
    tgt = jax.random.normal(k3, (B, 2), jnp.float32)

    def res(x, d):
        return jnp.concatenate([x["T"].log(), 2.0 * (x["bias"] - d)])

    (xb, outb), (xs, outs) = _run_both(res, _opts(), x0, tgt)
    np.testing.assert_allclose(np.asarray(xb["bias"]),
                               np.asarray(xs["bias"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(xb["T"].translation),
                               np.asarray(xs["T"].translation),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(xb["bias"]), np.asarray(tgt),
                               atol=1e-3)
    assert bool(jnp.all(outb.succeeded()))
    np.testing.assert_array_equal(np.asarray(outb.stop_reason),
                                  np.asarray(outs.stop_reason))


def test_batched_under_shard_map():
    # batched_optimize with a mesh runs the vmapped solve under
    # shard_map, one slice of the batch per device.
    from tinyopt_tpu.parallel.mesh import make_mesh

    B = 64
    data, x0 = make_prior_batch(B, 6, dtype=jnp.float32, seed=7)
    opts = _opts()
    mesh = make_mesh(batch=len(jax.devices()))
    xs, outs = batched_optimize(x0, prior_residual, opts, data_batch=data,
                                mode="residuals", mesh=mesh)
    assert xs.shape == (B, 6)
    assert len(xs.sharding.device_set) == len(jax.devices())
    np.testing.assert_allclose(np.asarray(xs), np.asarray(data.y),
                               atol=1e-4)
    assert bool(jnp.all(outs.succeeded()))
    x1, out1 = _one_at_a_time(prior_residual, opts, x0, data)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(x1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(outs.stop_reason),
                                  np.asarray(out1.stop_reason))


# ---- seeded random residual programs ---------------------------------

def _random_program(rng, d, n_res):
    """A random smooth residual program r(x, data) -> (n_res,): a random
    linear mix, a random elementwise nonlinearity, and a random target,
    covering dense and sparse-ish Jacobian structures."""
    kind = rng.integers(0, 4)

    def residual(x, data):
        z = data["A"] @ x + data["shift"]
        if kind == 0:
            nl = jnp.tanh(z)
        elif kind == 1:
            nl = jnp.sin(z) + 0.1 * z * z
        elif kind == 2:
            nl = jnp.exp(-z * z) * z
        else:
            nl = z / jnp.sqrt(1.0 + z * z)
        return data["w"] * nl - data["y"]

    def make_data(batch):
        A = rng.normal(0, 1.0, (n_res, d)) * (
            rng.uniform(size=(n_res, d)) < 0.6)
        return {
            "A": jnp.broadcast_to(jnp.asarray(A, jnp.float32),
                                  (batch, n_res, d)),
            "w": jnp.broadcast_to(
                jnp.asarray(rng.uniform(0.5, 1.5, (n_res,)), jnp.float32),
                (batch, n_res)),
            "shift": jnp.broadcast_to(
                jnp.asarray(rng.uniform(-0.3, 0.3, (n_res,)), jnp.float32),
                (batch, n_res)),
            # filled by the caller so that a known x_true is an exact root
            "y": jnp.zeros((batch, n_res), jnp.float32),
        }

    return residual, make_data


def _assert_instance_parity(outb, outs, xb, xs):
    np.testing.assert_allclose(np.asarray(outb.final_cost.cost),
                               np.asarray(outs.final_cost.cost),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(outb.succeeded()),
                                  np.asarray(outs.succeeded()))
    # parameters agree wherever the instance converged to a unique point
    conv = np.asarray(outb.converged()) & np.asarray(outs.converged())
    np.testing.assert_allclose(np.asarray(xb)[conv], np.asarray(xs)[conv],
                               rtol=1e-3, atol=2e-3)


def _fuzz_opts():
    return _opts(max_iters=12, max_consec_failures=4,
                 hessian=dict(cg_iters=10))


@pytest.mark.parametrize("seed", range(8))
def test_random_program_parity(seed):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(2, 12))
    n_res = int(rng.integers(d, 24))
    batch = 16
    residual, make_data = _random_program(rng, d, n_res)

    data = make_data(batch)
    x_true = jnp.asarray(rng.uniform(-0.5, 0.5, (batch, d)), jnp.float32)
    y = jax.vmap(residual)(x_true, data)
    data = dict(data, y=data["y"] + y)       # x_true is an exact root
    x0 = x_true + jnp.asarray(rng.normal(0, 0.1, (batch, d)), jnp.float32)

    (xb, outb), (xs, outs) = _run_both(residual, _fuzz_opts(), x0, data)
    _assert_instance_parity(outb, outs, xb, xs)


@pytest.mark.parametrize("seed", range(4))
def test_random_se3_program_parity(seed):
    """SE(3) parameters with randomly composed point-based residuals."""
    from tinyopt_tpu.manifolds import SE3, SO3

    rng = np.random.default_rng(100 + seed)
    n_pts = int(rng.integers(4, 10))
    batch = 8
    kind = int(rng.integers(0, 3))
    w_scale = float(rng.uniform(0.05, 0.25))

    def residual(pose, data):
        p = pose.rotation.apply(data["pts"]) + pose.translation[None, :]
        if kind == 0:
            r = p - data["tgt"]
        elif kind == 1:
            r = jnp.tanh(p) - data["tgt"]
        else:
            r = p * data["w"] - data["tgt"]
        return r.reshape(-1)

    pts = jnp.asarray(rng.uniform(-1, 1, (batch, n_pts, 3)), jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 1.5, (batch, n_pts, 3)), jnp.float32)
    true_pose = SE3.exp(jnp.asarray(
        w_scale * rng.normal(size=(batch, 6)), jnp.float32))
    rot_b = SO3(true_pose.rotation.wxyz[:, None, :])
    moved = rot_b.apply(pts) + true_pose.translation[:, None, :]
    tgt = {0: moved, 1: jnp.tanh(moved), 2: moved * w}[kind]
    tgt = tgt + 1e-4 * jnp.asarray(rng.normal(size=tgt.shape), jnp.float32)
    data = {"pts": pts, "w": w, "tgt": tgt}
    x0 = SE3.exp(jnp.asarray(
        w_scale * rng.normal(size=(batch, 6)) * 0.3, jnp.float32))

    (xb, outb), (xs, outs) = _run_both(residual, _fuzz_opts(), x0, data)
    np.testing.assert_allclose(np.asarray(outb.final_cost.cost),
                               np.asarray(outs.final_cost.cost),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(outb.succeeded()),
                                  np.asarray(outs.succeeded()))
    np.testing.assert_allclose(np.asarray(xb.translation),
                               np.asarray(xs.translation),
                               rtol=1e-4, atol=1e-5)
