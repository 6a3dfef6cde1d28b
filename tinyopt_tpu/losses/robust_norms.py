"""Robust norms / M-estimators (reference: include/tinyopt/losses/robust_norms.h).

All functions operate on the **squared** norm ``n2 = ‖r‖²`` against a
squared threshold ``th2``, and return ``(scaled_squared_loss, scale)``
where ``scale`` is the IRLS weight to apply to the residual's Jacobian —
the same contract as the reference (robust_norms.h:17-27), which makes
whitening-style ``r' = √w · r`` composition work under AD.

``*_loss`` variants take a residual vector and return the robustified
scalar loss directly (robust_norms.h:60-63 etc.).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def truncated(n2, th2):
    """Hard clip: loss = min(n2, th2), scale ∈ {0,1} (robust_norms.h:35-55)."""
    inlier = n2 <= th2
    return jnp.where(inlier, n2, th2), jnp.where(inlier, 1.0, 0.0)


def huber(n2, th2):
    """Huber: quadratic inside, linear outside (robust_norms.h:70-103)."""
    inlier = n2 <= th2
    th = jnp.sqrt(th2)
    n = jnp.sqrt(jnp.maximum(n2, 1e-30))
    loss = jnp.where(inlier, n2, 2.0 * th * n - th2)
    scale = jnp.where(inlier, 1.0, th / n)
    return loss, scale


def tukey(n2, th2):
    """Tukey biweight — DELIBERATELY renormalized ×⅓ vs the cited
    reference (robust_norms.h:122-152 uses loss th²(1−u³), scale 3u²):
    the ⅓ restores the loss≈n², scale≈1 inlier contract every other
    M-estimator here honors (pinned by test_losses.test_inlier_identity);
    the outlier plateau is therefore th²/3, not th²."""
    inlier = n2 <= th2
    u = 1.0 - n2 / th2
    loss = jnp.where(inlier, th2 / 3.0 * (1.0 - u * u * u), th2 / 3.0)
    scale = jnp.where(inlier, u * u, 0.0)
    return loss, scale


def arctan(n2, th2):
    """Arctan soft clamp: loss = th·atan(n²/th), th = √th²,
    scale = 1/(1 + n⁴/th²) (robust_norms.h:169-191)."""
    th = jnp.sqrt(th2)
    loss = th * jnp.arctan2(n2, th)
    scale = 1.0 / (1.0 + n2 * n2 / th2)
    return loss, scale


def cauchy(n2, th2):
    """Cauchy/Lorentzian: th² log(1 + n²/th²) (robust_norms.h:208-228)."""
    loss = th2 * jnp.log1p(n2 / th2)
    scale = 1.0 / (1.0 + n2 / th2)
    return loss, scale


def geman_mcclure(n2, th2):
    """Geman-McClure: loss = n²/(n²+th²) (plateau 1),
    scale = th²/(n²+th²)² (robust_norms.h:245-265)."""
    s = th2 + n2
    loss = n2 / s
    scale = th2 / (s * s)
    return loss, scale


def blake_zisserman(n2, th2):
    """Blake-Zisserman (robust_norms.h:282-303)."""
    eps = jnp.exp(-th2)
    loss = -jnp.log(jnp.exp(-n2) + eps)
    scale = jnp.exp(-n2) / (jnp.exp(-n2) + eps)
    return loss, scale


def _loss_of(fn):
    def loss_fn(r, th2):
        r = jnp.ravel(r)
        n2 = jnp.vdot(r, r)
        l, _ = fn(n2, th2)
        return l
    return loss_fn


truncated_loss = _loss_of(truncated)
huber_loss = _loss_of(huber)
tukey_loss = _loss_of(tukey)
arctan_loss = _loss_of(arctan)
cauchy_loss = _loss_of(cauchy)
geman_mcclure_loss = _loss_of(geman_mcclure)
blake_zisserman_loss = _loss_of(blake_zisserman)


def robust_whiten(r, robust_fn, th2):
    """Robust whitening: r' = √(ρ(n²)/n²) · r so that ‖r'‖² = ρ(n²) exactly.

    The JAX-idiomatic way to use robust norms inside a residual function:
    AD of r' carries the robustification into the Jacobian automatically,
    and the squared norm of the whitened residual IS the robust loss — so
    hard-rejecting norms (Truncated, Tukey) contribute their constant
    outlier plateau ρ(∞) to the cost instead of a spurious zero (which
    would make "reject everything" a global optimum).
    """
    r = jnp.ravel(r)
    n2 = jnp.vdot(r, r)
    loss, _ = robust_fn(n2, th2)
    tiny = jnp.finfo(n2.dtype).tiny
    # Double-where guards: neither branch of a where may produce NaN in
    # value or tangent, so the divisions/sqrts only ever see safe operands.
    pos = n2 > tiny
    ratio = jnp.maximum(loss, 0.0) / jnp.where(pos, n2, 1.0)
    rpos = ratio > 0
    w = jnp.where(pos,
                  jnp.where(rpos, jnp.sqrt(jnp.where(rpos, ratio, 1.0)), 0.0),
                  1.0)
    return w * r


def robust_cost(residuals, robust_fn, th2):
    """Robust total cost WITH inlier accounting — the reference's
    ``*Loss`` composers return a ``Cost`` whose ``inlier_ratio`` counts
    residual blocks under the threshold (robust_norms.h:60-63 composed
    with cost.h:22-37); this is that producer for manual-acc functions
    and for reporting.

    ``residuals``: (n, k) — n residual blocks of size k (or (n,) for
    scalar blocks).  Returns ``Cost(Σ ρ(‖rᵢ‖²), n, #inliers/n)`` where a
    block is an inlier when ``‖rᵢ‖² ≤ th2`` (the threshold comparison all
    the M-estimators here switch on).
    """
    from ..cost import Cost

    r = jnp.asarray(residuals)
    if r.ndim == 1:
        r = r[:, None]
    r = r.reshape(r.shape[0], -1)
    n2 = jnp.sum(r * r, axis=-1)
    loss, _ = jax.vmap(lambda v: robust_fn(v, th2))(n2)
    inl = jnp.mean((n2 <= th2).astype(jnp.float32))
    return Cost(cost=jnp.sum(loss),
                num_residuals=jnp.asarray(r.shape[0], jnp.int32),
                inlier_ratio=inl)


def gnc_schedule(th_coarse, th_fine, steps: int = 5):
    """Geometric threshold ladder for graduated non-convexity.

    Start near-quadratic (``th_coarse`` at/above the gross-error scale —
    the surrogate is convex-ish and pulls everything), finish at the
    inlier noise scale (``th_fine``, typically 3-5 σ).  Returns a tuple
    of ``steps`` thresholds.  Measured on outlier-contaminated BA
    (tests/test_schur.py TestRobustSchur): annealed Geman-McClure
    recovers the oracle geometry exactly, where a single fine-scale
    stage converges to the estimator's tail-biased optimum.
    """
    if steps < 2:
        return (float(th_fine),)
    import math
    ratio = (float(th_fine) / float(th_coarse)) ** (1.0 / (steps - 1))
    return tuple(float(th_coarse) * ratio ** i for i in range(steps))


# Per-factory threshold->fn maps.  Keyed on the factory BY IDENTITY via
# weakref so repeated anneal calls reuse the SAME whitened function
# objects — the entry points' solve caches key on the function object,
# so identity reuse is what makes the second anneal call compile
# nothing.
_GNC_FN_CACHE = None


def _gnc_fns(make_fn, th2s):
    global _GNC_FN_CACHE
    import weakref
    if _GNC_FN_CACHE is None:
        _GNC_FN_CACHE = weakref.WeakKeyDictionary()
    per = _GNC_FN_CACHE.setdefault(make_fn, {})
    for th2 in th2s:
        if th2 not in per:
            per[th2] = make_fn(th2)
    return per


# Whiten-factory memo: (residual_fn, robust_fn) -> factory, so the
# convenience path below hands _gnc_fns a STABLE factory object even
# though it is built here from a closure.
_GNC_FACTORY_CACHE = None


def _whiten_factory(residual_fn, robust_fn):
    global _GNC_FACTORY_CACHE
    if _GNC_FACTORY_CACHE is None:
        _GNC_FACTORY_CACHE = {}
    key = (residual_fn, robust_fn)
    fac = _GNC_FACTORY_CACHE.get(key)
    if fac is None:
        def fac(th2):
            def whitened(*args, **kwargs):
                return robust_whiten(residual_fn(*args, **kwargs),
                                     robust_fn, th2)
            return whitened
        if len(_GNC_FACTORY_CACHE) > 64:
            _GNC_FACTORY_CACHE.clear()
        _GNC_FACTORY_CACHE[key] = fac
    return fac


def gnc_anneal(solve_stage, x0, thresholds, *, residual_fn=None,
               robust_fn=None, make_fn=None):
    """Graduated non-convexity driver: re-solve at each threshold.

    Each stage warm-starts from the previous solution; returns the last
    ``(x, Output)``.  The stage loop is a HOST loop (each threshold is a
    different compiled program — th2 is a trace-time constant in the
    whitening), and THIS DRIVER owns the per-threshold residual
    construction so repeated anneals reuse the same function objects and
    hit the entry points' solve caches (which key on the function
    object).  Two ways to use it:

    * **Recommended** — pass the raw residual and the M-estimator; the
      driver builds (and memoizes, across calls) one whitened function
      per squared threshold and hands it to a 3-argument stage::

          def stage(x, th2, rp):
              return to.schur_sparse_optimize(x, rp, obs, cam_idx,
                                              mask, opts)
          x, out = gnc_anneal(stage, x0, gnc_schedule(50., 2.),
                              residual_fn=bal_residual,
                              robust_fn=geman_mcclure)

      Custom construction: pass ``make_fn(th2) -> fn`` instead (also
      memoized by factory identity).

    * **Legacy** — ``solve_stage(x, th2) -> (x, Output)`` with neither
      ``residual_fn`` nor ``make_fn``: the caller owns caching, and a
      fresh closure per stage call recompiles every stage on every
      anneal (measured 327 s vs ~21 s on the 300-camera robust BAL
      bench) — prefer the 3-argument form.

    ``thresholds`` are UNSQUARED scales (e.g. pixels); the driver
    squares them before whitening/solving.
    """
    if make_fn is None and residual_fn is not None:
        make_fn = _whiten_factory(
            residual_fn, geman_mcclure if robust_fn is None else robust_fn)
    x, out = x0, None
    if make_fn is not None:
        th2s = [float(th) ** 2 for th in thresholds]
        fns = _gnc_fns(make_fn, th2s)
        for th2 in th2s:
            x, out = solve_stage(x, th2, fns[th2])
        return x, out
    for th in thresholds:
        x, out = solve_stage(x, float(th) ** 2)
    return x, out
