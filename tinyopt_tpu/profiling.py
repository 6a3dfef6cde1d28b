"""Per-iteration timing that works on callback-less backends.

The reference prints a per-iteration duration ``τ`` in its log line
(reference: include/tinyopt/optimizers/optimizer.h:462-516).  Our
``options.log.enable`` path reproduces that via host callbacks — on a
backend that rejects host callbacks the log (and its τ) silently degrades
(``Output.log_dropped`` flags it).

:func:`profile_iterations` recovers per-iteration timing WITHOUT
callbacks by driving the loop one iteration per dispatch through the
segment machinery (checkpoint.stepper): each ``step`` executes exactly
one loop iteration bit-identically to the fused ``lax.while_loop``
(tests/test_checkpoint.py's continuity contract), and the host clocks
each dispatch.

Timing rules:

* the timed pass runs from a slightly PERTURBED start (``perturb``,
  default 1e-6) after an untimed warm-up pass from the true start, so
  compilation stays out of every τ;
* each step forces a scalar read of the iteration's cost, so the device
  work is inside its τ.

Each τ therefore includes the per-dispatch overhead; the MARGINAL
per-iteration device time is best estimated as ``tau[1:].min()`` minus
the floor measured by :func:`dispatch_floor`.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import manifold as mf
from .options import Options
from .stop_reasons import StopReason


def dispatch_floor(reps: int = 5) -> float:
    """Seconds per trivial jitted dispatch — the fixed per-step cost a
    backend adds to every ``profile_iterations`` τ."""
    f = jax.jit(lambda a: a + 1.0)
    x = jnp.zeros(())
    float(f(x))                       # compile
    ts = []
    for i in range(reps):
        x = jnp.asarray(float(i))
        t0 = time.perf_counter()
        float(f(x))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def profile_iterations(x0, fn: Callable, options: Options | None = None,
                       *, mode: str = "auto", perturb: float = 1e-6,
                       seed: int = 0):
    """Solve while clocking every iteration. ``(x, Output, tau_s)``.

    ``tau_s`` is a float64 array of per-iteration wall seconds, length
    ``Output.num_iters``; ``tau_s[0]`` covers the first iteration (after
    an untimed warm-up pass that absorbs compilation).  The solve runs
    from ``x0`` retracted by a random tangent of size ``perturb`` (set
    ``perturb=0`` for the exact trajectory).
    """
    from .checkpoint import stepper

    options = options or Options()
    x0 = mf.as_pytree(x0)
    st = stepper(fn, options, x_example=x0, mode=mode)

    def drive(x_start, clock):
        taus = []
        x, out, state = None, None, None
        budget = options.max_iters + 1 \
            + (1 if options.check_final_cost else 0)
        for it in range(budget):
            t0 = time.perf_counter()
            if state is None:
                x, out, state = st.step(x_start)
            else:
                x, out, state = st.step(state=state)
            float(out.final_cost.cost)          # forced completion read
            if clock:
                taus.append(time.perf_counter() - t0)
            if int(out.stop_reason) not in (int(StopReason.NONE),
                                            int(StopReason.MAX_ITERS)):
                break
        return st.best_x(state), out, state, np.asarray(taus, np.float64)

    # Untimed warm-up from the true start: compiles the start/resume
    # executables.
    drive(x0, clock=False)

    if perturb:
        spec = mf.tangent_spec(x0)
        delta = perturb * jax.random.normal(
            jax.random.PRNGKey(seed), (spec.dims,), spec.dtype)
        x_start = mf.retract(x0, delta, spec)
    else:
        x_start = x0
    x, out, state, taus = drive(x_start, clock=True)

    import dataclasses
    total = int(out.num_iters) if len(taus) == 0 else len(taus)
    out = dataclasses.replace(
        out, num_iters=jnp.asarray(total, jnp.int32),
        duration_ms=jnp.asarray(taus.sum() * 1e3, jnp.float32))
    return x, out, taus
